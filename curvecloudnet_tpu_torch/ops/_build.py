"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per source,
all started together) and links the objects into one shared library with a
plain C interface, ``build/libccn_kernels.so`` at the repository root,
loaded with ``ctypes``.  A hash of the sources and flags, stored beside
the library, triggers a rebuild whenever either changes.  Only a wrapper
that was handed a CUDA tensor calls :func:`library`, so importing the
package, or running it on CPU tensors, never builds anything.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build"
LIB_NAME = "libccn_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
# shared memory of a Hopper SM (228 KB), what the card reserves of it a
# block, and the dynamic shared memory one block may use (227 KB)
SM_SMEM = 233472
BLOCK_RESERVED = 1024
MAX_SMEM = SM_SMEM - BLOCK_RESERVED


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH and $CUDA_HOME/bin): the CUDA kernels of "
        "curvecloudnet_tpu_torch cannot be built on this machine")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels unless the stored hash matches; return the path."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out[-3000:]}")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append(f"link:\n{link.stdout[-3000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # name: argtypes (every function returns its cudaError_t as int)
    "ccn_conv1d_chain": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "ccn_group_reduce": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P] + [_I] * 9
                        + [_P, _P],
    "ccn_knn": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I] + [_P] * 7,
    "ccn_fps": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ccn_gather_km": [_P, _P, _P, _I, _I, _L, _I, _I, _P],
    "ccn_scatter_km": [_P, _P, _P, _I, _I, _L, _I, _I, _P],
    "ccn_gt_gemm": [_I, _P, _P, _I, _P],
    "ccn_gtw_gemm": [_P, _P, _P, _I, _P],
    "ccn_gt_rowstats": [_P, _P, _I, _I, _I, _P, _P],
    "ccn_gt_finalize": [_P, _I, _L, _L, _I, _P, _I, _F, _F] + [_P] * 6,
    "ccn_gt_aggregate": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "ccn_grid_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P],
    "ccn_topk_smallest": [_P, _P, _I, _I, _I, _P, _P, _P],
    "ccn_conv1d_train_fwd": [_P] * 12 + [_I] * 6 + [_P],
    "ccn_conv1d_train_reduce": [_P] * 6 + [_I] * 4 + [_P],
    "ccn_conv1d_train_t": [_P] * 19 + [_I] * 8 + [_P],
    "ccn_edge_mlp": [_P] * 7 + [_I] * 4 + [_P, _P],
    "ccn_edge_project": [_P] * 5 + [_I] * 3 + [_P, _P],
    "ccn_rasterize": [_P, _L, _P, _L, _F, _F, _F, _F, _I, _I] + [_P] * 5,
}
# the bfloat16 variants: K4 and K9 (both entries) take their float32
# twin's arguments, K1 and K2 their own plans
for _name in ("ccn_gather_km", "ccn_edge_mlp", "ccn_edge_project"):
    _SIGNATURES[_name + "_bf16"] = _SIGNATURES[_name]
_SIGNATURES["ccn_conv1d_train_fwd_bf16"] = [_P, _I] + [_P] * 12 + [_I] * 6 + [
    _P, _P]
_SIGNATURES["ccn_conv1d_train_t_bf16"] = [_P] * 3 + [_I] + [_P] * 17 + [
    _I] * 8 + [_P]
_SIGNATURES["ccn_gt_rowstats_bf16"] = _SIGNATURES["ccn_gt_rowstats"]
_SIGNATURES["ccn_scatter_km_bf16"] = [_P] * 4 + [_I, _I, _L, _I, _I, _P]
_SIGNATURES["ccn_conv1d_chain_bf16"] = [_P] * 6 + [_I] * 4 + [_P, _P]
_SIGNATURES["ccn_group_reduce_bf16"] = [_P] * 8 + [_I, _P, _P]


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def host_array(ctype, values):
    """A ctypes array of host values (kernel metadata)."""
    return (ctype * len(values))(*values)


def ptr(t, dtype, name: str, ndim: int | None = None) -> int:
    """Device pointer of a tensor the kernel takes as it is: a contiguous
    CUDA tensor of the given dtype (and rank).  Raises otherwise."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()
