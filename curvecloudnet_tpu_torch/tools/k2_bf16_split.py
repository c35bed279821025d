"""K2-bf16's device time split by phase at the nuScenes flagship's sites
(GPU).

A copy of a checkout's package (this one, or ``--tree DIR``'s) is made
under ``build/k2_split/`` with stop knobs in its K2-bf16 kernel source,
read from ``K2_STOP`` at each launch, built there and imported under
another name; each K2-bf16 call of a ``compute_dtype: bfloat16`` scan
(seed 0) is then timed (device ms, ``torch.profiler``, 5 runs) at each
knob.  The knobs stop the kernel after a phase, so each phase's time is
the difference of two readings:

* the kernel of ``csrc/group_wgmma.cuh`` (this design): 1 rows in (the
  listing warp's row lists and copies, the consumers' affine in place),
  2 + products (no aggregation), 0 the whole kernel;
* the chain kernel of ``csrc/group_chain.cuh`` (K2-bf16 before it had its
  own kernel): 1 compaction, 2 + row loads, 3 + dense layers (no
  aggregation), 0 the whole kernel.

Run from the repository root::

    python -m curvecloudnet_tpu_torch.tools.k2_bf16_split [--tree DIR]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import torch

from .. import predict as P
from ..ops import group_reduce as G
from .k2_bf16_compare import (REPO, bf16_config, device_ms, load_other,
                              recorded)

# (anchor, replacement) pairs a kernel source takes; each anchor occurs once
WGMMA_KNOBS = [
    ("// The consumers' first step of a chunk: its rows in place",
     "__device__ int gw_stop;\n"
     "// The consumers' first step of a chunk: its rows in place"),
    ("    const int nq = sl.hdr[1];\n    if (nq < 0) return;",
     "    const int nq = sl.hdr[1];\n    if (nq < 0) return;\n"
     "    if (gw_stop) {\n"
     "      gw_arrive_if(empty0 + 8 * slot, lane == 0);\n"
     "      continue;\n    }"),
    ("    } else if (tid == 8 * 32) {",
     "    } else if (tid == 8 * 32 && gw_stop != 1) {"),
    ("        ++fu;\n      }\n      int split = 0;",
     "        ++fu;\n      }\n"
     "      if (gw_stop == 1) {\n        gw_bar(2 + wg, 128);\n"
     "        gw_arrive_if(empty0 + 8 * slot, lane == 0);\n"
     "        continue;\n      }\n      int split = 0;"),
    ("          if (agg) {\n            // the aggregators take",
     "          if (agg && gw_stop == 2) {\n          } else if (agg) {\n"
     "            // the aggregators take"),
    ("  cudaError_t e = cudaErrorInvalidValue;\n#define GW_LAUNCH(NS)",
     "  {\n    const int st = getenv(\"K2_STOP\") ? atoi(getenv(\"K2_STOP\")) "
     ": 0;\n    cudaMemcpyToSymbol(gw_stop, &st, sizeof st);\n  }\n"
     "  cudaError_t e = cudaErrorInvalidValue;\n#define GW_LAUNCH(NS)"),
    ("#include <string.h>\n", "#include <string.h>\n#include <stdlib.h>\n"),
]
CHAIN_KNOBS = [
    ("  long long boff[2 * GR_MAX_LAYERS];  // in floats of the biases\n};",
     "  long long boff[2 * GR_MAX_LAYERS];  // in floats of the biases\n"
     "  int stop;\n};"),
    ("        out[((size_t)b * M + m0 + q * ms) * cout + i % cout] = -100.f;\n"
     "    }\n  __syncthreads();\n",
     "        out[((size_t)b * M + m0 + q * ms) * cout + i % cout] = -100.f;\n"
     "    }\n  __syncthreads();\n  if (g.stop == 1) return;\n"),
    ("      load_dst[j * ld_load + c1 + i - j * (c1v - c1)] = 0.f;\n    }\n"
     "    __syncthreads();\n",
     "      load_dst[j * ld_load + c1 + i - j * (c1v - c1)] = 0.f;\n    }\n"
     "    __syncthreads();\n"
     "    if (g.stop == 2) {\n      __syncthreads();\n      continue;\n    }\n"),
    ("    const int ld_msg = aggr == 1 ? ldm : ldx;\n",
     "    const int ld_msg = aggr == 1 ? ldm : ldx;\n"
     "    if (g.stop == 3) {\n      __syncthreads();\n      continue;\n    }\n"),
    ("  GroupMeta g;\n  g.n_local = n_local;",
     "  GroupMeta g;\n"
     "  g.stop = getenv(\"K2_STOP\") ? atoi(getenv(\"K2_STOP\")) : 0;\n"
     "  g.n_local = n_local;"),
    ("#include <type_traits>", "#include <type_traits>\n#include <stdlib.h>"),
]


def knobbed_copy(tree: str, name: str):
    """The package of ``tree`` copied under build/k2_split/<name> with the
    knobs in -> (its root, its K2-bf16 kernel's name, the knob values)."""
    root = os.path.join(REPO, "build", "k2_split", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "curvecloudnet_tpu_torch"),
                    os.path.join(root, "curvecloudnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(root, "curvecloudnet_tpu_torch", "csrc")
    wgmma = os.path.exists(os.path.join(csrc, "group_wgmma.cuh"))
    path = os.path.join(csrc, "group_wgmma.cuh" if wgmma
                        else "group_chain.cuh")
    with open(path) as f:
        src = f.read()
    for anchor, new in WGMMA_KNOBS if wgmma else CHAIN_KNOBS:
        if src.count(anchor) != 1:
            raise SystemExit(f"k2_bf16_split: {path} has changed: "
                             f"{anchor[:60]!r}")
        src = src.replace(anchor, new)
    with open(path, "w") as f:
        f.write(src)
    if wgmma:
        return root, "group_wgmma_kernel", (1, 2, 0)
    return root, "group_chain_kernel", (1, 2, 3, 0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO,
                    help="the checkout whose K2-bf16 is split")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_bf16_split: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    root, key, stops = knobbed_copy(args.tree, "this" if os.path.samefile(
        args.tree, REPO) else "other")
    og, _ = load_other(root)
    dev = torch.device("cuda")
    model = P.build_model(bf16_config("nuscenes"), 36864, dev)
    scan = P.synthetic_scan(0, 36864, dev)
    calls = recorded(G, "group_reduce_bf16", lambda: P.predict(model, *scan))
    totals = dict.fromkeys(stops, 0.0)
    for i, (a, kw) in enumerate(calls):
        row = {}
        with torch.inference_mode():
            for stop in stops:
                os.environ["K2_STOP"] = str(stop)
                row[stop] = device_ms(lambda: og.group_reduce_bf16(*a, **kw),
                                      key)
                totals[stop] += row[stop]
        os.environ["K2_STOP"] = "0"
        print(f"call {i} {tuple(a[0].shape)} {kw['aggr']} live "
              f"{int(a[1].sum())}: device ms by stop {row}", flush=True)
    print(f"total, {len(calls)} calls: device ms by stop "
          f"{ {k: round(v, 4) for k, v in totals.items()} }", flush=True)


if __name__ == "__main__":
    main()
