"""Mesh rasterization: a pinhole z-buffer -> per-pixel coords, normals and
mask (counterpart of ``curvecloudnet_tpu/simulator/rasterizer.py``).

:func:`rasterize` runs kernel K11 (``csrc/rasterize.cu``) on the card and
:func:`rasterize_plain`, its plain PyTorch version, on the CPU.  Both give
what the JAX package's native C++ z-buffer
(``curvecloudnet_tpu/simulator/native/rasterizer.cpp``) gives, bit for bit:
its operations in its order, each rounded once, and its winner of a pixel,
the least ``z`` in float order and then the least face index.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import DEFAULT_DEVICE
from ..ops import _build
from ..ops.segments import sq_norm3, sqrt32

# K11's scratch (csrc/rasterize.cu): a face-table row of 22 floats
# (``Face``), a clamped box of 4 ints a face, a chunk box a CHUNK_FACES
# faces, each part 16-byte aligned (:func:`table_bytes`); the tile pass's
# screen tiles are TILE x TILE pixels
FACE_BYTES = 22 * 4
BOX_BYTES = 16
CHUNK_FACES = 32
TILE = 64
# (face, pixel) candidates the plain version holds at once; the key's
# minimum is associative, so chunks of faces reduce to the same winner
CHUNK = 1 << 24
_EMPTY = torch.iinfo(torch.int64).max
_INT_MIN = -(2 ** 31)


@dataclasses.dataclass
class Pinhole:
    """Pinhole intrinsics (the reference's mpr.Pinhole2D)."""

    fx: float
    fy: float
    cx: float
    cy: float
    h: int
    w: int


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the C interface passes it."""
    return float(np.float32(x))


def _x86_int(v: torch.Tensor) -> torch.Tensor:
    """``(int)`` of floor / ceil results as x86-64 converts them: NaN and
    values past the int32 range become INT_MIN (int64 out)."""
    ok = (v >= -2147483648.0) & (v < 2147483648.0)
    out = torch.where(ok, v, torch.zeros_like(v)).long()
    return torch.where(ok, out, torch.full_like(out, _INT_MIN))


def _proj(f: float, u, z, c: float):
    return (f * u) / z + c


def _face_table(v: torch.Tensor, f: torch.Tensor, pin: Pinhole):
    """(dict of per-face tensors, kept (F,) bool): the C++ loop's per-face
    work, every face at once."""
    n = v.shape[0]
    idx = f.long()
    keep = ((idx >= 0) & (idx < n)).all(1)
    tri = v[idx.clamp(0, max(n - 1, 0))] if n else torch.zeros(
        (len(f), 3, 3), dtype=v.dtype, device=v.device)
    A, B, C = tri[:, 0], tri[:, 1], tri[:, 2]
    eps_z = _f32(1e-6)
    keep &= ~((A[:, 2] <= eps_z) | (B[:, 2] <= eps_z) | (C[:, 2] <= eps_z))
    e1, e2 = B - A, C - A
    nrm = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                       e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                       e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], -1)
    nl = sqrt32(sq_norm3(nrm))
    keep &= ~(nl < _f32(1e-12))
    nrm = nrm / nl[:, None]
    nrm = torch.where((nrm[:, 2] > 0)[:, None], -nrm, nrm)
    fx, fy, cx, cy = (_f32(p) for p in (pin.fx, pin.fy, pin.cx, pin.cy))
    t = dict(A=A, B=B, C=C, n=nrm)
    for name, V in (("a", A), ("b", B), ("c", C)):
        t[name + "x"] = _proj(fx, V[:, 0], V[:, 2], cx)
        t[name + "y"] = _proj(fy, V[:, 1], V[:, 2], cy)
    x0 = _x86_int(torch.floor(torch.fmin(t["ax"], torch.fmin(t["bx"],
                                                              t["cx"]))))
    x1 = _x86_int(torch.ceil(torch.fmax(t["ax"], torch.fmax(t["bx"],
                                                             t["cx"]))))
    y0 = _x86_int(torch.floor(torch.fmin(t["ay"], torch.fmin(t["by"],
                                                              t["cy"]))))
    y1 = _x86_int(torch.ceil(torch.fmax(t["ay"], torch.fmax(t["by"],
                                                             t["cy"]))))
    t["x0"], t["y0"] = x0.clamp(min=0), y0.clamp(min=0)
    t["x1"] = torch.where(x1 >= pin.w, torch.full_like(x1, pin.w - 1), x1)
    t["y1"] = torch.where(y1 >= pin.h, torch.full_like(y1, pin.h - 1), y1)
    keep &= (t["x0"] <= t["x1"]) & (t["y0"] <= t["y1"])
    det = ((t["by"] - t["cy"]) * (t["ax"] - t["cx"])
           + (t["cx"] - t["bx"]) * (t["ay"] - t["cy"]))
    keep &= ~(torch.abs(det) < _f32(1e-12))
    one = torch.ones_like(det)
    t["inv_det"] = one / det
    t["iza"], t["izb"], t["izc"] = one / A[:, 2], one / B[:, 2], one / C[:, 2]
    return t, keep


def _bary_depth(t, fi, x, y):
    """(l0, l1, l2, z) of pixels (x, y) in faces ``fi``, in the C++
    operation order."""
    g = {k: t[k][fi] for k in ("ax", "ay", "bx", "by", "cx", "cy",
                               "inv_det", "iza", "izb", "izc")}
    px, py = x.float() + 0.5, y.float() + 0.5
    dx, dy = px - g["cx"], py - g["cy"]
    l0 = ((g["by"] - g["cy"]) * dx + (g["cx"] - g["bx"]) * dy) * g["inv_det"]
    l1 = ((g["cy"] - g["ay"]) * dx + (g["ax"] - g["cx"]) * dy) * g["inv_det"]
    l2 = (1.0 - l0) - l1
    iz = (l0 * g["iza"] + l1 * g["izb"]) + l2 * g["izc"]
    return l0, l1, l2, torch.ones_like(iz) / iz, g


def _keys_of(z: torch.Tensor, face: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (z in float order, face index); -0 as +0."""
    z = torch.where(z == 0, torch.zeros_like(z), z)
    bits = z.view(torch.int32)
    s = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    return s * (1 << 32) + face


def rasterize_plain(vertices, faces, pinhole: Pinhole, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11's plain PyTorch version: (coords (h, w, 3) f32, normals (h, w, 3)
    f32, mask (h, w) bool) on ``device`` (default: the vertices' device,
    the CPU for numpy input).  The (face, bounding-box pixel) candidates
    are enumerated with ``repeat_interleave`` in chunks of at most
    ``CHUNK`` and reduced with ``scatter_reduce_(..., "amin")`` on the
    (z, face) key; the winners are recomputed from the face table."""
    if device is None:
        device = vertices.device if torch.is_tensor(vertices) else "cpu"
    v = torch.as_tensor(vertices, dtype=torch.float32).to(device)
    f = torch.as_tensor(faces).to(device=device, dtype=torch.int32)
    h, w = pinhole.h, pinhole.w
    keys = torch.full((h * w,), _EMPTY, dtype=torch.int64, device=device)
    t, keep = _face_table(v, f.reshape(-1, 3), pinhole)
    kept = keep.nonzero()[:, 0]
    bw = (t["x1"] - t["x0"] + 1)[kept]
    counts = bw * (t["y1"] - t["y0"] + 1)[kept]
    ends = torch.cumsum(counts, 0).tolist()
    a = 0
    while a < len(ends):
        base = ends[a - 1] if a else 0
        b = a + 1
        while b < len(ends) and ends[b] - base <= CHUNK:
            b += 1
        cnt = counts[a:b]
        local = torch.repeat_interleave(
            torch.arange(b - a, device=device), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        off = torch.arange(int(ends[b - 1] - base), device=device) - start[
            local]
        fi = kept[a:b][local]
        x = t["x0"][fi] + off % bw[a:b][local]
        y = t["y0"][fi] + off // bw[a:b][local]
        l0, l1, l2, z, _ = _bary_depth(t, fi, x, y)
        m = _f32(-1e-6)
        hit = (~((l0 < m) | (l1 < m) | (l2 < m))
               & (z < float("inf"))).nonzero()[:, 0]
        keys.scatter_reduce_(0, (y * w + x)[hit], _keys_of(z[hit], fi[hit]),
                             reduce="amin", include_self=True)
        a = b
    return resolve_keys(t, keys, h, w)


def resolve_keys(t, keys: torch.Tensor, h: int, w: int):
    """(coords, normals, mask) of an (h w,) int64 key image over
    :func:`_face_table`'s faces: each keyed pixel's winner recomputed in
    the C++ operation order; 0 and False where no face wrote."""
    mask = keys != _EMPTY
    pix = mask.nonzero()[:, 0]
    fi = keys[pix] & 0xFFFFFFFF
    l0, l1, l2, z, g = _bary_depth(t, fi, pix % w, pix // w)
    w0, w1, w2 = ((l * g[k]) * z for l, k in ((l0, "iza"), (l1, "izb"),
                                               (l2, "izc")))
    coords = torch.zeros((h * w, 3), dtype=torch.float32, device=keys.device)
    normals = torch.zeros_like(coords)
    coords[pix] = ((w0[:, None] * t["A"][fi] + w1[:, None] * t["B"][fi])
                   + w2[:, None] * t["C"][fi])
    normals[pix] = t["n"][fi]
    return (coords.reshape(h, w, 3), normals.reshape(h, w, 3),
            mask.reshape(h, w))


def table_bytes(n_faces: int) -> int:
    """Bytes of K11's scratch for ``n_faces`` faces
    (``ccn_rasterize_table_bytes``): the face table, the boxes and the
    chunk boxes."""
    return (-(-n_faces * FACE_BYTES // 16) * 16 + BOX_BYTES * n_faces
            + BOX_BYTES * -(-n_faces // CHUNK_FACES))


def face_boxes(t, keep) -> torch.Tensor:
    """(F, 4) int64 clamped boxes (x0, x1, y0, y1) of :func:`_face_table`'s
    faces, as K11's face pass stores them: a skipped face's box meets no
    tile (x0 = y0 = INT_MAX, x1 = y1 = INT_MIN)."""
    box = torch.stack([t["x0"], t["x1"], t["y0"], t["y1"]], -1)
    none = torch.tensor([2 ** 31 - 1, _INT_MIN, 2 ** 31 - 1, _INT_MIN],
                        device=box.device)
    return torch.where(keep[:, None], box, none)


def _meets(box, tx0: int, tx1: int, ty0: int, ty1: int) -> torch.Tensor:
    return ((box[:, 0] <= tx1) & (box[:, 1] >= tx0) & (box[:, 2] <= ty1)
            & (box[:, 3] >= ty0))


def tile_lists(boxes: torch.Tensor, pinhole: Pinhole):
    """The faces each of K11's screen tiles lists, from the clamped boxes
    (:func:`face_boxes`): {(tile x, tile y): face indices, ascending}.  The
    tile pass culls in two levels, as here: a chunk of CHUNK_FACES
    consecutive faces by the union of their boxes, then each face of a
    chunk that meets the tile by its own box.  Tiles are TILE x TILE
    pixels from the origin, the last row and column cut at the image."""
    n = len(boxes)
    pad = -n % CHUNK_FACES
    none = torch.tensor([2 ** 31 - 1, _INT_MIN, 2 ** 31 - 1, _INT_MIN],
                        device=boxes.device)
    per = torch.cat([boxes, none.expand(pad, 4)]).view(-1, CHUNK_FACES, 4)
    chunk = torch.stack([per[..., 0].amin(1), per[..., 1].amax(1),
                         per[..., 2].amin(1), per[..., 3].amax(1)], -1)
    lists = {}
    for ty in range(-(-pinhole.h // TILE)):
        for tx in range(-(-pinhole.w // TILE)):
            tx0, ty0 = tx * TILE, ty * TILE
            tx1 = min(tx0 + TILE, pinhole.w) - 1
            ty1 = min(ty0 + TILE, pinhole.h) - 1
            hit = _meets(chunk, tx0, tx1, ty0, ty1).nonzero()[:, 0]
            f = (hit[:, None] * CHUNK_FACES
                 + torch.arange(CHUNK_FACES, device=boxes.device)).reshape(-1)
            f = f[f < n]
            lists[tx, ty] = f[_meets(boxes[f], tx0, tx1, ty0, ty1)]
    return lists


def checked_device(device=None) -> torch.device:
    """``device`` (default ``cuda``) as a ``torch.device``; a CUDA device
    must be present."""
    device = torch.device(device or DEFAULT_DEVICE)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return device


def rasterize(vertices, faces, pinhole: Pinhole, device=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rasterize a camera-space mesh -> (coords (h, w, 3), normals
    (h, w, 3), mask (h, w) bool) as tensors on ``device`` (default
    ``cuda``): kernel K11 on the card, :func:`rasterize_plain` on the
    CPU.  ``vertices`` (V, 3) and ``faces`` (F, 3) are arrays or tensors."""
    device = checked_device(device)
    v = torch.as_tensor(vertices, dtype=torch.float32).to(device)
    f = torch.as_tensor(faces).to(device=device, dtype=torch.int32)
    if v.device.type == "cpu":
        return rasterize_plain(v, f, pinhole)
    v, f = v.reshape(-1, 3).contiguous(), f.reshape(-1, 3).contiguous()
    h, w = pinhole.h, pinhole.w
    table = torch.empty(table_bytes(len(f)), dtype=torch.uint8,
                        device=device)
    coords = torch.empty((h, w, 3), dtype=torch.float32, device=device)
    normals = torch.empty_like(coords)
    mask = torch.empty((h, w), dtype=torch.bool, device=device)
    rc = _build.library().ccn_rasterize(
        _build.ptr(v, torch.float32, "vertices", 2), len(v),
        _build.ptr(f, torch.int32, "faces", 2), len(f),
        *(_f32(p) for p in (pinhole.fx, pinhole.fy, pinhole.cx, pinhole.cy)),
        h, w, table.data_ptr(), coords.data_ptr(),
        normals.data_ptr(), mask.data_ptr(), _build.stream_ptr(device))
    _build.check(rc, "ccn_rasterize")
    rasterize.launches += 1
    return coords, normals, mask


rasterize.launches = 0


def look_at_camera(mesh_vertices: np.ndarray, distance: float = 2.5,
                   elev_deg: float = 20.0, azim_deg: float = 30.0,
                   return_transform: bool = False):
    """World-space vertices in a camera frame looking at the origin (NumPy,
    on the host).  With ``return_transform`` also ``(rot, eye)``, such that
    ``cam = (v - eye) @ rot.T`` and ``v = cam @ rot + eye``: consumers that
    map scan points back to the object frame (part-label transfer against
    an object-space label cloud) invert with these."""
    el, az = np.deg2rad(elev_deg), np.deg2rad(azim_deg)
    eye = distance * np.array([
        np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    rot = np.stack([right, up2, fwd])  # world -> camera (z forward)
    cam = (mesh_vertices - eye) @ rot.T
    if return_transform:
        return cam, rot, eye
    return cam
