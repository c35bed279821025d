"""Curve-cloud construction from scanned surface points (simulator stage 3;
counterpart of ``curvecloudnet_tpu/simulator/curve_cloud.py``).

:func:`anti_alias` and :func:`estimate_curvature_and_grads` are PyTorch on
the device of their inputs (padded ``(B, N)`` rows, as the JAX package's);
:func:`split_curves_3d` and :func:`find_intersections` are NumPy copies,
run on the host.

  * 3D re-splitting at gaps (CURVE_SPLIT_THRESH = 0.01, reference
    curve_cloud.py:40-47)
  * the anti-aliasing filter along curves with mask-renormalized endpoints
    (reference curve_cloud.py:168-191) as a same-curve windowed sum
  * curvature and per-point feature gradients by weighted quadratic
    regression over geodesic neighborhoods with gaussian weights
    (reference curvature_approx.py:12-148), batched 3x3 normal-equation
    solves
  * curve-curve intersections by blocked point-distance tests (reference
    curve_cloud.py:114-165)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import curve1d, segments

CURVE_SPLIT_THRESH = 0.01
# The reference kernel (curve_cloud.py:10): 7 taps, cross-correlated, i.e.
# tap j applies at relative offset j-3.  Deliberately asymmetric in the
# reference; the normalizer is the mask filtered with the same kernel.
ANTI_ALIAS_KERNEL = (1.0, 2.0, 3.0, 3.0, 3.0, 2.0, 2.0)


def split_curves_3d(pos: np.ndarray, curve_id: np.ndarray,
                    thresh: float = CURVE_SPLIT_THRESH) -> np.ndarray:
    """Re-split scan-line curves at 3D gaps (depth discontinuities)."""
    edges = np.linalg.norm(np.diff(pos, axis=0), axis=1)
    splits = edges > thresh
    changes = curve_id[1:] != curve_id[:-1]
    cid = np.concatenate([[0], np.cumsum(splits | changes)])
    return cid.astype(np.int32)


def anti_alias(x: torch.Tensor, curve_id: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """[1,2,3,3,3,2,2] smoothing along curves, renormalized at endpoints.

    x: (B, N, C) padded rows.  Tap j of the kernel applies at relative
    offset j-3 (the reference's ``F.conv1d(curves, filter, padding='same')
    / F.conv1d(mask, filter)`` over curve-padded rows); taps that cross a
    curve boundary add zero to the value and to the normalizer."""
    half = len(ANTI_ALIAS_KERNEL) // 2
    num = torch.zeros_like(x)
    den = torch.zeros(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
    for j, w in enumerate(ANTI_ALIAS_KERNEL):
        d = j - half
        if d == 0:
            num = num + w * x
            den = den + w * valid[..., None].to(x.dtype)
            continue
        m = curve1d.same_curve_shift_mask(curve_id, valid, d)[..., None].to(
            x.dtype)
        num = num + w * curve1d.shift_fill(x, d) * m
        den = den + w * m
    return torch.where(valid[..., None], num / torch.clamp(den, min=1e-12),
                       torch.zeros_like(num))


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (B, N, ...) at idx (B, N, K) -> (B, N, K, ...)."""
    b, n, k = idx.shape
    return segments.take_rows(a, idx.reshape(b, n * k)).reshape(
        (b, n, k) + a.shape[2:])


def estimate_curvature_and_grads(pos: torch.Tensor,
                                 feat: Optional[torch.Tensor],
                                 curve_id: torch.Tensor, valid: torch.Tensor,
                                 k: int = 10, kernel_width: float = 2.5,
                                 hinge_reg: float = 1e-4):
    """Weighted quadratic regression along each curve.

    Fits x(t) ~ c0 + c1 t + c2 t^2 over the +-k/2 geodesic window of each
    point (t the geodesic offset over the mean edge length), gaussian
    weighted by |t| with bandwidth ``kernel_width``.  Returns
    (curvature_vec (B, N, 3), gradients (B, N, F, 3) or None)."""
    half = max(1, k // 2)
    offs = torch.as_tensor(curve1d.interleaved_offsets(half),
                           device=pos.device)
    n = pos.shape[1]
    iota = torch.arange(n, device=pos.device)
    cand = iota[None, :, None] + offs[None, None, :]
    in_range = (cand >= 0) & (cand < n)
    cand = cand.clamp(0, n - 1).expand(pos.shape[0], n, len(offs))
    cid = segments.padded_curve_id(curve_id, valid)
    mask = in_range & (cid[:, :, None] == _take(cid, cand)) & valid[:, :,
                                                                   None]

    geo = segments.geodesic_arclength(pos, curve_id, valid)
    t = _take(geo, cand) - geo[:, :, None]                # (B, N, K)
    p = _take(pos, cand) - pos[:, :, None, :]

    elens = segments.edge_lengths(pos, curve_id, valid)
    mean_edge = elens.sum() / torch.clamp((elens > 0).sum(), min=1)
    # the curve parameter over the mean edge length keeps the normal
    # equations O(1)-conditioned and the ridge term negligible (the
    # reference fits in raw arclength units, where the 1e-4 ridge dwarfs
    # sum(w t^4) ~ 1e-5); curvature is invariant to it, gradients get 1/h
    h = torch.clamp(mean_edge, min=1e-12)
    t = t / h
    w = torch.exp(-(t ** 2) / (kernel_width ** 2))
    w = torch.where(mask, w, torch.zeros_like(w))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-5)
    eye = hinge_reg * torch.eye(3, dtype=pos.dtype, device=pos.device)

    def wls(y):
        """Solve (A^T W A + aI) c = A^T W y for A = [1, t, t^2]."""
        A = torch.stack([torch.ones_like(t), t, t * t], dim=-1)
        Aw = A * w[..., None]
        ata = torch.einsum("bnki,bnkj->bnij", Aw, A) + eye
        aty = torch.einsum("bnki,bnkc->bnic", Aw, y)
        return torch.linalg.solve(ata, aty)              # (B, N, 3, C)

    coef = wls(p)
    vel = coef[:, :, 1, :]
    acc = 2.0 * coef[:, :, 2, :]
    vn = torch.linalg.norm(vel, dim=-1, keepdim=True)
    tang = vel / torch.clamp(vn, min=1e-12)
    acc_n = acc - tang * torch.sum(acc * tang, dim=-1, keepdim=True)
    nn_ = torch.linalg.norm(acc_n, dim=-1, keepdim=True)
    normal = acc_n / torch.clamp(nn_, min=1e-12)
    kappa = (torch.linalg.norm(torch.cross(vel, acc, dim=-1), dim=-1,
                               keepdim=True)
             / torch.clamp(vn ** 3, min=1e-12))
    curvature = torch.where(valid[..., None], normal * kappa,
                            torch.zeros_like(normal))

    gradients = None
    if feat is not None:
        fq = _take(feat, cand) - feat[:, :, None, :]
        fcoef = wls(fq)
        g1d = fcoef[:, :, 1, :] / h  # df/ds = df/dt' * dt'/ds  (B, N, F)
        gradients = g1d[..., None] * tang[:, :, None, :]  # (B, N, F, 3)
        gradients = torch.where(valid[..., None, None], gradients,
                                torch.zeros_like(gradients))
    return curvature, gradients


def find_intersections(pos: np.ndarray, curve_id: np.ndarray,
                       thresh: float = 0.005,
                       block: int = 2048) -> np.ndarray:
    """Pairs of points from different curves closer than ``thresh``.

    Blocked pairwise distances over the points, the reference's
    segment-distance signal (curve_cloud.py:114-165) without the full N^2
    matrix.  Returns (2, n_pairs) int array."""
    n = len(pos)
    out = []
    for i0 in range(0, n, block):
        a = pos[i0:i0 + block]
        ca = curve_id[i0:i0 + block]
        for j0 in range(i0, n, block):
            b = pos[j0:j0 + block]
            cb = curve_id[j0:j0 + block]
            d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
            diff_curve = ca[:, None] != cb[None, :]
            ii, jj = np.nonzero((d < thresh) & diff_curve)
            if len(ii):
                out.append(np.stack([ii + i0, jj + j0]))
    if not out:
        return np.zeros((2, 0), np.int64)
    pairs = np.concatenate(out, axis=1)
    return pairs[:, pairs[0] < pairs[1]]
