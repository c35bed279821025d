"""Scan-line generation over the image plane (simulator stage 2; a NumPy
copy of ``curvecloudnet_tpu/simulator/scanlines.py``, run on the host:
a sequential loop over lines with a global ``seen`` set, drawing from the
caller's ``np.random.Generator`` as the JAX package's does).

Parallel of the reference ``ScanLineGenerator``
(``scanning_simulator/utils/scanlines.py:4-150``): sample 2D lines across the
image border in ``random`` / ``parallel`` / ``grid`` patterns (the latter two
use binary-subdivision spacing so successive passes interleave), rasterize
each line at ``ts = sqrt(2)·res·density`` samples, deduplicate pixels, and
accumulate lines until exactly N on-surface points are collected.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

NLINES_PER_ROUND = 100
MAX_ROUNDS = 400


def _binary_subdivision_locations(round_idx: int, n: int) -> np.ndarray:
    """Deterministic low-discrepancy line offsets in [0, 1) (van der Corput
    ordering — the reference's binary-search spacing, scanlines.py:107-117)."""
    num_bins = int(np.ceil(np.log2(max((round_idx + 1) * n, 2))))
    n_full = 2 ** num_bins
    idxs = np.arange(round_idx * n_full, (round_idx + 1) * n_full) + 1
    bits = ((idxs[:, None] & (2 ** np.arange(num_bins))) != 0).astype(float)
    factors = 2.0 ** (-np.arange(1, num_bins + 1))
    locs = (bits * factors).sum(1)
    return locs[round_idx * n:(round_idx + 1) * n]


def sample_border_points(rng: np.random.Generator, pattern: str,
                         round_idx: int, n_lines: int,
                         res: int) -> np.ndarray:
    """(n_lines, 2, 2) line endpoints on the image border."""
    if pattern == "random":
        out = np.zeros((n_lines, 2, 2))
        basis = np.array([[1, 0], [0, 1]])
        corners = np.array([[0, 0], [0, 0], [0, res - 1], [res - 1, 0]])
        for i in range(n_lines):
            sides = rng.choice(4, size=2, replace=False)
            for j, s in enumerate(sides):
                off = rng.integers(0, res)
                out[i, j] = corners[s] + basis[s % 2] * off
        return out
    locs = _binary_subdivision_locations(round_idx, n_lines) * res
    if pattern == "parallel":
        return np.stack([
            np.stack([locs, np.zeros(n_lines)], -1),
            np.stack([locs, np.full(n_lines, res - 1.0)], -1),
        ], axis=1)
    if pattern == "grid":
        half = n_lines // 2
        l2 = locs[:half]
        horiz = np.stack([
            np.stack([l2, np.zeros(half)], -1),
            np.stack([l2, np.full(half, res - 1.0)], -1)], axis=1)
        vert = np.stack([
            np.stack([np.zeros(half), l2], -1),
            np.stack([np.full(half, res - 1.0), l2], -1)], axis=1)
        return np.concatenate([horiz, vert])
    raise ValueError(f"unknown pattern {pattern!r}")


def generate_scan_lines(rng: np.random.Generator, mask: np.ndarray,
                        n_points: int, pattern: str = "random",
                        density: float = 1.0
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Accumulate scan lines until n_points on-surface pixels are collected.

    Args:
      mask: (res, res) surface-coverage mask from the rasterizer.
      n_points: exact number of points to return.
    Returns (uv (N, 2) int pixel coords in scan order, curve_id (N,)) or None
    if the surface can't supply N unique pixels in MAX_ROUNDS.
    """
    res = mask.shape[0]
    ts = int(np.sqrt(2) * res * density)
    seen = np.zeros(mask.shape, bool)
    uv_out, cid_out = [], []
    count, curve = 0, 0
    for round_idx in range(MAX_ROUNDS):
        borders = sample_border_points(rng, pattern, round_idx,
                                       NLINES_PER_ROUND, res)
        t = (np.arange(ts) + rng.random()) / ts
        # (L, ts, 2) pixel samples along each line
        pix = (borders[:, None, 0] +
               (borders[:, None, 1] - borders[:, None, 0]) * t[None, :, None])
        pix = pix.astype(np.int64)
        np.clip(pix, 0, res - 1, out=pix)
        for li in range(len(pix)):
            line = pix[li]
            # dedup consecutive+global pixels, keep scan order
            on = mask[line[:, 0], line[:, 1]] & ~seen[line[:, 0], line[:, 1]]
            # also dedup within the line itself
            flat = line[:, 0] * res + line[:, 1]
            _, first_idx = np.unique(flat, return_index=True)
            keep = np.zeros(len(line), bool)
            keep[first_idx] = True
            on &= keep
            if not on.any():
                continue
            sel = line[on]
            if count + len(sel) > n_points:
                sel = sel[: n_points - count]
            seen[sel[:, 0], sel[:, 1]] = True
            uv_out.append(sel)
            cid_out.append(np.full(len(sel), curve, np.int32))
            curve += 1
            count += len(sel)
            if count >= n_points:
                return np.concatenate(uv_out), np.concatenate(cid_out)
    return None
