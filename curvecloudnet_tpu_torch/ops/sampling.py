"""Downsampling with static output budgets (counterpart of
``curvecloudnet_tpu/ops/sampling.py``).

Each sampler takes its uniform draws as an explicit tensor ``u``; ``None``
is the JAX package's deterministic ``key=None`` point (FPS starts at index
0, curve sampling has phase 0, voxel sampling has no jitter; random
sampling, which JAX draws from ``PRNGKey(0)`` there, draws from a
``torch.Generator`` seeded 0, ``docs/DEVIATIONS.md`` #14).  Fed the draws
``jax.random.uniform(key, ...)`` makes, a sampler picks what the JAX
sampler picks with that key.

Every sampler returns ``(idx, idx_valid)``: ``idx`` (B, M) int64 ascending
row indices, ``idx_valid`` (B, M) bool marking the filled budget slots.
Selections past the budget are dropped in scan order.

Scalars that feed a discrete decision (a bin, a voxel, a count) enter as
full f32 tensors: torch may turn a division by a Python scalar into a
multiplication by its reciprocal, which rounds differently.
"""

from __future__ import annotations

import torch

from . import fps as _k6
from . import segments, telemetry
from .segments import norm3


def mask_to_indices(mask: torch.Tensor, budget: int,
                    telemetry_name: str | None = "budget"):
    """(B, N) selection mask -> (B, budget) ascending indices + validity.
    Under a telemetry capture, records ``{telemetry_name}_overflow_frac``
    (the batch mean of the selected points' share past the budget) and
    ``{telemetry_name}_occupancy`` (the mean share of the budget filled);
    ``telemetry_name=None`` records nothing."""
    b, n = mask.shape
    rank = torch.cumsum(mask.long(), dim=-1) - 1
    iota = torch.arange(n, device=mask.device).expand(b, n)
    slot = torch.where(mask & (rank < budget), rank,
                       torch.full_like(rank, budget))
    out = torch.zeros((b, budget + 1), dtype=torch.int64, device=mask.device)
    out.scatter_(1, slot, iota)
    selected = mask.sum(dim=-1)
    count = torch.clamp(selected, max=budget)
    idx_valid = torch.arange(budget, device=mask.device)[None, :] < count[:, None]
    if telemetry.active() and telemetry_name is not None:
        sel = selected.float()
        cap = torch.full_like(sel, budget)
        telemetry.record(f"{telemetry_name}_overflow_frac", torch.mean(
            torch.clamp(sel - cap, min=0.0) / torch.clamp(sel, min=1.0)))
        telemetry.record(f"{telemetry_name}_occupancy",
                         torch.mean(torch.minimum(sel, cap) / cap))
    return out[:, :budget], idx_valid


def random_downsample(valid, ratio: float, budget: int, u=None):
    """A uniform random subset of ceil(n_valid * ratio) points a sample:
    the valid points of the smallest draws ``u`` (B, N), ties to the lower
    index.  ``u=None`` draws them from a CPU ``torch.Generator`` seeded 0
    (the JAX package's ``key=None`` draws from ``PRNGKey(0)``, which torch
    cannot reproduce)."""
    b, n = valid.shape
    if u is None:
        u = torch.rand((b, n), generator=torch.Generator().manual_seed(0))
        u = u.to(valid.device)
    scores = torch.where(valid, u.float(), torch.full_like(u.float(), 1e30))
    order = torch.argsort(scores, dim=-1, stable=True)
    rank_of = torch.empty_like(order)
    rank_of.scatter_(1, order, torch.arange(n, device=valid.device).expand(
        b, n))
    lengths = segments.lengths_from_valid(valid).float()
    keep = torch.ceil(lengths * torch.full_like(lengths, ratio)).long()
    return mask_to_indices(valid & (rank_of < keep[:, None]), budget)


def fps(pos, valid, ratio: float, budget: int, u=None):
    """Farthest point sampling, ceil(n_valid * ratio) picks per sample,
    returned in ascending index order.  Starts at index 0, or at
    ``u * n_valid`` (clipped) for draws ``u`` (B,).  The serial pick loop
    is kernel K6 (ops/fps.py)."""
    b, n, _ = pos.shape
    budget = min(budget, n)
    counts = segments.lengths_from_valid(valid)
    lengths = counts.float()
    k_per = torch.clamp(torch.ceil(lengths * torch.full_like(lengths, ratio)),
                        max=budget).long()
    if u is None:
        start = torch.zeros((b,), dtype=torch.int32, device=pos.device)
    else:
        start = (u.float() * torch.clamp(counts, min=1).float()).to(torch.int32)
        start = torch.minimum(start, torch.clamp(counts - 1, min=0).to(
            torch.int32))
    sel = _k6.fps_picks(pos, valid, start, budget).long()
    slot_valid = torch.arange(budget, device=pos.device)[None, :] < k_per[:, None]
    sort_key = torch.where(slot_valid, sel, torch.full_like(sel, n + 1))
    order = torch.argsort(sort_key, dim=-1, stable=True)
    sel = torch.gather(sel, 1, order)
    slot_valid = torch.gather(slot_valid, 1, order)
    return torch.where(slot_valid, sel, torch.zeros_like(sel)), slot_valid


def voxel_downsample(pos, valid, voxel_size: float, budget: int, u=None):
    """Keep, per occupied voxel, the point nearest the voxel corner, its
    distance jittered by ``u * voxel_size / 4`` for draws ``u`` (B, N).

    The JAX package sorts rows by the uint32 keys (key_a, key_b, dist) with
    the row index as a stable tie-break; here three stable sorts run from
    the last key to the first.  Keys are held in int64, so the invalid
    sentinel 0xFFFFFFFF stays the largest key.
    """
    b, n, _ = pos.shape
    scaled = pos / torch.full_like(pos, voxel_size)
    vox = torch.floor(scaled).to(torch.int64)
    vu = vox & 0xFFFF
    key_a = (vu[..., 0] << 16) | vu[..., 1]
    key_b = ((vox[..., 2] & 0xFFFFFFFF) << 1) & 0xFFFFFFFF
    dist = norm3(vox.to(torch.float32) - scaled)
    if u is not None:
        dist = dist + u * torch.full_like(u, voxel_size / 4)
    sentinel = torch.full_like(key_a, 0xFFFFFFFF)
    key_a = torch.where(valid, key_a, sentinel)
    key_b = torch.where(valid, key_b, sentinel)

    order = torch.arange(n, device=pos.device).expand(b, n)
    for key in (dist, key_b, key_a):
        perm = torch.argsort(torch.gather(key, 1, order), dim=-1, stable=True)
        order = torch.gather(order, 1, perm)
    sa = torch.gather(key_a, 1, order)
    sb = torch.gather(key_b, 1, order)
    firsts = torch.ones_like(valid)
    firsts[:, 1:] = (sa[:, 1:] != sa[:, :-1]) | (sb[:, 1:] != sb[:, :-1])
    winners = firsts & torch.gather(valid, 1, order)
    mask = torch.zeros_like(valid)
    mask.scatter_(1, order, winners)
    return mask_to_indices(mask, budget)


def curve_fps(pos, curve_id, valid, arclen_spacing: float, budget: int,
              u=None):
    """Arclength-uniform sampling along each curve: every curve start is
    kept, then one point per ``arclen_spacing`` of geodesic length, each
    curve's bins shifted by the phase ``(start * 117 * u) mod spacing`` for
    a scalar draw ``u``."""
    g = segments.geodesic_arclength(pos, curve_id, valid)
    if u is not None:
        start = segments.curve_start_index(curve_id, valid).float()
        spacing = torch.full_like(start, arclen_spacing)
        g = g + torch.fmod(start * 117.0 * u, spacing)
    bins = torch.round(g / torch.full_like(g, arclen_spacing))
    new_bin = bins != torch.roll(bins, 1, dims=-1)
    new_bin[:, 0] = True
    starts = segments.curve_starts(curve_id, valid)
    return mask_to_indices((new_bin | starts) & valid, budget)
