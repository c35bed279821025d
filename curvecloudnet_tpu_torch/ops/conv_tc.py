"""A CPU model of the tensor-core design of K1 and K8 (``csrc/conv_tc.cuh``,
``csrc/conv1d_chain.cu``, ``csrc/conv1d_train.cu``), for the tests.

Nothing on the main path calls this module.  It repeats the kernels'
arithmetic step for step: every window product is a 3xTF32 product
(:func:`mm3`, operands split by ``group_reduce.tf32_split``) of the layer
input and the stacked taps [W_0 | ... | W_h], shifted and pair-summed on the
(h+1) C_out-wide side (:func:`shift_sum`); the backward multiplies the
windows of dz (:func:`windows`) instead.  Rows go by the tiles the wrappers
pick (``conv1d_chain.tile_rows``, ``conv1d_train.fwd_tile``, ``ROWS`` slots a
d_u_prev block, ``conv1d_train.dw_splits`` for the weight gradient), each
with its halo, zero outside [0, n_exp); the cross-block sums follow the
kernels' fixed orders (:func:`chan_combine`, :func:`colsum`,
:func:`prev_sums_model` for the reduce sums the t pass takes).  K1's
bfloat16 variant is modelled by :func:`chain_eval_model_bf16` on the taps
read back from :func:`pack_image_bf16`, the image its pack kernel writes;
K8-bf16's forward by :func:`fwd_model_bf16` (its plan's tiles, the pairs
rounded in bfloat16, its 16-row-group moments) on the taps read back from
:func:`pack_fwd_bf16`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv1d_chain import CHUNK_BF16, ROWS, plan_bf16, tile_rows
from .conv1d_train import (DW_FUSED, DW_STAGE, DW_STAGE_BF16, _affine,
                           _dleaky, _live, _u_of, dw_splits, fwd_tile,
                           plan_fwd_bf16)
from .group_reduce import tf32_split

MOMENT_THREADS = 256  # the moments kernel's block (CT_THREADS)


def mm3(a, b):
    """a @ b in 3xTF32: lo*hi + hi*lo + hi*hi, each TF32 product exact in
    f32, summed in f32."""
    ah, al = tf32_split(a.contiguous())
    bh, bl = tf32_split(b.contiguous())
    return al @ bh + ah @ bl + ah @ bh


def stacked_taps(w, h: int):
    """W ((h+1) C_in, C_out), tap d in row block d -> [W_0 | ... | W_h]
    (C_in, (h+1) C_out)."""
    c_out = w.shape[1]
    return w.reshape(h + 1, -1, c_out).permute(1, 0, 2).reshape(
        -1, (h + 1) * c_out)


def shift_sum(p, h: int, c_out: int):
    """P (..., R, (h+1) C_out) -> P_0(r) + sum_d (P_d(r-d) + P_d(r+d)) at
    rows r in [h, R - h): (..., R - 2h, C_out)."""
    r = p.shape[-2]
    z = p[..., h:r - h, :c_out]
    for d in range(1, h + 1):
        blk = p[..., d * c_out:(d + 1) * c_out]
        z = z + (blk[..., h - d:r - h - d, :] + blk[..., h + d:r - h + d, :])
    return z


def windows(x, h: int):
    """x (..., R, C) -> [x(r), x(r-1) + x(r+1), ..., x(r-h) + x(r+h)] at
    rows r in [h, R - h): (..., R - 2h, (h+1) C)."""
    r = x.shape[-2]
    return torch.cat([x[..., h:r - h, :]] + [
        x[..., h - d:r - h - d, :] + x[..., h + d:r - h + d, :]
        for d in range(1, h + 1)], dim=-1)


def rows_of(x, start: int, n: int):
    """Rows start .. start + n - 1 of x (B, n_exp, C), 0 outside
    [0, n_exp)."""
    out = x.new_zeros((x.shape[0], n, x.shape[2]))
    lo, hi = max(start, 0), min(start + n, x.shape[1])
    if hi > lo:
        out[:, lo - start:hi - start] = x[:, lo:hi]
    return out


def chain_eval_model(xe, weights, used, h: int):
    """K1: per block of ROWS slots (``tile_rows`` outputs and h L halo
    slots each side), each layer P = mm3(a, taps), y = shift_sum(P) + b,
    leaky, 0 past ``used``; the valid rows shrink by h each side."""
    bsz, n_exp, _ = xe.shape
    n_layers = len(weights)
    pad, tile = h * n_layers, tile_rows(h, n_layers)
    live_end = used.long().clamp(max=n_exp)[:, None]
    taps = [stacked_taps(w, h) for w, _ in weights]
    out = xe.new_zeros((bsz, n_exp, weights[-1][0].shape[1]))
    for t0 in range(0, n_exp, tile):
        a = rows_of(xe, t0 - pad, ROWS)
        for li, ((w, b), wst) in enumerate(zip(weights, taps)):
            y = shift_sum(mm3(a, wst), h, w.shape[1]) + b
            slot = t0 - pad + (li + 1) * h + torch.arange(y.shape[1])
            live = (slot[None] >= 0) & (slot[None] < live_end)
            a = torch.where(live[..., None], F.leaky_relu(y, 0.01),
                            torch.zeros_like(y))
        n = min(tile, n_exp - t0)
        out[:, t0:t0 + n] = a[:, :n]
    return out


def chan(a, b):
    """Chan's pairwise combination of (count, mean, M2), per channel, as
    the kernel's ``chan`` (a side with no count passes the other)."""
    n_a, m_a, q_a = a
    n_b, m_b, q_b = b
    n = n_a + n_b
    d = m_b - m_a
    f = n_b / torch.where(n > 0, n, torch.ones_like(n))
    out = (n, m_a + d * f, q_a + q_b + d * d * n_a * f)
    keep_a, keep_b = n_b == 0, (n_a == 0) & (n_b != 0)
    return tuple(torch.where(keep_a, x, torch.where(keep_b, y, o))
                 for x, y, o in zip(a, b, out))


def chan_combine(parts, c_out: int):
    """The moments kernel: per-block (count, mean, M2) rows combined in its
    fixed order (thread t takes rows t, t + 256, ...; then a tree) ->
    (mean, biased variance)."""
    zero = torch.zeros(c_out)
    slots = []
    for t in range(MOMENT_THREADS):
        acc = (zero, zero, zero)
        for cnt, mean, m2 in parts[t::MOMENT_THREADS]:
            acc = chan(acc, (torch.full((c_out,), float(cnt)), mean, m2))
        slots.append(acc)
    s = MOMENT_THREADS // 2
    while s:
        slots = [chan(slots[i], slots[i + s]) for i in range(s)]
        s //= 2
    n, mean, m2 = slots[0]
    var = torch.where(n > 0, torch.clamp(m2 / torch.where(n > 0, n, 1.0),
                                         min=0.0), zero)
    return mean, var


def tile_moments(zt, cnt: int, groups: int = 8):
    """A forward tile's (count, mean, M2) over its first ``cnt`` rows:
    ``groups`` groups of 16 rows (8 in the float32 forward, rows / 16 in
    the bfloat16 one), each in two passes, combined in order by
    :func:`chan`."""
    c_out = zt.shape[1]
    acc = (torch.zeros(c_out),) * 3
    for k in range(groups):
        g = zt[16 * k:min(16 * k + 16, cnt)]
        n = g.shape[0]
        mean = g.sum(0) / n if n else torch.zeros(c_out)
        acc = chan(acc, (torch.full((c_out,), float(n)), mean,
                         ((g - mean) ** 2).sum(0)))
    return acc


def fwd_model(z_prev, bn_prev, w, b, used, h: int):
    """K8's forward: per block of ROWS slots (``fwd_tile`` outputs and an
    h-slot halo each side) z = shift_sum(mm3(u, taps)) + b, the tile's
    (count, mean, M2) over its live slots (:func:`tile_moments`), combined
    by :func:`chan_combine`."""
    bsz, n_exp, _ = z_prev.shape
    c_out = w.shape[1]
    u = _u_of(z_prev, bn_prev, _live(used, n_exp, z_prev.device))
    tile, wst = fwd_tile(h), stacked_taps(w, h)
    z = z_prev.new_empty((bsz, n_exp, c_out))
    parts = []
    for bi in range(bsz):
        live_end = min(int(used[bi]), n_exp)
        for t0 in range(0, n_exp, tile):
            zt = shift_sum(mm3(rows_of(u[bi:bi + 1], t0 - h, ROWS), wst), h,
                           c_out)[0] + b
            n = min(tile, n_exp - t0)
            z[bi, t0:t0 + n] = zt[:n]
            cnt = max(0, min(t0 + tile, live_end) - t0)
            parts.append((cnt, *tile_moments(zt, cnt)[1:]))
    return (z, *chan_combine(parts, c_out))


def colsum(parts):
    """The colsum kernel's fixed order: row lane k (of 8) adds rows k,
    k + 8, ...; then the lanes 0..7 in turn."""
    lanes = []
    for k in range(8):
        s = torch.zeros(parts.shape[1])
        for row in parts[k::8]:
            s = s + row
        lanes.append(s)
    out = lanes[0]
    for s in lanes[1:]:
        out = out + s
    return out


def block_rows(x, tile: int, h: int):
    """x (B, n_exp, C) as the blocks of ROWS rows that own a tile of
    ``tile`` slots each (block row r is slot k tile - h + r): (B, tiles,
    ROWS, C), 0 outside the tile's rows h .. h + tile - 1 and [0, n_exp)."""
    n_tiles = -(-x.shape[1] // tile)
    keep = torch.zeros(ROWS, 1)
    keep[h:h + tile] = 1
    return torch.stack([rows_of(x, k * tile - h, ROWS) * keep
                        for k in range(n_tiles)], 1)


def prev_sums_model(d_u_prev, z_prev, bn_prev, used, tile: int = ROWS,
                    h: int = 0):
    """The t pass's epilogue for the previous layer's reduce sums: per
    block of ROWS rows (a tile of ``tile`` slots and an h-row halo, the
    bfloat16 t pass's; the float32 one's tile is ROWS, no halo), warp w
    (rows 16 w ..) and row lane g, a thread adds the terms of rows 16 w + g
    and 16 w + g + 8 (0 at dead slots and halo rows); the 8 lanes by a
    butterfly ((0+1) + (2+3)) + ((4+5) + (6+7)); the 8 warps in order; the
    tiles' rows by :func:`colsum` -> (dxh, dxh xhat, da, da xhat), each
    (C,).  Terms: da = d_u_prev leaky'(y), dxh = da gamma, each product
    rounded once."""
    bsz, n_exp, c = d_u_prev.shape
    live = _live(used, n_exp, d_u_prev.device)
    xhat, y = _affine(z_prev, bn_prev)
    da = d_u_prev * _dleaky(y) * live
    dxh = da * bn_prev[2]
    terms = torch.cat([dxh, dxh * xhat, da, da * xhat], dim=-1)
    blocks = block_rows(terms, tile, h)
    t = blocks.view(bsz, blocks.shape[1], 8, 2, 8, 4 * c)  # warp, half, g
    a = t[:, :, :, 0] + t[:, :, :, 1]
    a = a[..., 0::2, :] + a[..., 1::2, :]
    a = a[..., 0::2, :] + a[..., 1::2, :]
    a = a[..., 0, :] + a[..., 1, :]                # (B, tiles, warps, 4C)
    tile = torch.zeros_like(a[:, :, 0])
    for w in range(8):
        tile = tile + a[:, :, w]
    return tuple(colsum(tile.reshape(-1, 4 * c)).view(4, c).unbind(0))


def t_model(d_u, z, z_prev, bn, bn_prev, w, c1, c2, used, h: int):
    """K8's t pass: dz as the plain version forms it; d_u_prev per block of
    ROWS slots = mm3(windows(dz), W^T); dW and db per row split
    (``dw_splits``): for inputs up to DW_FUSED wide a ROWS-slot tile in one
    product u^T windows(dz), else the split's stages of DW_STAGE slots each
    in two 16-slot halves, summed half by half and the halves added; the
    splits' partial rows summed by :func:`colsum`; db by 8 row lanes (lane k
    takes rows k, k + 8, .. of every stage), added in order."""
    bsz, n_exp, c_out = z.shape
    c_in = z_prev.shape[-1]
    live = _live(used, n_exp, z.device)
    _, inv, gam, _ = bn
    xhat, y = _affine(z, bn)
    dz = inv * (d_u * live * _dleaky(y) * gam - live * (c1 + xhat * c2))
    w_t = w.reshape(h + 1, c_in, c_out).transpose(1, 2).reshape(-1, c_in)
    d_u_prev = z.new_empty((bsz, n_exp, c_in))
    for t0 in range(0, n_exp, ROWS):
        n = min(ROWS, n_exp - t0)
        win = windows(rows_of(dz, t0 - h, ROWS + 2 * h), h)
        d_u_prev[:, t0:t0 + n] = mm3(win, w_t)[:, :n]
    u = _u_of(z_prev, bn_prev, live)
    splits, rps = dw_splits(n_exp, c_in, bsz)
    fused = c_in <= DW_FUSED
    # the fused route takes a tile in one product; the dW kernel its
    # split's stages, each in two halves
    step, parts_of = (ROWS, 1) if fused else (DW_STAGE, 2)
    parts = []
    for bi in range(bsz):
        live_end = min(int(used[bi]), n_exp)
        for s in range(splits):
            lo = s * rps
            hi = min(lo + rps, n_exp) if fused else min(lo + rps, n_exp,
                                                        live_end + h)
            acc = [torch.zeros(c_in, (h + 1) * c_out)
                   for _ in range(parts_of)]
            lanes = [torch.zeros(c_out) for _ in range(8)]
            for p0 in range(lo, hi, step):
                us = rows_of(u[bi:bi + 1], p0, step)[0]
                win = windows(rows_of(dz[bi:bi + 1], p0 - h, step + 2 * h),
                              h)[0]
                size = step // parts_of
                for k in range(parts_of):
                    rows = slice(k * size, (k + 1) * size)
                    acc[k] = acc[k] + mm3(us[rows].t(), win[rows])
                for p, row in enumerate(win[:, :c_out]):
                    lanes[p % 8] = lanes[p % 8] + row
            db = lanes[0]
            for lane in lanes[1:]:
                db = db + lane
            dw = acc[0] if fused else acc[0] + acc[1]
            dw = dw.reshape(c_in, h + 1, c_out)
            parts.append(torch.cat([dw.transpose(0, 1).reshape(-1), db]))
    sums = colsum(torch.stack(parts))
    n_dw = (h + 1) * c_in * c_out
    return d_u_prev, sums[:n_dw].view(-1, c_out), sums[n_dw:]


def bf16_pairs(x, h: int):
    """[x(r), x(r-1) + x(r+1), ..., x(r-h) + x(r+h)] of x rounded to
    bfloat16, each pair summed and rounded in bfloat16, as float32, at rows
    r in [h, R - h): (..., R - 2h, (h+1) C)."""
    xb = x.to(torch.bfloat16)
    r = x.shape[-2]
    return torch.cat([xb[..., h:r - h, :]] + [
        xb[..., h - d:r - h - d, :] + xb[..., h + d:r - h + d, :]
        for d in range(1, h + 1)], dim=-1).float()


def t_model_bf16(d_u, z, z_prev, bn, bn_prev, w, c1, c2, used, h: int,
                 prev_sums: bool = False):
    """K8-bf16's t pass, its order of partial sums: dz as the plain version
    forms it, rounded to bfloat16 for both products; d_u_prev = the dz
    pairs times W^T (products exact in float32, as plain); dW and db per
    row split (``dw_splits(bf16=True)``): for inputs up to DW_FUSED wide a
    tile of ``fwd_tile(h)`` slots in one product of u's pairs and dz
    (:func:`bf16_pairs`), db by the block's row lanes (thread column c of
    pow2 C_out columns, lane k adding block rows k, k + 256 / pow2 .. of the
    tile), and with ``prev_sums`` the previous layer's reduce sums
    (:func:`prev_sums_model` on these tiles); for wider inputs every tap of
    a split's stages of DW_STAGE_BF16 slots added stage by stage, db's
    lanes running over the split's rows; the partial rows summed by
    :func:`colsum`."""
    bsz, n_exp, c_out = z.shape
    c_in = z_prev.shape[-1]
    live = _live(used, n_exp, z.device)
    _, inv, gam, _ = bn
    xhat, y = _affine(z, bn)
    dz = inv * (d_u * live * _dleaky(y) * gam - live * (c1 + xhat * c2))
    w_t = w.reshape(h + 1, c_in, c_out).transpose(1, 2).reshape(-1, c_in)
    wb = w_t.to(torch.bfloat16).float()
    d_u_prev = bf16_pairs(rows_of(dz, -h, n_exp + 2 * h), h) @ wb
    u = _u_of(z_prev.float(), bn_prev, live)
    splits, rps = dw_splits(n_exp, c_in, bsz, bf16=True, half_k=h)
    fused = c_in <= DW_FUSED
    step = rps if fused else DW_STAGE_BF16
    cpow = 32 if c_out <= 32 else 64 if c_out <= 64 else 128
    lanes = 256 // cpow
    parts = []
    for bi in range(bsz):
        live_end = min(int(used[bi]), n_exp)
        for s in range(splits):
            lo = s * rps
            hi = min(lo + rps, n_exp) if fused else min(lo + rps, n_exp,
                                                        live_end)
            acc = torch.zeros(c_in, (h + 1) * c_out)
            lane_sum = torch.zeros(lanes, c_out)
            for p0 in range(lo, hi, step):
                n = min(step, hi - p0)
                pairs = bf16_pairs(rows_of(u[bi:bi + 1], p0 - h, n + 2 * h),
                                   h)[0]
                dzs = rows_of(dz[bi:bi + 1], p0, n)[0]
                dzb = dzs.to(torch.bfloat16).float()
                acc = acc + torch.cat([pairs[:, d * c_in:(d + 1) * c_in].t()
                                       @ dzb for d in range(h + 1)], 1)
                # the tile's rows are block rows h.. (fused) or a stage's
                # rows 0.. (wide): lane k takes rows k, k + lanes, ..
                first = h if fused else 0
                for r in range(n):
                    k = (r + first) % lanes
                    lane_sum[k] = lane_sum[k] + dzs[r]
            db = lane_sum[0]
            for k in range(1, lanes):
                db = db + lane_sum[k]
            dw = acc.reshape(c_in, h + 1, c_out).transpose(0, 1).reshape(-1)
            parts.append(torch.cat([dw, db]))
    sums = colsum(torch.stack(parts))
    n_dw = (h + 1) * c_in * c_out
    out = (d_u_prev, sums[:n_dw].view(-1, c_out), sums[n_dw:])
    if prev_sums:
        return (*out, prev_sums_model(d_u_prev, z_prev, bn_prev, used,
                                      fwd_tile(h), h))
    return out


def _bf16_bits(x):
    """x rounded to bfloat16 (to nearest even), its 16 bits as int32."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def pack_image_bf16(weights, h: int):
    """(plan, image): the int32 words ``conv1d_chain_bf16_pack_kernel``
    writes for K1-bf16 (``ops/conv1d_chain.plan_bf16``'s layout): layer
    l's taps at toff[l], word (d kp + k/2) ldn + n = the bfloat16 bits of
    W[d C_in + k, n] (low half) and W[d C_in + k + 1, n] (high half), 0
    past C_in and C_out; then each layer's bias as float32 bits at
    boff[l], 0 past C_out."""
    dims = [weights[0][0].shape[0] // (h + 1)] + [w.shape[1]
                                                  for w, _ in weights]
    plan = plan_bf16(dims, h)
    img = torch.zeros(plan["total"], dtype=torch.int32)
    for l, (w, b) in enumerate(weights):
        cin, cout = dims[l], dims[l + 1]
        kp, ldn = -(-cin // 16) * 8, -(-cout // 8) * 8 + 8
        taps = torch.zeros(h + 1, 2 * kp, ldn, dtype=torch.int32)
        taps[:, :cin, :cout] = _bf16_bits(w.float().reshape(h + 1, cin,
                                                           cout))
        words = taps[:, 0::2] | (taps[:, 1::2] << 16)
        img[plan["toff"][l]:plan["toff"][l] + words.numel()] = words.reshape(-1)
        img[plan["boff"][l]:plan["boff"][l] + cout] = b.float().view(
            torch.int32)
    return plan, img


def image_layer_bf16(plan, img, l: int, h: int):
    """Layer l's (taps (h+1, C_in rounded to 16, C_out) as float32 values
    of its bfloat16 weights, bias) read back from the image as cb_taps and
    the epilogue read them."""
    cin, cout = plan["dims"][l], plan["dims"][l + 1]
    kp, ldn = -(-cin // 16) * 8, -(-cout // 8) * 8 + 8
    words = img[plan["toff"][l]:plan["toff"][l] + (h + 1) * kp * ldn]
    words = words.reshape(h + 1, kp, ldn)
    halves = torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF], 2)
    taps = (halves.reshape(h + 1, 2 * kp, ldn) << 16).view(torch.float32)
    bias = img[plan["boff"][l]:plan["boff"][l] + cout].view(torch.float32)
    return taps[..., :cout], bias


def chain_eval_model_bf16(xe, weights, used, h: int):
    """K1-bf16's schedule on the CPU: per tile of the plan's ``rows`` slots
    (rows - 2 h L outputs, h L halo slots each side, 0 outside [0, n_exp)),
    each layer's
    taps products from the packed image: the pairs a(r - d) + a(r + d)
    summed in float32 and rounded to bfloat16 (0 outside the tile), and
    their products added into the float32 sums in the kernel's order:
    layer 0 by input chunks of ``CHUNK_BF16`` columns, within a chunk
    tap by tap, within a tap 16 columns (one mma.sync step) at a time; a
    later layer tap by tap over its whole width.  Then the bias, leaky
    ReLU, the rows whose window lies in the previous layer's valid rows and
    the live slots, rounded to bfloat16."""
    bsz, n_exp, c0 = xe.shape
    n_layers = len(weights)
    plan, img = pack_image_bf16(weights, h)
    layers = [image_layer_bf16(plan, img, l, h) for l in range(n_layers)]
    rows_t = plan["rows"]
    pad, tile = h * n_layers, rows_t - 2 * h * n_layers
    live_end = used.long().clamp(max=n_exp)[:, None]
    out = torch.zeros((bsz, n_exp, weights[-1][0].shape[1]),
                      dtype=torch.bfloat16)
    zero = torch.zeros(bsz, h, 1)
    for t0 in range(0, n_exp, tile):
        a = rows_of(xe.float(), t0 - pad, rows_t)
        for li, (taps, bias) in enumerate(layers):
            cin16 = taps.shape[1]
            a = F.pad(a, (0, cin16 - a.shape[-1]))
            ext = torch.cat([zero.expand(-1, -1, cin16), a,
                             zero.expand(-1, -1, cin16)], 1)
            pairs = [a] + [(ext[:, h - d:h - d + rows_t]
                            + ext[:, h + d:h + d + rows_t]).to(
                                torch.bfloat16).float()
                           for d in range(1, h + 1)]
            acc = torch.zeros(bsz, rows_t, taps.shape[2])
            chunk = CHUNK_BF16 if li == 0 else cin16
            for k0 in range(0, cin16, chunk):
                for d in range(h + 1):
                    for k in range(k0, min(k0 + chunk, cin16), 16):
                        acc = acc + pairs[d][..., k:k + 16] @ taps[d, k:k + 16]
            y = F.leaky_relu(acc + bias, 0.01)
            rows = torch.arange(rows_t)
            slot = t0 - pad + rows
            keep = ((rows >= (li + 1) * h) & (rows < rows_t - (li + 1) * h)
                    )[None] & (slot[None] >= 0) & (slot[None] < live_end)
            a = torch.where(keep[..., None], y, torch.zeros_like(y)).to(
                torch.bfloat16).float()
        n = min(tile, n_exp - t0)
        out[:, t0:t0 + n] = a[:, pad:pad + n].to(torch.bfloat16)
    return out


def pack_fwd_bf16(w, b, h: int, plan):
    """The int32 words ``conv1d_train_pack_fwd_bf16_kernel`` writes for
    K8-bf16's forward (``conv1d_train.plan_fwd_bf16``'s layout): word
    (d kp + k/2) ldn + n = the bfloat16 bits of W[d C_in + k, n] (low
    half) and W[d C_in + k + 1, n] (high half), 0 past C_in and C_out;
    then the bias as float32 bits at bias_off, 0 past C_out."""
    cout = w.shape[1]
    cin = w.shape[0] // (h + 1)
    kp, ldn = plan["kp"], plan["ldn"]
    taps = torch.zeros(h + 1, 2 * kp, ldn, dtype=torch.int32)
    taps[:, :cin, :cout] = _bf16_bits(w.float().reshape(h + 1, cin, cout))
    img = torch.zeros(plan["img_words"], dtype=torch.int32)
    img[:plan["bias_off"]] = (taps[:, 0::2] | (taps[:, 1::2] << 16)).reshape(-1)
    img[plan["bias_off"]:plan["bias_off"] + cout] = b.float().view(
        torch.int32)
    return img


def fwd_model_bf16(z_prev, bn_prev, w, b, used, h: int):
    """K8-bf16's forward on the CPU, in its order: per tile of the plan's
    ``rows`` slots (rows - 2h outputs and an h-slot halo each side, 0
    outside [0, n_exp)) u rounded to bfloat16 once an element (xe as it
    is; a previous z through its BN, leaky ReLU and live mask), the pairs
    u(r - d) + u(r + d) summed and rounded in bfloat16 (0 outside the
    tile), their products with the taps read back from
    :func:`pack_fwd_bf16` added into float32 sums chunk by chunk of
    ``CHUNK_BF16`` columns, tap by tap within a chunk, 16 columns at a
    time; z = sums + b; each tile's (count, mean, M2) over rows / 16
    groups of 16 rows (:func:`tile_moments`), the tiles combined by
    :func:`chan_combine` -> (z, mean, var)."""
    bsz, n_exp, cin = z_prev.shape
    cout = w.shape[1]
    plan = plan_fwd_bf16(cin, cout, h, z_prev.dtype == torch.bfloat16)
    img = pack_fwd_bf16(w, b, h, plan)
    kp, ldn = plan["kp"], plan["ldn"]
    words = img[:plan["bias_off"]].reshape(h + 1, kp, ldn)
    halves = torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF], 2)
    taps = (halves.reshape(h + 1, 2 * kp, ldn) << 16).view(torch.float32)
    taps = taps[..., :cout]
    bias = img[plan["bias_off"]:plan["bias_off"] + cout].view(torch.float32)
    u = _u_of(z_prev.float(), bn_prev, _live(used, n_exp, z_prev.device))
    u = F.pad(u.to(torch.bfloat16).float(), (0, 2 * kp - cin))
    rows_t = plan["rows"]
    tile = rows_t - 2 * h
    zero = torch.zeros(bsz, h, 2 * kp)
    z = torch.empty((bsz, n_exp, cout))
    parts = []
    sums = []
    for t0 in range(0, n_exp, tile):
        a = rows_of(u, t0 - h, rows_t)
        ext = torch.cat([zero, a, zero], 1)
        pairs = [a] + [(ext[:, h - d:h - d + rows_t]
                        + ext[:, h + d:h + d + rows_t]).to(
                            torch.bfloat16).float()
                       for d in range(1, h + 1)]
        acc = torch.zeros(bsz, rows_t, cout)
        for k0 in range(0, 2 * kp, CHUNK_BF16):
            for d in range(h + 1):
                for k in range(k0, min(k0 + CHUNK_BF16, 2 * kp), 16):
                    acc = acc + pairs[d][..., k:k + 16] @ taps[d, k:k + 16]
        zt = acc[:, h:rows_t - h] + bias
        n = min(tile, n_exp - t0)
        z[:, t0:t0 + n] = zt[:, :n]
        sums.append((t0, zt))
    for bi in range(bsz):
        live_end = min(int(used[bi]), n_exp)
        for t0, zt in sums:
            cnt = max(0, min(t0 + tile, live_end) - t0)
            parts.append((cnt, *tile_moments(zt[bi], cnt, rows_t // 16)[1:]))
    return (z, *chan_combine(parts, cout))
