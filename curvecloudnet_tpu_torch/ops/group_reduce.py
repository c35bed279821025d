"""K2: grouped message MLP + masked max / softmax-attend over K.

Counterpart of ``curvecloudnet_tpu/ops/pallas_group.py``
(``fused_group_reduce`` in its k-major form, ``fold_mlp_eval``,
``fold_full_mlp_eval``).  The CUDA kernel is ``csrc/group_reduce.cu``;
:func:`group_reduce_ref` is its plain PyTorch version, the materialized
composition the JAX package runs on CPU.  The wrapper runs the plain
version for CPU tensors and the kernel for CUDA tensors; the kernel runs
its dense layers in 3xTF32 on the tensor cores (each operand split as
:func:`tf32_split` does) over the live (query, plane) rows only.

h1 (B, K, M, C1) holds the layer-0 pre-norm messages, plane-major; mask
(B, M, K) is query-major with its columns in h1's plane order.

The operands' dtype follows h1, as in the Pallas kernel: with a bfloat16
h1 (a model computing in bfloat16) every dense layer's input and weight
are rounded to bfloat16 and their products summed in float32, values stay
float32 between layers and the output is float32.
:func:`group_reduce_bf16` launches that variant, its own kernel
(``csrc/group_wgmma.cuh``: wgmma on bfloat16 activations kept in shared
memory, weights streamed by bulk copies); :func:`plan_bf16` lays out its
launch and :func:`pack_bf16` its weight stages.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .aggregate import masked_attend, masked_max

_ACT_CODES = {"relu": 0, "leaky_relu": 1, "identity": 2}


def _act(x, kind: str):
    if kind == "relu":
        return torch.clamp(x, min=0.0)
    if kind == "leaky_relu":
        return torch.where(x > 0, x, 0.01 * x)
    if kind == "identity":
        return x
    raise ValueError(kind)


def _dense(lin, bn=None):
    """(W (C_in, C_out), b) of a Linear, with an eval BN folded in."""
    w = lin.weight.t()
    b = lin.bias if lin.bias is not None else torch.zeros_like(w[0])
    if bn is not None:
        s, t = bn.affine()
        w, b = w * s[None, :], b * s + t
    return w, b


def fold_mlp_eval(mlp):
    """An eval MLP whose layer 0 runs outside the kernel -> (layer-0 BN
    affine (s, t), ((W, b) for layers 1..L-1)), hidden BNs folded.  A
    single-layer MLP folds to the identity affine and no layers."""
    n = len(mlp.lins)
    if n == 1:
        c = mlp.lins[0].out_features
        w = mlp.lins[0].weight
        return (torch.ones(c, device=w.device), torch.zeros(c, device=w.device)), ()
    layers = tuple(_dense(mlp.lins[i], mlp.norms[i] if i < mlp.n_norms else None)
                   for i in range(1, n))
    return mlp.norms[0].affine(), layers


def fold_full_mlp_eval(mlp):
    """A whole eval MLP (layer 0 included) -> ((W, b), ...), BNs folded."""
    return tuple(_dense(lin, mlp.norms[i] if i < mlp.n_norms else None)
                 for i, lin in enumerate(mlp.lins))


def round_to(t, dtype):
    """t rounded to ``dtype`` (bfloat16), widened back to float32 (exact);
    float32 passes as it is."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def _chain(h, layers, act: str, cdt=torch.float32):
    """The dense layers, each input and weight rounded to the operand dtype
    ``cdt`` and multiplied in float32 (the kernels' rounding: a bfloat16 x
    bfloat16 product is exact in float32)."""
    for i, (w, b) in enumerate(layers):
        h = round_to(h, cdt) @ round_to(w, cdt) + b
        if i < len(layers) - 1:
            h = _act(h, act)
    return h


def group_reduce_ref(h1, mask, affine0, local, attend=None, aggr="max",
                     act="relu", attend_act="leaky_relu"):
    """Returns (B, M, C_out) f32; the products' operands in h1's dtype."""
    s0, t0 = affine0
    cdt = h1.dtype
    msg = _chain(_act(h1.float() * s0 + t0, act), local, act,
                 cdt)                                        # (B, K, M, C)
    if aggr == "max":
        return masked_max(msg.transpose(1, 2), mask)
    logits = _chain(msg, attend, attend_act, cdt)
    return masked_attend(msg.transpose(1, 2), logits.transpose(1, 2), mask)


def tf32_round(x):
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as the card's ``cvt.rna.tf32.f32`` rounds: the f32 bits with
    half of the 13 dropped bits' unit added and those bits cleared.
    Infinities and NaNs pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x):
    """x -> (hi, lo), both TF32 values, hi = rna(x), lo = rna(x - hi): the
    split the kernel applies to each operand of its 3xTF32 products
    (lo*hi + hi*lo + hi*hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


# rows a chunk, widest first; weight rows a stage, most first; queries a
# block at most (curvecloudnet_tpu_torch/tools/k2_sweep.py sweeps rows and
# the query cap)
_ROWS = (64, 32, 16)
_STAGE_ROWS = (32, 16, 8)
_MAX_TQ = 64
# accumulators of a block (256 threads x 128): rows x the widest layer
_ACC = 32768


def _round(c: int, to: int) -> int:
    return -(-c // to) * to


def _smem_bytes(rows: int, tq: int, kc: int, k: int, dims, c_out: int,
                attend: bool) -> int:
    """Shared memory of a launch (``smem_bytes`` in the kernel source):
    two weight stages, the activations (and the messages under attend),
    the carried aggregation state and the row list."""
    ldx = _round(max(dims), 32) + 4
    ldw = _round(max(dims[1:], default=8), 32) + 8
    floats = (rows * ldx +
              (rows * (_round(c_out, 32) + 4) if attend else 0) +
              2 * (3 if attend else 1) * c_out)
    return 4 * 2 * kc * ldw + 4 * floats + 4 * (3 * tq + 1) + 2 * tq * k


def _launch_shape(dims, c_out: int, attend: bool, k: int, queries: int,
                  sms: int):
    """(rows a chunk, queries a block, weight rows a stage): the widest
    chunk whose accumulators fit the registers and whose buffers fit the
    block's shared memory, with the deepest weight stage that still fits;
    at most _MAX_TQ queries a block, as many as fill whole waves of one
    block an SM (the buffers leave room for one)."""
    waves = -(-queries // (sms * _MAX_TQ))
    tq = -(-queries // (sms * waves))
    for rows in _ROWS:
        if _round(max(dims[1:], default=8), 8) * rows > _ACC:
            continue
        for kc in _STAGE_ROWS:
            if _smem_bytes(rows, tq, kc, k, dims, c_out,
                           attend) <= _build.MAX_SMEM:
                return rows, tq, kc
    raise ValueError(f"group kernel: width {max(dims)} too wide for shared "
                     "memory")


def pack_layers(layers, device):
    """((W, b), ...) -> (one f32 tensor, W offsets, bias offsets) as the
    chain kernel (``csrc/group_chain.cuh``) takes them: every layer's W
    row-major from a 16-byte boundary, then the biases."""
    parts = [torch.nn.functional.pad(w.detach().float().reshape(-1),
                                     (0, -w.numel() % 4)) for w, _ in layers]
    parts += [bias.detach().float().reshape(-1) for _, bias in layers]
    offsets = [0]
    for t in parts:
        offsets.append(offsets[-1] + t.numel())
    wp = torch.cat(parts) if layers else torch.zeros(1, device=device)
    return wp, offsets[:len(layers)], offsets[len(layers):-1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def group_reduce(h1, mask, affine0, local, attend=None, aggr="max",
                 act="relu", attend_act="leaky_relu"):
    """Kernel K2 for CUDA tensors (:func:`group_reduce_bf16` for a bfloat16
    h1), its plain version for CPU tensors."""
    if h1.device.type == "cpu":
        return group_reduce_ref(h1, mask, affine0, local, attend, aggr, act,
                                attend_act)
    if h1.dtype == torch.bfloat16:
        return group_reduce_bf16(h1, mask, affine0, local, attend, aggr=aggr,
                                 act=act, attend_act=attend_act)
    return _launch(h1, mask, affine0, local, attend, aggr, act, attend_act)


def group_reduce_bf16(h1, mask, affine0, local, attend=None, aggr="max",
                      act="relu", attend_act="leaky_relu"):
    """Kernel K2's bfloat16 variant (h1 bfloat16; ``csrc/group_wgmma.cuh``),
    CUDA tensors only; float32 output."""
    h1_ptr = _build.ptr(h1, torch.bfloat16, "h1", 4)
    b, k, m, c1 = h1.shape
    local = tuple(local)
    attend = tuple(attend or ()) if aggr == "attend" else ()
    dims = tuple(_dims_of(c1, local, attend, aggr))
    s0, t0 = (a.float().contiguous() for a in affine0)
    s0_ptr = _build.ptr(s0, torch.float32, "s0", 1)
    t0_ptr = _build.ptr(t0, torch.float32, "t0", 1)
    ints, n_ints, n_scratch = _launch_plan(
        dims, len(local), aggr == "attend", k, b, m, _sm_count(h1.device),
        _ACT_CODES[act], _ACT_CODES[attend_act],
        c1 % 8 == 0 and (h1_ptr | s0_ptr | t0_ptr) % 16 == 0)
    img, bias = pack_bf16(local + attend, h1.device)
    scratch = torch.empty(max(1, n_scratch), dtype=torch.float32,
                          device=h1.device)
    out = torch.empty((b, m, dims[len(local)]), dtype=torch.float32,
                      device=h1.device)
    rc = _build.library().ccn_group_reduce_bf16(
        h1_ptr, _build.ptr(mask, torch.bool, "mask", 3), s0_ptr, t0_ptr,
        _build.ptr(img, torch.bfloat16, "weights"),
        _build.ptr(bias, torch.float32, "biases"), scratch.data_ptr(), ints,
        n_ints, out.data_ptr(), _build.stream_ptr(h1.device))
    _build.check(rc, "ccn_group_reduce_bf16")
    group_reduce_bf16.launches += 1
    return out


def _dims_of(c1: int, local, attend, aggr: str):
    """[C1, each layer's output width] of K2's chain; raises on shapes the
    kernel does not take."""
    if aggr not in ("max", "attend"):
        raise ValueError(f"group kernel aggregates max or attend, not {aggr}")
    dims = [c1]
    for w, bias in tuple(local) + tuple(attend):
        if w.shape[0] != dims[-1] or bias.shape != (w.shape[1],):
            raise ValueError(f"group kernel: bad layer shapes {tuple(w.shape)}")
        dims.append(w.shape[1])
    if attend and dims[-1] != dims[len(local)]:
        raise ValueError("group kernel: attention MLP must end at C_out")
    return dims


def _launch(h1, mask, affine0, local, attend, aggr, act, attend_act):
    """Launch K2 (float32 h1)."""
    b, k, m, c1 = h1.shape
    attend = tuple(attend or ()) if aggr == "attend" else ()
    layers = tuple(local) + attend
    dims = _dims_of(c1, local, attend, aggr)
    c_out = dims[len(local)]
    wp, woff, boff = pack_layers(layers, h1.device)
    s0 = affine0[0].float().contiguous()
    t0 = affine0[1].float().contiguous()
    rows, tq, kc = _launch_shape(dims, c_out, aggr == "attend", k, b * m,
                                 _sm_count(h1.device))
    out = torch.empty((b, m, c_out), dtype=torch.float32, device=h1.device)
    args = (
        _build.ptr(h1, torch.float32, "h1", 4),
        _build.ptr(mask, torch.bool, "mask", 3),
        _build.ptr(s0, torch.float32, "s0", 1),
        _build.ptr(t0, torch.float32, "t0", 1),
        _build.ptr(wp, torch.float32, "weights"),
        len(local), len(attend),
        _build.host_array(ctypes.c_int, dims),
        _build.host_array(ctypes.c_longlong, woff or [0]),
        _build.host_array(ctypes.c_longlong, boff or [0]),
        int(aggr == "attend"), _ACT_CODES[act], _ACT_CODES[attend_act],
        b, k, m, rows, tq, kc, out.data_ptr(), _build.stream_ptr(h1.device))
    rc = _build.library().ccn_group_reduce(*args)
    _build.check(rc, "ccn_group_reduce")
    group_reduce.launches += 1
    return out


# K2-bf16 (csrc/group_wgmma.cuh): rows a chunk (one wgmma M tile); bytes of
# an activation tile (64 rows x 64 bfloat16 columns); output columns of a
# pass and of one wgmma; the widest layer; dense layers and weight ring
# slots at most; bytes of a ring slot, of a chunk slot's row list and
# query table, of the row ballots; the kernel's GwMeta fields in order
GW_ROWS = 64
GW_TILE = 8192
GW_PASS = 512
GW_SUB = 32
GW_MAX_WIDTH = 1024
GW_MAXL = 16
GW_MAXST = 16
GW_STAGE = 16384
GW_META = 784
GW_QBITS = 512
GW_FIELDS = ("n_local", "n_attend", "aggr", "act", "attend_act", "B", "K",
             "M", "c1", "cout", "nslot", "nst", "resident", "sb", "x_bytes",
             "s_off", "w_off", "meta_off", "bar_off", "q_off", "eq_off",
             "msg_ld", "msg_floats", "per_block", "vec", "grid", "smem", "ns",
             "agg_split", "nstg")
GW_ARRAYS = (("dims", GW_MAXL + 1), ("npad", GW_MAXL), ("boff", GW_MAXL))


def _ns(dims) -> int:
    """Subtiles of 32 columns a warpgroup takes in a pass of the chain
    ``dims``: enough for its widest layer up to ``GW_PASS`` (two warpgroups,
    one pass), so a pass is 64 ns columns; narrower layers are computed on
    zero-padded columns."""
    return max(1, max(-(-min(_round(c, GW_SUB), GW_PASS) // 64)
                      for c in dims[1:]))


def _stored_cols(dims, ns=None):
    """Each layer's stored columns: its width rounded to whole passes (of
    64 ``ns`` columns; the chain's own ns by default)."""
    return [_round(c, 64 * (ns or _ns(dims))) for c in dims[1:]]


def _passes(npad: int, dims, ns=None):
    """(first column, width) of each pass over a layer of ``npad`` stored
    columns."""
    pw = 64 * (ns or _ns(dims))
    return [(p, pw) for p in range(0, npad, pw)]


def stage_table(dims):
    """The weight stages of one chunk in streaming order: (layer, first
    column of the pass, pass width, first slab, slabs, byte offset, bytes);
    a slab is 16 k of the pass's columns (width x 32 bytes), a stage as many
    whole slabs as ``GW_STAGE`` bytes hold (at least one)."""
    table, off = [], 0
    for layer, npad in enumerate(_stored_cols(dims)):
        nslab = -(-dims[layer] // 16)
        for p0, pw in _passes(npad, dims):
            per = max(1, GW_STAGE // (pw * 32))
            for s0 in range(0, nslab, per):
                n = min(per, nslab - s0)
                table.append((layer, p0, pw, s0, n, off, n * pw * 32))
                off += n * pw * 32
    return table


def plan_bf16(dims, n_local: int, attend: bool, k: int, b: int, m: int,
              sms: int, act: int = 0, attend_act: int = 1, vec: bool = True):
    """K2-bf16's launch for the chain ``dims`` ([C1, each dense layer's
    width], the local layers first) -> {GwMeta field: value}.

    A chunk slot's activation tiles hold the widest stored activation;
    the spill tiles take the earlier passes of a layer over 512 columns
    and, unless the aggregating layer's input leaves the slot's head free,
    the aggregation's staging (a tile a buffer, two under attend, one or
    two buffers a consumer warpgroup); the weight ring holds the whole
    image where it fits (resident: loaded once a block, then as many chunk
    slots as fit, up to four, so the listing runs ahead), else the deepest
    ring of at least two stages beside two slots, or one.  Raises where no
    layout fits a block's shared memory."""
    nl = len(dims) - 1
    if max(dims) > GW_MAX_WIDTH or nl > GW_MAXL or not 1 <= k <= 128:
        raise ValueError(f"group kernel (bfloat16): chain {list(dims)} over "
                         f"{k} planes is past its limits")
    npad = _stored_cols(dims)
    tiles = lambda c: -(-c // 64)  # noqa: E731
    tx = max([tiles(_round(dims[0], 16))] + [tiles(n) for n in npad[:-1]])
    # the spill tiles: a layer's earlier passes over 512 columns
    ts, split, spills = 0, 0, False
    for n in npad[:-1]:           # the stored layers: every one but the last
        spill = _ns(dims) * (len(_passes(n, dims)) - 1)
        spills |= bool(spill)
        if spill and not split:
            ts, split = max(ts, spill), spill
        elif spill and spill > split:
            raise ValueError(f"group kernel (bfloat16): chain {list(dims)} "
                             "spills past its free tiles")
        else:
            split = 0
    n_stages = len(stage_table(dims))
    grid = min(sms, b * m)
    # a bit a query of a block's walk: its K planes equal (attend)
    nqb = -(-b * m // grid)
    eq_bytes = _round(4 * -(-nqb // 32), 16)

    def smem(nslot, nst, nstg):
        # the aggregation's staging: a tile a buffer (two under attend: the
        # logits and their messages), two warpgroups; in the spill unless
        # the aggregating layer's input leaves the slot's head free
        stg = 2 * nstg * (2 if attend else 1)
        return (1024 + nslot * tx * GW_TILE
                + (ts if split else max(ts, stg)) * GW_TILE
                + nst * GW_STAGE + nslot * GW_META + GW_QBITS + eq_bytes
                + 8 * (2 * nslot + 2 * nst + 8))

    # a chunk's spill passes would overwrite the spill tiles where the
    # previous chunk's aggregation may still read its staging: one slot
    spilled = spills and not split
    combos = lambda slots: [  # noqa: E731
        (n, s) for n in ((1,) if spilled else slots) for s in (2, 1)
        if not (split and 2 * s * (2 if attend else 1) > split)]
    # the whole image resident where any layout holds it (then as many
    # chunk slots as fit, up to four: the listing runs ahead), else the
    # deepest ring (up to 12 stages) of the first layout that holds two
    layout = next(((n, n_stages, 1, s) for n, s in combos((4, 3, 2, 1))
                   if n_stages <= GW_MAXST
                   and smem(n, n_stages, s) <= _build.MAX_SMEM), None)
    for nslot, nstg in combos((2, 1)) if layout is None and n_stages > 1 \
            else ():
        fits = [n for n in range(2, min(12, n_stages) + 1)
                if smem(nslot, n, nstg) <= _build.MAX_SMEM]
        if fits:
            layout = nslot, fits[-1], 0, nstg
            break
    if layout is None:
        raise ValueError(f"group kernel (bfloat16): chain {list(dims)} does "
                         "not fit a block's shared memory")
    nslot, nst, resident, nstg = layout
    msg_ld = _round(dims[n_local], 64 * _ns(dims))
    msg_floats = nslot * GW_ROWS * msg_ld if attend or n_local == 0 else 0
    s_off = nslot * tx * GW_TILE
    w_off = s_off + (ts if split else max(
        ts, 2 * nstg * (2 if attend else 1))) * GW_TILE
    meta_off = w_off + nst * GW_STAGE
    q_off = meta_off + nslot * GW_META
    eq_off = q_off + GW_QBITS
    bar_off = eq_off + eq_bytes
    boff = [sum(npad[:i]) for i in range(nl)]
    return dict(
        n_local=n_local, n_attend=nl - n_local, aggr=int(attend), act=act,
        attend_act=attend_act, B=b, K=k, M=m, c1=dims[0], cout=dims[n_local],
        nslot=nslot, nst=nst, resident=resident, sb=GW_STAGE,
        x_bytes=tx * GW_TILE, s_off=s_off, w_off=w_off, meta_off=meta_off,
        bar_off=bar_off, q_off=q_off, eq_off=eq_off, msg_ld=msg_ld,
        msg_floats=msg_floats, per_block=msg_floats + 6 * msg_ld,
        vec=int(vec), grid=grid, ns=_ns(dims), agg_split=split, nstg=nstg,
        smem=smem(nslot, nst, nstg), dims=list(dims), npad=npad, boff=boff)


def plan_ints(plan):
    """The plan as the kernel's GwMeta ints, in order."""
    ints = [int(plan[f]) for f in GW_FIELDS]
    for name, n in GW_ARRAYS:
        ints += [int(v) for v in plan[name]] + [0] * (n - len(plan[name]))
    return ints


@functools.lru_cache(maxsize=256)
def _launch_plan(dims, n_local, attend, k, b, m, sms, act, attend_act, vec):
    """A call shape's plan as the kernel's ints (a ctypes array, read by
    the launch alone), their count and the scratch floats, cached."""
    plan = plan_bf16(dims, n_local, attend, k, b, m, sms, act, attend_act,
                     vec)
    ints = plan_ints(plan)
    return (_build.host_array(ctypes.c_int, ints), len(ints),
            plan["grid"] * plan["per_block"])


def _swizzle32(x, pw: int):
    """Slabs (…, pw rows, 2 chunks of 8 k) in the 32-byte swizzle: row n's
    two 16-byte chunks swapped where bit 2 of n is set (and back)."""
    swap = ((torch.arange(pw, device=x.device) >> 2) & 1).bool()
    return torch.where(swap.view(1, pw, 1, 1), x.flip(2), x)


@functools.lru_cache(maxsize=256)
def _pack_index(dims, device, ns=None):
    """:func:`pack_bf16`'s gathers, cached by chain: for each weight-image
    element and each padded bias, its place in [every layer's W (C_in,
    C_out) row-major, every bias, 0]; padding takes the trailing 0.
    ``ns``: passes of 64 ns columns (the chain's own by default)."""
    n_w = sum(a * c for a, c in zip(dims[:-1], dims[1:]))
    zero = n_w + sum(dims[1:])
    w_parts, b_parts, base, bbase = [], [], 0, n_w
    for cin, cout, npad in zip(dims[:-1], dims[1:], _stored_cols(dims, ns)):
        k16 = _round(cin, 16)
        n = torch.arange(npad)[:, None]
        k = torch.arange(k16)[None, :]
        at = torch.where((n < cout) & (k < cin), base + k * cout + n, zero)
        for p0, pw in _passes(npad, dims, ns):
            slabs = at[p0:p0 + pw].reshape(pw, k16 // 16, 2, 8).transpose(0, 1)
            w_parts.append(_swizzle32(slabs, pw).reshape(-1))
        col = torch.arange(npad)
        b_parts.append(torch.where(col < cout, bbase + col, zero))
        base, bbase = base + cin * cout, bbase + cout
    return torch.cat(w_parts).to(device), torch.cat(b_parts).to(device)


@functools.lru_cache(maxsize=None)
def _zero(device):
    return torch.zeros(1, device=device)


def pack_bf16(layers, device):
    """((W, b), ...) -> (K2-bf16's weight image, its biases): every layer's
    W rounded to bfloat16, transposed (output columns as rows, k
    contiguous), zero-padded to 16 k and 32 columns, cut into passes of 512
    columns and slabs of 16 k, each slab in the 32-byte swizzle that
    wgmma reads (its stages are runs of whole slabs, :func:`stage_table`);
    the biases float32, each zero-padded to its layer's stored columns.
    One concatenation and two gathers."""
    device = torch.device(device)
    if not layers:
        zeros = torch.zeros(8, device=device)
        return zeros.to(torch.bfloat16), zeros
    dims = (layers[0][0].shape[0],) + tuple(w.shape[1] for w, _ in layers)
    flat = torch.cat([w.detach().float().reshape(-1) for w, _ in layers]
                     + [b.detach().float().reshape(-1) for _, b in layers]
                     + [_zero(device)])
    iw, ib = _pack_index(dims, device)
    return flat[iw].to(torch.bfloat16), flat[ib]


group_reduce.launches = 0
group_reduce_bf16.launches = 0
