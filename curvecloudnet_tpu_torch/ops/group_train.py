"""K7: grouped message MLP + masked aggregation in TRAIN mode, with exact
masked BatchNorm batch statistics and exact gradients.

Counterpart of ``curvecloudnet_tpu/ops/pallas_group_train.py``
(``grouped_train_reduce`` and its custom VJP).  Notation, per (query,
plane) row; the layer-0 dense runs outside, as one plain matmul:

    v_0 = h1
    u_i = act(BN_i(v_i));  v_{i+1} = u_i @ W_i + b_i        (i = 0..L-1)
    msg = v_L
    attend:  g = msg @ Wa_0 + ba_0;  logits = act_a(BN_a(g)) @ Wa_1 + ba_1
    out = masked softmax-attend(msg, logits)  |  masked max(msg)

Every BN normalizes all rows with the statistics of the masked rows
(count n = max(sum(mask), 1), biased variance), and the gradients run
through the batch mean and variance.  The plain versions
:func:`group_train_fwd_ref` and :func:`group_train_bwd_ref` compute the
whole slab, as the JAX package's passes do.  The kernels
(``csrc/group_train.cu``) touch the live (plane, query) rows alone,
compacted once per call by :func:`row_list`, and store what the backward
reads instead of recomputing it:

    forward:  the first BN's statistics of h1's live rows; per dense one
              GEMM (BN + activation on load, bias, the next BN's partial
              statistics in the epilogue) storing v_1..v_L (and g, logits)
              and a finalize per BN; the aggregation per query;
    backward: per dense a data-gradient GEMM (the BN backward or the
              aggregation's backward on load, act' and the BN backward's
              partial sums in the epilogue), a weight-gradient GEMM (rows
              as the inner dimension, bias gradient beside) and a finalize
              for each; the elementwise epilogue T_0 -> d_h1 stays plain
              PyTorch glue, as the JAX package leaves it to XLA.

Every GEMM runs 3xTF32 on the tensor cores; every sum across blocks is a
partial per block summed in a fixed order (:func:`finalize_ref` is that
order on the CPU), so the kernels' gradients repeat bit for bit.  The
wrappers :func:`group_train_fwd` / :func:`group_train_bwd` run the plain
versions for CPU tensors and the kernels for CUDA tensors;
:class:`_GroupTrain` is the ``torch.autograd.Function`` around them.

A bfloat16 h1 (a model computing in bfloat16) takes the JAX package's
bfloat16 contract (``pallas_group_train.py`` ``_dot``, ``_dot_t``,
``_dot_wgrad`` with ``cdt`` h1's dtype): every product, forward, data
gradient and weight gradient, rounds both operands to bfloat16 (the
float32 deltas too) and sums in float32; the values between layers, the
BN statistics and backward, the softmax and the aggregation stay float32,
the output is float32; each local level's BN-output cotangent T is kept
in bfloat16 between backward levels (its BN sums taken before the
rounding), and d_h1 is bfloat16.  The kernels take the contract with
every product on K7-bf16's own ``wgmma`` kernels
(``csrc/group_train_wgmma.cuh``): a block transforms its 64 live rows once
and computes every output column;
the weights come from an image packed once a call (:func:`pack_images`, the
layout of ``group_reduce.pack_bf16``), :func:`plan_rows` and
:func:`plan_wgrad` lay out its launches.  The local levels' T, already
rounded, is stored in bfloat16.

Layouts: h1 (B, K, M, C0) k-major, mask (B, M, K) bool query-major with its
columns in h1's plane order.  Rows of fully masked queries carry junk
values and junk gradients, as in the JAX package; every consumer masks
them by row validity, so their cotangents are zero in any real loss, and
the cotangents at masked slots are exactly zero: the kernels drop both
(the max fill -100, or 0 under attend, at queries with no live slot).

In a data-parallel step (``parallel``, more than one process) every BN
takes the statistics of every process's live rows: the forward finalizes
each BN's partials to raw sums, sums them and the row count over the
processes, and forms mean, variance and inverse deviation before the
next GEMM applies them; the backward sums each level's BN sums (of T and
T x-hat) over the processes before the next level uses them.  The
parameter gradients stay this process's sums (the trainer sums them).
The plain versions do the same.  A process with no live row still joins
every sum.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch

from .. import parallel
from . import _build
from . import group_reduce as GR
from .aggregate import ATTEND_FILL, MAX_FILL
from .group_reduce import _sm_count

_ACT_CODES = {"relu": 0, "leaky_relu": 1, "identity": 2}


def _act(x, kind: str):
    if kind == "relu":
        return torch.clamp(x, min=0.0)
    if kind == "leaky_relu":
        return torch.where(x > 0, x, 0.01 * x)
    if kind == "identity":
        return x
    raise ValueError(kind)


def _dact(y, kind: str):
    """act'(y) at the activation input y (the BN output)."""
    one = torch.ones((), dtype=y.dtype, device=y.device)
    if kind == "relu":
        return torch.where(y > 0, one, torch.zeros_like(one))
    if kind == "leaky_relu":
        return torch.where(y > 0, one, torch.full_like(one, 0.01))
    if kind == "identity":
        return one.expand_as(y)
    raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    """Widths (C0, ..., CL) of the kernel-side local chain, the attention
    hidden width (0 for max), aggregation and activations."""
    dims: tuple
    att_dim: int
    aggr: str
    act: str
    attend_act: str = "leaky_relu"
    eps: float = 1e-5

    @property
    def n_loc(self) -> int:
        return len(self.dims) - 1

    @property
    def attend(self) -> bool:
        return self.aggr == "attend"

    @property
    def n_params(self) -> int:
        return 4 * self.n_loc + (6 if self.attend else 0)

    @property
    def n_bns(self) -> int:
        return self.n_loc + int(self.attend)


# params: per local level i (gamma_i, beta_i, W_i (C_i, C_{i+1}), b_i), then
# for attend (Wa_0 (CL, A), ba_0, gamma_a, beta_a, Wa_1 (A, CL), ba_1).
def _local(cfg, params, i):
    return params[4 * i:4 * i + 4]


def _att(cfg, params):
    return params[4 * cfg.n_loc:]


def _wdt(h1):
    """The plain versions' working dtype: float32 under the bfloat16
    contract, else h1's (float64 in the gradient checks)."""
    return torch.float32 if h1.dtype == torch.bfloat16 else h1.dtype


def _rnd(x, bf: bool):
    """x rounded to bfloat16 (to nearest even) and back, under the
    bfloat16 contract; x itself otherwise."""
    return x.to(torch.bfloat16).float() if bf else x


def _mm(a, w, bf: bool):
    """a @ w: float32, or bfloat16 operands with float32 sums (products of
    two bfloat16 values are exact in float32)."""
    return _rnd(a, bf) @ _rnd(w, bf)


def _bn(v, mu, var, g, b, eps):
    inv = torch.rsqrt(var + eps)
    xhat = (v - mu) * inv
    return xhat, xhat * g + b


def _global(*sums):
    """Column sums summed over the processes of a data-parallel step (one
    all-reduce); themselves in one process."""
    if parallel.world() == 1:
        return sums
    return parallel.reduce_sum(torch.stack(sums)).unbind(0)


def _masked_stats(v, mk, n):
    """(mean, biased var) over the masked rows (every process's): E[x^2] -
    mean^2, as the kernel's stats passes."""
    vm = v * mk
    s, ss = _global(vm.sum(dim=(0, 1, 2)), (vm * v).sum(dim=(0, 1, 2)))
    mu = s / n
    var = torch.clamp(ss / n - mu * mu, min=0.0)
    return mu, var


def _plane_mask(mask, dtype):
    return mask.transpose(1, 2)[..., None].to(dtype)        # (B, K, M, 1)


def _chain_ref(h1, mk, n, cfg, params, stats=None, bf=False):
    """The chain over every (plane, query) row.  With ``stats=None`` the
    batch statistics are computed on the way (the forward) and only the
    message (and logits) kept; with ``stats`` (the backward) each BN's
    x-hat is kept too (its output y = x-hat * gamma + beta is recomputed
    where needed: the same operations, so the same values, in less memory
    on the wide sites).  Returns the kept values and the statistics
    [(mean, var)] (attend last)."""
    keep = {"xhat": []}
    new_stats = []
    v = h1.to(_wdt(h1))
    for i in range(cfg.n_loc):
        g, bt, w, b = _local(cfg, params, i)
        mv = _masked_stats(v, mk, n) if stats is None else stats[i]
        new_stats.append(mv)
        xhat, y = _bn(v, *mv, g, bt, cfg.eps)
        if stats is not None:
            keep["xhat"].append(xhat)
        del xhat
        v = _mm(_act(y, cfg.act), w, bf) + b
        del y
    keep["msg"] = v
    if cfg.attend:
        wa0, ba0, ga, bta, wa1, ba1 = _att(cfg, params)
        gv = _mm(v, wa0, bf) + ba0
        mv = _masked_stats(gv, mk, n) if stats is None else stats[cfg.n_loc]
        new_stats.append(mv)
        a_xhat, a_y = _bn(gv, *mv, ga, bta, cfg.eps)
        del gv
        if stats is not None:
            keep["a_xhat"] = a_xhat
        del a_xhat
        keep["logits"] = _mm(_act(a_y, cfg.attend_act), wa1, bf) + ba1
    return keep, new_stats


def group_train_fwd_ref(h1, mask, cfg: TrainCfg, params):
    """-> (out (B, M, CL), stats [(mean, var)] per BN (attend last), n,
    extras: (out, mx, den) for attend, (mx, cnt) for max)."""
    wdt = _wdt(h1)
    n = torch.clamp(parallel.reduce_sum(mask.sum()).to(wdt), min=1.0)
    mk = _plane_mask(mask, wdt)
    keep, stats = _chain_ref(h1, mk, n, cfg, params,
                             bf=h1.dtype == torch.bfloat16)
    on = mk > 0
    msg = keep["msg"]
    if cfg.attend:
        lg = torch.where(on, keep["logits"], torch.full_like(msg, ATTEND_FILL))
        mx = lg.amax(dim=1)
        e = torch.exp(lg - mx[:, None])
        den = e.sum(dim=1)
        out = (e * msg).sum(dim=1) / den
        return out, stats, n, (out, mx, den)
    hit = torch.where(on, msg, torch.full_like(msg, MAX_FILL))
    mx = hit.amax(dim=1)
    cnt = (hit == mx[:, None]).sum(dim=1).to(wdt)
    return mx, stats, n, (mx, cnt)


def _wgrad(a, d, bf=False):
    """sum over every row of a^T d -> (C_a, C_d)."""
    return torch.einsum("bkmi,bkmj->ij", _rnd(a, bf), _rnd(d, bf))


def _colsum(t):
    return t.sum(dim=(0, 1, 2))


def group_train_bwd_ref(h1, mask, cfg: TrainCfg, params, stats, n, extras,
                        dout):
    """-> (d_h1 in h1's dtype, d_params in the order of ``params``)."""
    bf = h1.dtype == torch.bfloat16
    mk = _plane_mask(mask, _wdt(h1))
    keep, _ = _chain_ref(h1, mk, n, cfg, params, stats, bf)
    msg, d = keep["msg"], dout[:, None]
    grads = [None] * cfg.n_params
    if cfg.attend:
        # the slab-wide terms are formed in place where a term is dead
        # after the step (the same operations in the same order: the same
        # values, in less memory at the wide sites)
        out, mx, den = extras
        wa0, ba0, ga, bta, wa1, ba1 = _att(cfg, params)
        w = torch.where(mk > 0, keep.pop("logits"),
                        torch.full_like(msg[:1, :1, :1], ATTEND_FILL))
        w = torch.exp_(w.sub_(mx[:, None])).div_(den[:, None])
        dlogit = (msg - out[:, None]).mul_(w).mul_(d).mul_(mk)
        a_xhat = keep.pop("a_xhat")
        a_y = a_xhat * ga + bta
        ta = _mm(dlogit, wa1.t(), bf).mul_(_dact(a_y, cfg.attend_act)).mul_(
            mk)
        rsa, rpa = _colsum(ta), _colsum(ta * a_xhat)
        gsa, gpa = _global(rsa, rpa)
        inva = torch.rsqrt(stats[cfg.n_loc][1] + cfg.eps)
        dg1 = (a_xhat * (gpa / n)).add_(gsa / n).mul_(mk)
        dg1 = torch.sub(ta, dg1, out=dg1).mul_(ga * inva)
        del ta, a_xhat
        k = 4 * cfg.n_loc
        grads[k:k + 6] = [_wgrad(msg, dg1, bf), _colsum(dg1), rpa, rsa,
                          _wgrad(_act(a_y, cfg.attend_act), dlogit, bf),
                          _colsum(dlogit)]
        del a_y, dlogit
        dv = w.mul_(d).add_(_mm(dg1, wa0.t(), bf))
        del w, dg1
    else:
        mx, cnt = extras
        hit = torch.where(mk > 0, msg, torch.full_like(msg, MAX_FILL))
        eq = (hit == mx[:, None]).to(mk.dtype)
        dv = d * eq * mk / torch.clamp(cnt, min=1.0)[:, None]
    for li in reversed(range(cfg.n_loc)):
        g, bt, w_l, _ = _local(cfg, params, li)
        xhat = keep["xhat"][li]
        keep["xhat"][li] = None
        y = xhat * g + bt
        dw, db = _wgrad(_act(y, cfg.act), dv, bf), _colsum(dv)
        t = _mm(dv, w_l.t(), bf) * _dact(y, cfg.act) * mk
        rs, rp = _colsum(t), _colsum(t * xhat)
        gs, gp = _global(rs, rp)
        t = _rnd(t, bf)      # kept in h1's dtype between levels
        inv = torch.rsqrt(stats[li][1] + cfg.eps)
        dv = g * inv * (t - mk * (gs / n + xhat * (gp / n)))
        grads[4 * li:4 * li + 4] = [rp, rs, dw, db]
    return dv.to(h1.dtype), tuple(grads)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

# A-operand transforms and epilogues of ccn_gt_gemm (csrc/group_train.cu)
_TR = {"none": 0, "bn_act": 1, "bnb": 2, "maxb": 3, "dlogit": 4}
_EP = {"fwd": 0, "dgrad": 1, "att": 2}
# its device-pointer and int slots, in the C order
_GEMM_PTRS = ("x", "x2", "mu", "inv", "gam", "bet", "c0", "c1", "c2", "qd",
              "qmx", "qaux", "qout", "w", "bias", "ex", "emu", "einv", "egam",
              "ebet", "elg", "xidx", "qry", "exidx", "asave", "y", "part")
_GEMM_INTS = ("ldx", "tr", "act", "R", "K", "N", "ep", "stats", "ldex",
              "eact", "rps")
# rows (and output columns) of a GEMM tile; rows of an inner stage
TILE = 64
STAGE = 32
# weight gradient: blocks worth aiming at (four of 56 KB fit an SM) and
# the fewest rows a block reduces
_WG_BLOCKS_PER_SM = 4
_WG_MIN_ROWS = 128


def row_list(mask):
    """The live (plane, query) rows of mask (B, M, K), query-major (a
    query's live planes in plane order, queries in order) -> (rows: each
    row's index in the k-major slab (B, K, M), queries: its b * M + m,
    start (B * M + 1,): each query's first row), all int32.  One host
    sync (the row count)."""
    b, m, k = mask.shape
    flat = mask.reshape(-1).nonzero().squeeze(1)
    qry = torch.div(flat, k, rounding_mode="floor")
    bb = torch.div(qry, m, rounding_mode="floor")
    rows = (bb * k + flat - qry * k) * m + qry - bb * m
    start = torch.zeros(b * m + 1, dtype=torch.int64, device=mask.device)
    start[1:] = torch.cumsum(mask.sum(-1).reshape(-1), 0)
    return rows.int(), qry.int(), start.int()


def wgrad_split(rows: int, c_in: int, c_out: int, sms: int):
    """(row splits, rows a split) of a weight gradient: enough blocks of
    64 x 64 tiles of dW for _WG_BLOCKS_PER_SM an SM, each over at least
    _WG_MIN_ROWS rows, a multiple of the 32-row stage."""
    tiles = -(-c_in // TILE) * -(-c_out // TILE)
    splits = max(1, min(-(-_WG_BLOCKS_PER_SM * sms // tiles),
                        -(-rows // _WG_MIN_ROWS)))
    rps = -(-max(rows, 1) // splits)
    rps = -(-rps // STAGE) * STAGE
    return max(1, -(-rows // rps)), rps


# K7-bf16's launch plan (csrc/group_train_wgmma.cuh GtwPlan, in order)
GTW_FIELDS = ("kind", "ns", "npass", "nslab", "per", "nst", "resident",
              "sb", "atiles", "w_off", "red_off", "bar_off", "smem",
              "splits", "rps", "xbf", "exbf", "ybf")
# its kinds: the products over the rows on two warpgroups (N past 256
# columns), the weight gradient, the products over the rows on one
GTW_ROWS2, GTW_WGRAD, GTW_ROWS1 = 0, 1, 2
# rows of a tile (a weight-gradient chunk), the widest A a tile holds, the
# weight ring's slots; a weight-gradient block's channels and the blocks
# an SM worth aiming at, each over at least GTW_WG_MIN_ROWS rows
GTW_ROWS = 64
GTW_MAX_K = 1024
GTW_MAXST = 16
GTW_WG_CH = 128
GTW_WG_BLOCKS_PER_SM = 2
GTW_WG_MIN_ROWS = 256


def _ns(k: int, n: int) -> int:
    """A k x n product's passes, of 64 ns columns: ``group_reduce._ns`` of
    the layer up to 256 columns, else 8 (passes of 512, zero-padded past n;
    the two-warpgroup kernel is built for ns 8 only)."""
    ns = GR._ns((k, n))
    return ns if ns <= 4 else 8


def plan_rows(k: int, n: int, xbf=0, exbf=0, ybf=0):
    """K7-bf16's launch of a product over the rows, y (R, n) = T(x) (R, k)
    @ B (k, n) -> {GTW_FIELDS: value}.  A block a 64-row tile holds its A
    (k to 16, in 64-column tiles) and takes every output column in passes
    of 64 ns columns (:func:`_ns`: ``pack_bf16``'s passes of the layer up
    to 256 columns, else 512), each over slabs of 16 k, as many a stage as
    ``GW_STAGE`` bytes hold.  Up to 256 columns (ns <= 4) one warpgroup
    takes a whole pass (GTW_ROWS1), the image whole where it is up to 2
    stages, else through a ring of 2 (a slot is refilled once the next
    stage's products are issued), so that several blocks share an SM;
    wider, two warpgroups split it (GTW_ROWS2) and a weight warp streams
    the image, resident
    where it fits (up to GTW_MAXST stages), else through the deepest ring
    of up to 8 stages.  Raises where k is past GTW_MAX_K or n past the
    image's widest layer."""
    if not (1 <= k <= GTW_MAX_K and 1 <= n <= GR.GW_MAX_WIDTH):
        raise ValueError(f"group train kernel (bfloat16): a {k} x {n} "
                         "product is past its limits")
    ns = _ns(k, n)
    pw = 64 * ns
    npass, nslab = -(-n // pw), -(-k // 16)
    per = max(1, GR.GW_STAGE // (pw * 32))
    stages = npass * -(-nslab // per)
    sb = min(per, nslab) * pw * 32
    atiles = -(-k // 64)
    one = ns <= 4
    # the column sums of 64 ns columns, and two 64 x 32 f32 staging tiles
    # a consumer warpgroup
    red = 2 * 2 * 4 * 32 * ns * 4 + (1 if one else 2) * 2 * GR.GW_TILE

    def smem(nst):
        return (1024 + atiles * GR.GW_TILE + nst * sb + red
                + 8 * nst * (1 if one else 2))

    if one:
        layouts = [(stages, 1)] if stages <= 2 else [(2, 0)]
    else:
        layouts = ([(stages, 1)] if stages <= GTW_MAXST else []) + [
            (st, 0) for st in range(min(8, stages), 0, -1)]
    layout = next((lay for lay in layouts if smem(lay[0]) <= _build.MAX_SMEM),
                  None)
    if layout is None:
        raise ValueError(f"group train kernel (bfloat16): a {k} x {n} "
                         "product does not fit a block's shared memory")
    nst, resident = layout
    w_off = atiles * GR.GW_TILE
    red_off = w_off + nst * sb
    return dict(kind=GTW_ROWS1 if one else GTW_ROWS2, ns=ns, npass=npass,
                nslab=nslab, per=per, nst=nst, resident=resident, sb=sb,
                atiles=atiles, w_off=w_off, red_off=red_off,
                bar_off=red_off + red, smem=smem(nst), splits=1, rps=0,
                xbf=int(xbf), exbf=int(exbf), ybf=int(ybf))


def plan_wgrad(rows: int, k: int, n: int, sms: int, xbf=0):
    """K7-bf16's weight gradient dW (k, n) = T(x)^T d over ``rows`` rows ->
    {GTW_FIELDS: value}: blocks of GTW_WG_CH channels x 32 ns columns (ns
    2, 4 or 8: n to 64, 128, wider), enough row splits for
    GTW_WG_BLOCKS_PER_SM blocks an SM, each over at least GTW_WG_MIN_ROWS
    rows, a multiple of the 64-row chunk; shared memory two chunk buffers
    (T(x) and d, bfloat16) and the bias gradient's sums."""
    if not (1 <= k <= GTW_MAX_K and 1 <= n <= GR.GW_MAX_WIDTH):
        raise ValueError(f"group train kernel (bfloat16): a {k} x {n} "
                         "weight gradient is past its limits")
    ns = 2 if n <= 64 else 4 if n <= 128 else 8
    tiles = -(-k // GTW_WG_CH) * -(-n // (32 * ns))
    splits = max(1, min(-(-GTW_WG_BLOCKS_PER_SM * sms // tiles),
                        -(-rows // GTW_WG_MIN_ROWS)))
    rps = -(-max(rows, 1) // splits)
    rps = -(-rps // GTW_ROWS) * GTW_ROWS
    buf = (2 + ns // 2) * GR.GW_TILE
    return dict(kind=GTW_WGRAD, ns=ns, npass=0, nslab=0, per=0, nst=0,
                resident=0, sb=0, atiles=0, w_off=0, red_off=2 * buf,
                bar_off=0, smem=1024 + 2 * buf + 8192,
                splits=max(1, -(-rows // rps)), rps=rps, xbf=int(xbf),
                exbf=0, ybf=0)


def plan_ints(plan):
    """The plan as the kernel's GtwPlan ints, in order."""
    return [int(plan[f]) for f in GTW_FIELDS]


@functools.lru_cache(maxsize=512)
def _plan(wg: bool, *args):
    """A product's plan (``plan_wgrad(*args)`` or ``plan_rows(*args)``) and
    its ints as a ctypes array, cached by shape."""
    plan = plan_wgrad(*args) if wg else plan_rows(*args)
    return plan, _build.host_array(ctypes.c_int, plan_ints(plan))


def _layer_index(a: int, b: int, transposed: bool, colmajor: bool):
    """One layer's gathers of :func:`pack_images`, for W (a, b) stored
    row-major (or column-major: its transpose contiguous): the product's
    B (K, N) is W, or W^T where ``transposed``; ``pack_bf16``'s layout of
    B (``group_reduce._pack_index`` at :func:`_ns`) with its positions moved from B
    row-major to where W holds them -> (image gathers, bias gathers), in
    [W's elements, the biases (N,), 0]."""
    kk, nn = (b, a) if transposed else (a, b)
    iw, ib = GR._pack_index((kk, nn), torch.device("cpu"), _ns(kk, nn))
    n_w = kk * nn
    pos = iw.clone()
    w = iw < n_w
    k, n = iw[w] // nn, iw[w] % nn
    i, j = (n, k) if transposed else (k, n)
    pos[w] = j * a + i if colmajor else i * b + j
    return pos, ib


@functools.lru_cache(maxsize=256)
def _image_index(shapes, transposed: bool, device):
    """:func:`pack_images`' gathers, cached by the layers' (a, b,
    column-major): each layer's image elements and biases as positions in
    [every W as stored, every layer's biases, 0] -> (image gathers, bias
    gathers, [(image offset, image size, bias offset, bias size)])."""
    n_w = sum(a * b for a, b, _ in shapes)
    n_b = sum(a if transposed else b for a, b, _ in shapes)
    zero = n_w + n_b
    iws, ibs, offs = [], [], []
    wbase, bbase, io, bo = 0, n_w, 0, 0
    for a, b, colmajor in shapes:
        iw, ib = _layer_index(a, b, transposed, colmajor)
        nb = a if transposed else b
        kk = b if transposed else a

        def moved(x):
            return torch.where(x < kk * nb, wbase + x,
                               torch.where(x < kk * nb + nb,
                                           bbase + x - kk * nb,
                                           torch.full_like(x, zero)))

        iws.append(moved(iw))
        ibs.append(moved(ib))
        offs.append((io, iw.numel(), bo, ib.numel()))
        io, bo = io + iw.numel(), bo + ib.numel()
        wbase, bbase = wbase + a * b, bbase + nb
    return (torch.cat(iws).to(device), torch.cat(ibs).to(device), offs)


def pack_images(ws, biases, transposed: bool, device):
    """The layers' weight images of K7-bf16, packed once a call: W (a, b)
    each (or W^T where ``transposed``: the data gradient's B) rounded to
    bfloat16 in ``group_reduce.pack_bf16``'s layout (K-major slabs of 16 k
    of a pass's columns, 32-byte swizzle, zero-padded, passes of 64
    :func:`_ns` columns) read from W where it lies (no
    transposed copy), and the biases float32 zero-padded to the stored
    columns (zeros where ``transposed``) -> [(image, biases)] a layer,
    views of one bfloat16 and one float32 tensor.  One concatenation and
    two gathers."""
    device = torch.device(device)
    srcs, shapes = [], []
    for w in ws:
        w = w.detach()
        colmajor = not w.is_contiguous() and w.t().is_contiguous()
        srcs.append((w.t() if colmajor else w.contiguous()).reshape(-1))
        shapes.append((w.shape[0], w.shape[1], colmajor))
    iw, ib, offs = _image_index(tuple(shapes), transposed, device)
    if transposed:
        bparts = [torch.zeros(a, device=device) for a, _, _ in shapes]
    else:
        bparts = [b.detach().reshape(-1) for b in biases]
    flat = torch.cat([t.float() for t in srcs + bparts]
                     + [GR._zero(device)])
    img, bias = flat[iw].to(torch.bfloat16), flat[ib]
    return [(img[o:o + n], bias[bo:bo + nb]) for o, n, bo, nb in offs]


def finalize_ref(part):
    """The fixed summation order of ccn_gt_finalize on the CPU: part (P,
    ...) flattened to (P, N); lane l of 8 sums rows l, l + 8, ... in
    order, then the 8 lane sums in order -> (N,)."""
    flat = part.reshape(part.shape[0], -1)
    lanes = []
    for lane in range(8):
        acc = torch.zeros_like(flat[0])
        for p in range(lane, flat.shape[0], 8):
            acc = acc + flat[p]
        lanes.append(acc)
    out = lanes[0]
    for acc in lanes[1:]:
        out = out + acc
    return out


def _dptr(t):
    if t is None:
        return None
    if t.device.type != "cuda" or not t.is_contiguous() or t.dtype not in (
            torch.float32, torch.int32, torch.bfloat16):
        raise ValueError(f"group train kernel: operand {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.data_ptr()


class _Timing:
    """CUDA events of the launches made inside :func:`launch_times`."""

    def __init__(self):
        self.site = ""
        self.events = []


_timing: _Timing | None = None


@contextlib.contextmanager
def launch_times():
    """Time every kernel launch made inside the block with CUDA events.
    Yields a dict that, once the block has ended, maps (pass, site) to
    the milliseconds summed over its launches; a site names the call
    (aggregation, widths, K, M)."""
    global _timing
    timing, times = _Timing(), {}
    _timing = timing
    try:
        yield times
    finally:
        _timing = None
    torch.cuda.synchronize()
    for key, a, b in timing.events:
        times[key] = times.get(key, 0.0) + a.elapsed_time(b)


def _label(h1, cfg):
    """Name the call for :func:`launch_times`."""
    if _timing is not None:
        _timing.site = (f"{cfg.aggr} {cfg.dims} K={h1.shape[1]} "
                        f"M={h1.shape[2]}")


def _launch(counter, pass_: str, fn: str, *args):
    """One kernel launch of ``fn`` (pass name ``pass_``), counted, and
    timed inside :func:`launch_times`."""
    timing = _timing
    if timing is not None:
        a = torch.cuda.Event(enable_timing=True)
        a.record()
    _build.check(getattr(_build.library(), fn)(*args), f"{fn}({pass_})")
    counter.launches += 1
    if timing is not None:
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        timing.events.append(((pass_, timing.site), a, b))


def _gemm(counter, pass_: str, wg: bool, dev, splits=1, plan=None, **kw):
    """One product: float32 (``ccn_gt_gemm``), or with a K7-bf16 ``plan``
    (:func:`_plan`'s ctypes ints) ``ccn_gtw_gemm``."""
    ptrs = (ctypes.c_void_p * len(_GEMM_PTRS))(
        *[_dptr(kw.get(s)) for s in _GEMM_PTRS])
    ints = _build.host_array(ctypes.c_int, [kw.get(s, 0) for s in _GEMM_INTS])
    if plan is None:
        _launch(counter, pass_, "ccn_gt_gemm", int(wg), ptrs, ints, splits,
                _build.stream_ptr(dev))
    else:
        _launch(counter, pass_, "ccn_gtw_gemm", ptrs, ints, plan, len(plan),
                _build.stream_ptr(dev))


def _finalize(counter, dev, part, ncol: int, pair: bool, mode=0, n=1.0,
              eps=0.0, gam=None, inv=None):
    """Sum the per-block partials of ``part`` (P, ...) in a fixed order ->
    (sums (ncol or 2 ncol,), aux: mode 1 (mean, var, inv), mode 2 (gamma
    inv, sum T / n, sum T x-hat / n), else ())."""
    out = torch.empty(ncol * (2 if pair else 1), device=dev)
    aux = [torch.empty(ncol, device=dev) for _ in range(3)] if mode else []
    _launch(counter, "finalize", "ccn_gt_finalize", _dptr(part),
            part.shape[0], part[0].numel(), ncol, int(pair), _dptr(out), mode,
            n, eps, _dptr(gam), _dptr(inv),
            *[_dptr(a) for a in aux or [None] * 3], _build.stream_ptr(dev))
    return out, aux


def _bn_args(g, bt, mu, inv, act):
    """A BN + activation of the GEMM's A-operand transform."""
    return dict(mu=mu, inv=inv, gam=g.detach().contiguous(),
                bet=bt.detach().contiguous(), act=_ACT_CODES[act])


def _kernel_wgrad(counter, dev, x, d, c_in, c_out, rows, xidx=None,
                  tr="none", bf=False, **bn):
    """(dW (c_in, c_out), db (c_out,)) = sum over the rows of
    T(x)^T d and of d: per-split partials, then the fixed-order sum.
    ``bf``: K7-bf16 (the products' operands rounded to bfloat16, x read
    as bfloat16 where it is h1)."""
    plan = None
    if bf:
        pl, plan = _plan(True, rows, c_in, c_out, _sm_count(dev),
                         int(x.dtype == torch.bfloat16))
        splits, rps = pl["splits"], pl["rps"]
    else:
        splits, rps = wgrad_split(rows, c_in, c_out, _sm_count(dev))
    part = torch.empty(splits, c_in + 1, c_out, device=dev)
    _gemm(counter, "wgrad", True, dev, splits, plan, x=x, xidx=xidx,
          ldx=c_in, tr=_TR[tr], w=d, R=rows, K=c_in, N=c_out, rps=rps,
          part=part, **bn)
    out, _ = _finalize(counter, dev, part, (c_in + 1) * c_out, False)
    out = out.view(c_in + 1, c_out)
    return out[:c_in], out[c_in]


def _global_rows(r: int, dev) -> float:
    """max(live rows summed over the processes, 1) (a host sync)."""
    total = parallel.reduce_sum(torch.tensor([r], dtype=torch.int64,
                                             device=dev))
    return float(max(int(total), 1))


def _check_inputs(h1, mask, cfg):
    b, k, m, c0 = h1.shape
    if (h1.dtype not in (torch.float32, torch.bfloat16)
            or c0 != cfg.dims[0]):
        raise ValueError(f"group train kernel: h1 {tuple(h1.shape)} "
                         f"{h1.dtype}, want f32 or bf16 width {cfg.dims[0]}")
    if tuple(mask.shape) != (b, m, k):
        raise ValueError(f"group train kernel: mask {tuple(mask.shape)}")
    if cfg.n_loc < 1 or cfg.aggr not in ("max", "attend"):
        raise ValueError(f"group train kernel: {cfg}")
    return h1.contiguous(), mask.contiguous()


def _w(w):
    return w.detach().contiguous()


def group_train_fwd(h1, mask, cfg: TrainCfg, params):
    """Kernel K7's forward for CUDA tensors, the plain version for CPU
    tensors.  Returns what :func:`group_train_fwd_ref` returns, but for its
    extras: the kernel's own residuals (rows, queries, out, max, den |
    count, the stored v_1..v_L (and g, logits under attend) of the live
    rows, each BN's inverse deviation)."""
    if h1.device.type == "cpu":
        return group_train_fwd_ref(h1, mask, cfg, params)
    if h1.dtype == torch.bfloat16:
        return group_train_fwd_bf16(h1, mask, cfg, params)
    return _kernel_fwd(h1, mask, cfg, params, group_train_fwd)


def group_train_fwd_bf16(h1, mask, cfg: TrainCfg, params):
    """Kernel K7's bfloat16 forward (what :func:`group_train_fwd` runs on a
    bfloat16 h1), CUDA tensors only; counted apart."""
    if h1.dtype != torch.bfloat16:
        raise ValueError(f"group_train_fwd_bf16: h1 {h1.dtype}")
    return _kernel_fwd(h1, mask, cfg, params, group_train_fwd_bf16)


def _kernel_fwd(h1, mask, cfg, params, cnt=None):
    """The forward's launches, each counted on ``cnt`` (the wrapper of h1's
    dtype by default)."""
    h1, mask = _check_inputs(h1, mask, cfg)
    _label(h1, cfg)
    b, k, m, c0 = h1.shape
    dev, L, dims = h1.device, cfg.n_loc, cfg.dims
    bf = int(h1.dtype == torch.bfloat16)
    cnt = cnt or (group_train_fwd_bf16 if bf else group_train_fwd)
    rows, qry, start = row_list(mask)
    r = rows.numel()
    n_rows = float(max(r, 1))
    # a data-parallel step: the count and each BN's sums over every
    # process's rows (the kernels' partials finalized to raw sums here)
    dp = parallel.world() > 1
    n_all = _global_rows(r, dev) if dp else n_rows
    tiles = max(1, -(-r // TILE))
    stream = _build.stream_ptr(dev)
    stats, invs, vals = [], [], []

    def statistics(part, c):
        sums, (mu, var, inv) = _finalize(cnt, dev, part, c, True, 1, n_rows,
                                         cfg.eps)
        if dp:
            s = parallel.reduce_sum(sums)
            mu = s[:c] / n_all
            var = torch.clamp(s[c:] / n_all - mu * mu, min=0.0)
            inv = torch.rsqrt(var + cfg.eps)
        stats.append((mu, var))
        invs.append(inv)

    # K7-bf16: every layer's weight image, packed once
    layers = [_local(cfg, params, lv)[2:] for lv in range(L)]
    if cfg.attend:
        wa0, ba0, ga, bta, wa1, ba1 = _att(cfg, params)
        layers += [(wa0, ba0), (wa1, ba1)]
    if bf:
        wts = pack_images([w for w, _ in layers], [b for _, b in layers],
                          False, dev)
    else:
        wts = [(_w(w), _w(b)) for w, b in layers]

    def weights(i, k_, n_, xbf=0):
        """Layer i's operands (and K7-bf16's plan)."""
        w, b = wts[i]
        plan = _plan(False, k_, n_, xbf)[1] if bf else None
        return dict(w=w, bias=b, plan=plan)

    part = torch.empty(tiles, 2 * c0, device=dev)
    _launch(cnt, "stats", "ccn_gt_rowstats" + ("_bf16" if bf else ""),
            _dptr(h1), _dptr(rows), c0, r, c0, _dptr(part), stream)
    statistics(part, c0)
    x, xidx = h1, rows
    for lv in range(L):
        g, bt = _local(cfg, params, lv)[:2]
        cout, more = dims[lv + 1], lv + 1 < L
        y = torch.empty(r, cout, device=dev)
        part = torch.empty(tiles, 2 * cout, device=dev) if more else None
        _gemm(cnt, "dense", False, dev, x=x, xidx=xidx, ldx=dims[lv],
              tr=_TR["bn_act"],
              **_bn_args(g, bt, stats[lv][0], invs[lv], cfg.act),
              **weights(lv, dims[lv], cout, int(x.dtype == torch.bfloat16)),
              y=y, part=part, R=r, K=dims[lv], N=cout, ep=_EP["fwd"],
              stats=int(more))
        if more:
            statistics(part, cout)
        vals.append(y)
        x, xidx = y, None
    msg, cl, lg = x, dims[L], None
    if cfg.attend:
        a = cfg.att_dim
        gv = torch.empty(r, a, device=dev)
        part = torch.empty(tiles, 2 * a, device=dev)
        _gemm(cnt, "dense", False, dev, x=msg, ldx=cl, tr=_TR["none"],
              **weights(L, cl, a), y=gv, part=part, R=r, K=cl, N=a,
              ep=_EP["fwd"], stats=1)
        statistics(part, a)
        lg = torch.empty(r, cl, device=dev)
        _gemm(cnt, "dense", False, dev, x=gv, ldx=a, tr=_TR["bn_act"],
              **_bn_args(ga, bta, stats[L][0], invs[L], cfg.attend_act),
              **weights(L + 1, a, cl), y=lg, R=r, K=a, N=cl,
              ep=_EP["fwd"])
        vals += [gv, lg]
    out = torch.empty((b, m, cl), device=dev)
    mx = torch.empty((b, m, cl), device=dev) if cfg.attend else out
    aux = torch.empty((b, m, cl), device=dev)
    _launch(cnt, "aggregate", "ccn_gt_aggregate", _dptr(msg), _dptr(lg),
            _dptr(start), b * m, cl, k, int(cfg.attend), _dptr(out),
            _dptr(mx), _dptr(aux), stream)
    n = torch.full((), n_all, device=dev)
    return out, stats, n, (rows, qry, out, mx, aux, *vals, *invs)


def group_train_bwd(h1, mask, cfg: TrainCfg, params, stats, n, extras,
                    dout):
    """Kernel K7's backward for CUDA tensors (``extras`` from
    :func:`group_train_fwd`), the plain version for CPU tensors.  Returns
    what :func:`group_train_bwd_ref` returns."""
    if h1.device.type == "cpu":
        return group_train_bwd_ref(h1, mask, cfg, params, stats, n, extras,
                                   dout)
    if h1.dtype == torch.bfloat16:
        return group_train_bwd_bf16(h1, mask, cfg, params, stats, n, extras,
                                    dout)
    return _kernel_bwd(h1, mask, cfg, params, stats, extras, dout,
                       group_train_bwd, n)


def group_train_bwd_bf16(h1, mask, cfg: TrainCfg, params, stats, n, extras,
                         dout):
    """Kernel K7's bfloat16 backward (what :func:`group_train_bwd` runs on
    a bfloat16 h1), CUDA tensors only; counted apart."""
    if h1.dtype != torch.bfloat16:
        raise ValueError(f"group_train_bwd_bf16: h1 {h1.dtype}")
    return _kernel_bwd(h1, mask, cfg, params, stats, extras, dout,
                       group_train_bwd_bf16, n)


def _kernel_bwd(h1, mask, cfg, params, stats, extras, dout, cnt=None,
                n=None):
    """The backward's launches, each counted on ``cnt`` (the wrapper of
    h1's dtype by default); ``n`` the forward's count, which a
    data-parallel step's BN backward divides its global sums by."""
    h1, mask = _check_inputs(h1, mask, cfg)
    _label(h1, cfg)
    c0 = h1.shape[-1]
    dev, L, dims = h1.device, cfg.n_loc, cfg.dims
    bf = h1.dtype == torch.bfloat16
    cnt = cnt or (group_train_bwd_bf16 if bf else group_train_bwd)
    rows, qry, out, mx, aux = extras[:5]
    vals = extras[5:5 + L + 2 * cfg.attend]
    invs = extras[5 + L + 2 * cfg.attend:]
    r = rows.numel()
    n_rows = float(max(r, 1))
    dp = parallel.world() > 1
    n_all = float(n) if dp else n_rows
    tiles = max(1, -(-r // TILE))
    dout = dout.float().contiguous()
    v = [h1] + list(vals[:L])          # v_0 through the row index
    grads = [None] * cfg.n_params
    per_query = dict(qry=qry, qd=dout, qmx=mx, qaux=aux, qout=out)
    # the data gradients' B = W^T of every layer: K7-bf16's images, packed
    # once (read from W as it lies)
    ws = [_local(cfg, params, lv)[2] for lv in range(L)]
    if cfg.attend:
        ws += _att(cfg, params)[0:5:4]           # Wa0, Wa1
    wts = (pack_images(ws, None, True, dev) if bf
           else [(w.detach().t().contiguous(), None) for w in ws])

    def wt(i, k_, n_, x, ybf=0, ex=None):
        """Layer i's W^T (and K7-bf16's plan of the product)."""
        plan = None
        if bf:
            plan = _plan(False, k_, n_, int(x.dtype == torch.bfloat16),
                         int(ex is not None and ex.dtype == torch.bfloat16),
                         ybf)[1]
        return dict(w=wts[i][0], plan=plan)

    def dgrad(x, tr, save, li, cout, cin, ex, exidx, bn_e, act, rnd, **kw):
        """T (rows, cin) = (T(x) @ W_li^T) * act'(y) of the level below,
        and its BN backward's sums -> (T, (gamma, beta) grads, coef);
        ``rnd``: T is kept in bfloat16 (its sums taken before the
        rounding)."""
        t = torch.empty(r, cin, device=dev,
                        dtype=torch.bfloat16 if rnd else torch.float32)
        part = torch.empty(tiles, 2 * cin, device=dev)
        _gemm(cnt, "dgrad", False, dev, x=x, ldx=cout, tr=_TR[tr],
              asave=save, **wt(li, cout, cin, x, int(rnd), ex), y=t,
              part=part, R=r, K=cout, N=cin, ep=_EP["dgrad"], stats=1,
              ex=ex, exidx=exidx, ldex=cin, emu=bn_e["mu"],
              einv=bn_e["inv"], egam=bn_e["gam"], ebet=bn_e["bet"],
              eact=_ACT_CODES[act], **kw)
        sums, coef = _finalize(cnt, dev, part, cin, True, 2, n_rows,
                               gam=bn_e["gam"], inv=bn_e["inv"])
        if dp:  # the gradients stay this process's sums
            s = parallel.reduce_sum(sums)
            coef = [bn_e["gam"] * bn_e["inv"], s[:cin] / n_all,
                    s[cin:] / n_all]
        return t, [sums[cin:], sums[:cin]], coef

    if cfg.attend:
        ga, bta = _att(cfg, params)[2:4]
        a, cl = cfg.att_dim, dims[L]
        gv, lg = vals[L], vals[L + 1]
        bn_a = _bn_args(ga, bta, stats[L][0], invs[L], cfg.attend_act)
        dl = torch.empty(r, cl, device=dev)
        ta, g_a, coef_a = dgrad(lg, "dlogit", dl, L + 1, cl, a, gv, None,
                                bn_a, cfg.attend_act, False, x2=v[L],
                                **per_query)
        dwa1, dba1 = _kernel_wgrad(cnt, dev, gv, dl, a, cl, r, tr="bn_act",
                                   bf=bf, **bn_a)
        dg1 = torch.empty(r, a, device=dev)
        dv = torch.empty(r, cl, device=dev)
        _gemm(cnt, "dgrad", False, dev, x=ta, x2=gv, ldx=a, tr=_TR["bnb"],
              mu=bn_a["mu"], inv=bn_a["inv"], c0=coef_a[0], c1=coef_a[1],
              c2=coef_a[2], asave=dg1, **wt(L, a, cl, ta), y=dv, R=r, K=a,
              N=cl, ep=_EP["att"], elg=lg, **per_query)
        dwa0, dba0 = _kernel_wgrad(cnt, dev, v[L], dg1, cl, a, r, bf=bf)
        grads[4 * L:4 * L + 6] = [dwa0, dba0, *g_a, dwa1, dba1]
        d_in, tr, kw = dv, "none", {}
    else:
        d_in, tr, kw = v[L], "maxb", per_query
    for lv in reversed(range(L)):
        g, bt = _local(cfg, params, lv)[:2]
        cin, cout = dims[lv], dims[lv + 1]
        bn_l = _bn_args(g, bt, stats[lv][0], invs[lv], cfg.act)
        save = None if tr == "none" else torch.empty(r, cout, device=dev)
        xe, xidx = (h1, rows) if lv == 0 else (v[lv], None)
        t, g_l, coef = dgrad(d_in, tr, save, lv, cout, cin, xe, xidx, bn_l,
                             cfg.act, bf, **kw)
        dw, db = _kernel_wgrad(cnt, dev, xe, d_in if save is None else save,
                               cin, cout, r, xidx, "bn_act", bf, **bn_l)
        grads[4 * lv:4 * lv + 4] = [*g_l, dw, db]
        d_in, tr = t, "bnb"
        kw = dict(x2=xe, mu=bn_l["mu"], inv=bn_l["inv"], c0=coef[0],
                  c1=coef[1], c2=coef[2])
    # epilogue T_0 -> d_h1: elementwise glue over the live rows
    idx = rows.long()
    xhat0 = ((h1.reshape(-1, c0).index_select(0, idx).float() - stats[0][0])
             * invs[0])
    d0 = coef[0] * (d_in.float() - (coef[1] + xhat0 * coef[2]))
    d_h1 = torch.zeros_like(h1)
    d_h1.view(-1, c0).index_copy_(0, idx, d0.to(h1.dtype))
    return d_h1, tuple(grads)


group_train_fwd.launches = 0
group_train_bwd.launches = 0
group_train_fwd_bf16.launches = 0
group_train_bwd_bf16.launches = 0


class _GroupTrain(torch.autograd.Function):
    """out = K7(h1, mask; params) with gradients for h1 and every param;
    the batch statistics are returned as non-differentiable outputs."""

    @staticmethod
    def forward(ctx, cfg, h1, mask, *params):
        out, stats, n, extras = group_train_fwd(h1, mask, cfg, params)
        flat = [t for mv in stats for t in mv]
        ctx.cfg = cfg
        ctx.n_extras = len(extras)
        ctx.save_for_backward(h1, mask, n, *params, *flat, *extras)
        ctx.mark_non_differentiable(n, *flat)
        return (out, n, *flat)

    @staticmethod
    def backward(ctx, d_out, *_):
        cfg = ctx.cfg
        saved = ctx.saved_tensors
        h1, mask, n = saved[:3]
        params = saved[3:3 + cfg.n_params]
        rest = saved[3 + cfg.n_params:]
        flat, extras = rest[:2 * cfg.n_bns], rest[2 * cfg.n_bns:]
        stats = [(flat[2 * i], flat[2 * i + 1]) for i in range(cfg.n_bns)]
        d_h1, grads = group_train_bwd(h1, mask, cfg, params, stats, n,
                                      extras, d_out.contiguous())
        return (None, d_h1, None, *grads)


def _lin(lin):
    w = lin.weight.t()
    b = lin.bias if lin.bias is not None else torch.zeros(
        w.shape[1], device=w.device, dtype=w.dtype)
    return w, b


def mlp_params(local_nn, attend_nn=None):
    """The kernel's parameter tuple from the port's MLP modules: the local
    MLP past its layer 0 (norm_i with lin_{i+1}), then the attention MLP."""
    params = []
    for i in range(len(local_nn.lins) - 1):
        nrm = local_nn.norms[i]
        params += [nrm.weight, nrm.bias, *_lin(local_nn.lins[i + 1])]
    if attend_nn is not None:
        nrm = attend_nn.norms[0]
        params += [*_lin(attend_nn.lins[0]), nrm.weight, nrm.bias,
                   *_lin(attend_nn.lins[1])]
    return tuple(params)


def group_train_reduce(h1, mask, local_nn, attend_nn=None, aggr="max",
                       act="relu", attend_act="leaky_relu"):
    """Train-mode grouped MLP + aggregation through K7.

    h1 (B, K, M, C1) layer-0 pre-norm messages, mask (B, M, K).  Returns
    (out (B, M, C_out), local_stats [(mean, var, n)] for norm_0..norm_{L-1}
    of ``local_nn``, att_stats [(mean, var, n)] for the attention norm)."""
    if len(local_nn.lins) < 2:
        raise ValueError("K7 runs the denses past layer 0: a one-layer MLP "
                         "takes the plain route (models/modules._grouped)")
    if aggr == "attend" and (attend_nn is None or len(attend_nn.lins) != 2):
        raise ValueError("attend takes a two-layer attention MLP")
    dims = (h1.shape[-1],) + tuple(lin.out_features
                                   for lin in local_nn.lins[1:])
    cfg = TrainCfg(dims=dims, aggr=aggr, act=act, attend_act=attend_act,
                   att_dim=(attend_nn.lins[0].out_features
                            if aggr == "attend" else 0),
                   eps=local_nn.norms[0].eps)
    out, n, *flat = _GroupTrain.apply(cfg, h1, mask, *mlp_params(
        local_nn, attend_nn if aggr == "attend" else None))
    stats = [(flat[2 * i], flat[2 * i + 1], n) for i in range(cfg.n_bns)]
    return out, stats[:cfg.n_loc], stats[cfg.n_loc:]
