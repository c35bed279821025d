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

Layouts: h1 (B, K, M, C0) k-major, mask (B, M, K) bool query-major with its
columns in h1's plane order.  Rows of fully masked queries carry junk
values and junk gradients, as in the JAX package; every consumer masks
them by row validity, so their cotangents are zero in any real loss, and
the cotangents at masked slots are exactly zero: the kernels drop both
(the max fill -100, or 0 under attend, at queries with no live slot).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch

from . import _build
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


def _bn(v, mu, var, g, b, eps):
    inv = torch.rsqrt(var + eps)
    xhat = (v - mu) * inv
    return xhat, xhat * g + b


def _masked_stats(v, mk, n):
    """(mean, biased var) over the masked rows: E[x^2] - mean^2, as the
    kernel's stats passes."""
    vm = v * mk
    mu = vm.sum(dim=(0, 1, 2)) / n
    var = torch.clamp((vm * v).sum(dim=(0, 1, 2)) / n - mu * mu, min=0.0)
    return mu, var


def _plane_mask(mask, dtype):
    return mask.transpose(1, 2)[..., None].to(dtype)        # (B, K, M, 1)


def _chain_ref(h1, mk, n, cfg, params, stats=None):
    """The chain over every (plane, query) row.  With ``stats=None`` the
    batch statistics are computed on the way (the forward) and only the
    message (and logits) kept; with ``stats`` (the backward) each BN's
    x-hat is kept too (its output y = x-hat * gamma + beta is recomputed
    where needed: the same operations, so the same values, in less memory
    on the wide sites).  Returns the kept values and the statistics
    [(mean, var)] (attend last)."""
    keep = {"xhat": []}
    new_stats = []
    v = h1
    for i in range(cfg.n_loc):
        g, bt, w, b = _local(cfg, params, i)
        mv = _masked_stats(v, mk, n) if stats is None else stats[i]
        new_stats.append(mv)
        xhat, y = _bn(v, *mv, g, bt, cfg.eps)
        if stats is not None:
            keep["xhat"].append(xhat)
        del xhat
        v = _act(y, cfg.act) @ w + b
        del y
    keep["msg"] = v
    if cfg.attend:
        wa0, ba0, ga, bta, wa1, ba1 = _att(cfg, params)
        gv = v @ wa0 + ba0
        mv = _masked_stats(gv, mk, n) if stats is None else stats[cfg.n_loc]
        new_stats.append(mv)
        a_xhat, a_y = _bn(gv, *mv, ga, bta, cfg.eps)
        del gv
        if stats is not None:
            keep["a_xhat"] = a_xhat
        del a_xhat
        keep["logits"] = _act(a_y, cfg.attend_act) @ wa1 + ba1
    return keep, new_stats


def group_train_fwd_ref(h1, mask, cfg: TrainCfg, params):
    """-> (out (B, M, CL), stats [(mean, var)] per BN (attend last), n,
    extras: (out, mx, den) for attend, (mx, cnt) for max)."""
    n = torch.clamp(mask.sum().to(h1.dtype), min=1.0)
    mk = _plane_mask(mask, h1.dtype)
    keep, stats = _chain_ref(h1, mk, n, cfg, params)
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
    cnt = (hit == mx[:, None]).sum(dim=1).to(h1.dtype)
    return mx, stats, n, (mx, cnt)


def _wgrad(a, d):
    """sum over every row of a^T d -> (C_a, C_d)."""
    return torch.einsum("bkmi,bkmj->ij", a, d)


def _colsum(t):
    return t.sum(dim=(0, 1, 2))


def group_train_bwd_ref(h1, mask, cfg: TrainCfg, params, stats, n, extras,
                        dout):
    """-> (d_h1, d_params in the order of ``params``)."""
    mk = _plane_mask(mask, h1.dtype)
    keep, _ = _chain_ref(h1, mk, n, cfg, params, stats)
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
        ta = (dlogit @ wa1.t()).mul_(_dact(a_y, cfg.attend_act)).mul_(mk)
        rsa, rpa = _colsum(ta), _colsum(ta * a_xhat)
        inva = torch.rsqrt(stats[cfg.n_loc][1] + cfg.eps)
        dg1 = (a_xhat * (rpa / n)).add_(rsa / n).mul_(mk)
        dg1 = torch.sub(ta, dg1, out=dg1).mul_(ga * inva)
        del ta, a_xhat
        k = 4 * cfg.n_loc
        grads[k:k + 6] = [_wgrad(msg, dg1), _colsum(dg1), rpa, rsa,
                          _wgrad(_act(a_y, cfg.attend_act), dlogit),
                          _colsum(dlogit)]
        del a_y, dlogit
        dv = w.mul_(d).add_(dg1 @ wa0.t())
        del w, dg1
    else:
        mx, cnt = extras
        hit = torch.where(mk > 0, msg, torch.full_like(msg, MAX_FILL))
        eq = (hit == mx[:, None]).to(h1.dtype)
        dv = d * eq * mk / torch.clamp(cnt, min=1.0)[:, None]
    for li in reversed(range(cfg.n_loc)):
        g, bt, w_l, _ = _local(cfg, params, li)
        xhat = keep["xhat"][li]
        keep["xhat"][li] = None
        y = xhat * g + bt
        dw, db = _wgrad(_act(y, cfg.act), dv), _colsum(dv)
        t = (dv @ w_l.t()) * _dact(y, cfg.act) * mk
        rs, rp = _colsum(t), _colsum(t * xhat)
        inv = torch.rsqrt(stats[li][1] + cfg.eps)
        dv = g * inv * (t - mk * (rs / n + xhat * (rp / n)))
        grads[4 * li:4 * li + 4] = [rp, rs, dw, db]
    return dv, tuple(grads)


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
            torch.float32, torch.int32):
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


def _gemm(counter, pass_: str, wg: bool, dev, splits=1, **kw):
    ptrs = (ctypes.c_void_p * len(_GEMM_PTRS))(
        *[_dptr(kw.get(s)) for s in _GEMM_PTRS])
    ints = _build.host_array(ctypes.c_int, [kw.get(s, 0) for s in _GEMM_INTS])
    _launch(counter, pass_, "ccn_gt_gemm", int(wg), ptrs, ints, splits,
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
                  tr="none", **bn):
    """(dW (c_in, c_out), db (c_out,)) = sum over the rows of
    T(x)^T d and of d: per-split partials, then the fixed-order sum."""
    splits, rps = wgrad_split(rows, c_in, c_out, _sm_count(dev))
    part = torch.empty(splits, c_in + 1, c_out, device=dev)
    _gemm(counter, "wgrad", True, dev, splits, x=x, xidx=xidx, ldx=c_in,
          tr=_TR[tr], w=d, R=rows, K=c_in, N=c_out, rps=rps, part=part, **bn)
    out, _ = _finalize(counter, dev, part, (c_in + 1) * c_out, False)
    out = out.view(c_in + 1, c_out)
    return out[:c_in], out[c_in]


def _check_inputs(h1, mask, cfg):
    b, k, m, c0 = h1.shape
    if h1.dtype != torch.float32 or c0 != cfg.dims[0]:
        raise ValueError(f"group train kernel: h1 {tuple(h1.shape)} "
                         f"{h1.dtype}, want f32 width {cfg.dims[0]}")
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
    return _kernel_fwd(h1, mask, cfg, params)


def _kernel_fwd(h1, mask, cfg, params):
    h1, mask = _check_inputs(h1, mask, cfg)
    _label(h1, cfg)
    b, k, m, c0 = h1.shape
    dev, L, dims = h1.device, cfg.n_loc, cfg.dims
    rows, qry, start = row_list(mask)
    r = rows.numel()
    n_rows = float(max(r, 1))
    tiles = max(1, -(-r // TILE))
    stream = _build.stream_ptr(dev)
    cnt = group_train_fwd
    stats, invs, vals = [], [], []

    def statistics(part, c):
        _, (mu, var, inv) = _finalize(cnt, dev, part, c, True, 1, n_rows,
                                      cfg.eps)
        stats.append((mu, var))
        invs.append(inv)

    part = torch.empty(tiles, 2 * c0, device=dev)
    _launch(cnt, "stats", "ccn_gt_rowstats", _dptr(h1), _dptr(rows), c0, r,
            c0, _dptr(part), stream)
    statistics(part, c0)
    x, xidx = h1, rows
    for lv in range(L):
        g, bt, w, bias = _local(cfg, params, lv)
        cout, more = dims[lv + 1], lv + 1 < L
        y = torch.empty(r, cout, device=dev)
        part = torch.empty(tiles, 2 * cout, device=dev) if more else None
        _gemm(cnt, "dense", False, dev, x=x, xidx=xidx, ldx=dims[lv],
              tr=_TR["bn_act"],
              **_bn_args(g, bt, stats[lv][0], invs[lv], cfg.act),
              w=_w(w), bias=_w(bias), y=y, part=part, R=r, K=dims[lv],
              N=cout, ep=_EP["fwd"], stats=int(more))
        if more:
            statistics(part, cout)
        vals.append(y)
        x, xidx = y, None
    msg, cl, lg = x, dims[L], None
    if cfg.attend:
        wa0, ba0, ga, bta, wa1, ba1 = _att(cfg, params)
        a = cfg.att_dim
        gv = torch.empty(r, a, device=dev)
        part = torch.empty(tiles, 2 * a, device=dev)
        _gemm(cnt, "dense", False, dev, x=msg, ldx=cl, tr=_TR["none"],
              w=_w(wa0), bias=_w(ba0), y=gv, part=part, R=r, K=cl, N=a,
              ep=_EP["fwd"], stats=1)
        statistics(part, a)
        lg = torch.empty(r, cl, device=dev)
        _gemm(cnt, "dense", False, dev, x=gv, ldx=a, tr=_TR["bn_act"],
              **_bn_args(ga, bta, stats[L][0], invs[L], cfg.attend_act),
              w=_w(wa1), bias=_w(ba1), y=lg, R=r, K=a, N=cl, ep=_EP["fwd"])
        vals += [gv, lg]
    out = torch.empty((b, m, cl), device=dev)
    mx = torch.empty((b, m, cl), device=dev) if cfg.attend else out
    aux = torch.empty((b, m, cl), device=dev)
    _launch(cnt, "aggregate", "ccn_gt_aggregate", _dptr(msg), _dptr(lg),
            _dptr(start), b * m, cl, k, int(cfg.attend), _dptr(out),
            _dptr(mx), _dptr(aux), stream)
    n = torch.full((), n_rows, device=dev)
    return out, stats, n, (rows, qry, out, mx, aux, *vals, *invs)


def group_train_bwd(h1, mask, cfg: TrainCfg, params, stats, n, extras,
                    dout):
    """Kernel K7's backward for CUDA tensors (``extras`` from
    :func:`group_train_fwd`), the plain version for CPU tensors.  Returns
    what :func:`group_train_bwd_ref` returns."""
    if h1.device.type == "cpu":
        return group_train_bwd_ref(h1, mask, cfg, params, stats, n, extras,
                                   dout)
    return _kernel_bwd(h1, mask, cfg, params, stats, extras, dout)


def _kernel_bwd(h1, mask, cfg, params, stats, extras, dout):
    h1, mask = _check_inputs(h1, mask, cfg)
    _label(h1, cfg)
    c0 = h1.shape[-1]
    dev, L, dims = h1.device, cfg.n_loc, cfg.dims
    rows, qry, out, mx, aux = extras[:5]
    vals = extras[5:5 + L + 2 * cfg.attend]
    invs = extras[5 + L + 2 * cfg.attend:]
    r = rows.numel()
    n_rows = float(max(r, 1))
    tiles = max(1, -(-r // TILE))
    cnt = group_train_bwd
    dout = dout.float().contiguous()
    v = [h1] + list(vals[:L])          # v_0 through the row index
    grads = [None] * cfg.n_params
    per_query = dict(qry=qry, qd=dout, qmx=mx, qaux=aux, qout=out)

    def dgrad(x, tr, save, w, cout, cin, ex, exidx, bn_e, act, **kw):
        """T (rows, cin) = (T(x) @ w^T) * act'(y) of the level below, and
        its BN backward's sums -> (T, (gamma, beta) grads, coef)."""
        t = torch.empty(r, cin, device=dev)
        part = torch.empty(tiles, 2 * cin, device=dev)
        _gemm(cnt, "dgrad", False, dev, x=x, ldx=cout, tr=_TR[tr],
              asave=save, w=w.detach().t().contiguous(), y=t, part=part,
              R=r, K=cout, N=cin, ep=_EP["dgrad"], stats=1, ex=ex,
              exidx=exidx, ldex=cin, emu=bn_e["mu"], einv=bn_e["inv"],
              egam=bn_e["gam"], ebet=bn_e["bet"], eact=_ACT_CODES[act], **kw)
        sums, coef = _finalize(cnt, dev, part, cin, True, 2, n_rows,
                               gam=bn_e["gam"], inv=bn_e["inv"])
        return t, [sums[cin:], sums[:cin]], coef

    if cfg.attend:
        wa0, ba0, ga, bta, wa1, ba1 = _att(cfg, params)
        a, cl = cfg.att_dim, dims[L]
        gv, lg = vals[L], vals[L + 1]
        bn_a = _bn_args(ga, bta, stats[L][0], invs[L], cfg.attend_act)
        dl = torch.empty(r, cl, device=dev)
        ta, g_a, coef_a = dgrad(lg, "dlogit", dl, wa1, cl, a, gv, None, bn_a,
                                cfg.attend_act, x2=v[L], **per_query)
        dwa1, dba1 = _kernel_wgrad(cnt, dev, gv, dl, a, cl, r, tr="bn_act",
                                   **bn_a)
        dg1 = torch.empty(r, a, device=dev)
        dv = torch.empty(r, cl, device=dev)
        _gemm(cnt, "dgrad", False, dev, x=ta, x2=gv, ldx=a, tr=_TR["bnb"],
              mu=bn_a["mu"], inv=bn_a["inv"], c0=coef_a[0], c1=coef_a[1],
              c2=coef_a[2], asave=dg1, w=wa0.detach().t().contiguous(),
              y=dv, R=r, K=a, N=cl, ep=_EP["att"], elg=lg, **per_query)
        dwa0, dba0 = _kernel_wgrad(cnt, dev, v[L], dg1, cl, a, r)
        grads[4 * L:4 * L + 6] = [dwa0, dba0, *g_a, dwa1, dba1]
        d_in, tr, kw = dv, "none", {}
    else:
        d_in, tr, kw = v[L], "maxb", per_query
    for lv in reversed(range(L)):
        g, bt, w, _ = _local(cfg, params, lv)
        cin, cout = dims[lv], dims[lv + 1]
        bn_l = _bn_args(g, bt, stats[lv][0], invs[lv], cfg.act)
        save = None if tr == "none" else torch.empty(r, cout, device=dev)
        xe, xidx = (h1, rows) if lv == 0 else (v[lv], None)
        t, g_l, coef = dgrad(d_in, tr, save, w, cout, cin, xe, xidx, bn_l,
                             cfg.act, **kw)
        dw, db = _kernel_wgrad(cnt, dev, xe, d_in if save is None else save,
                               cin, cout, r, xidx, "bn_act", **bn_l)
        grads[4 * lv:4 * lv + 4] = [*g_l, dw, db]
        d_in, tr = t, "bnb"
        kw = dict(x2=xe, mu=bn_l["mu"], inv=bn_l["inv"], c0=coef[0],
                  c1=coef[1], c2=coef[2])
    # epilogue T_0 -> d_h1: elementwise glue over the live rows
    idx = rows.long()
    xhat0 = (h1.reshape(-1, c0).index_select(0, idx) - stats[0][0]) * invs[0]
    d0 = coef[0] * (d_in - (coef[1] + xhat0 * coef[2]))
    d_h1 = torch.zeros_like(h1)
    d_h1.view(-1, c0).index_copy_(0, idx, d0)
    return d_h1, tuple(grads)


group_train_fwd.launches = 0
group_train_bwd.launches = 0


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
