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
through the batch mean and variance.  Pass plan, as in the JAX package:

    forward:  S_0..S_{L-1}, S_a (masked sums per BN), then P_out (the
              aggregation; writes the backward's residuals: running logit
              max and denominator for attend, the tie count for max);
    backward: B_att (attend head), B_msg (aggregation + last dense), then
              B_mid(l) for l = L-1..1, each writing the k-major cotangent
              slab T of the level below; the elementwise epilogue T_0 ->
              d_h1 stays plain PyTorch glue, as the JAX package leaves it
              to XLA.

The CUDA kernels are ``csrc/group_train.cu`` (one C entry, a pass code);
:func:`group_train_fwd_ref` and :func:`group_train_bwd_ref` compute the same
passes in plain PyTorch over the whole slab.  The wrappers
:func:`group_train_fwd` / :func:`group_train_bwd` run the plain versions for
CPU tensors and the kernels for CUDA tensors; :class:`_GroupTrain` is the
``torch.autograd.Function`` around them.

Layouts: h1 (B, K, M, C0) k-major, mask (B, M, K) bool query-major with its
columns in h1's plane order.  Rows of fully masked queries carry junk
values and junk gradients, as in the JAX package; every consumer masks
them by row validity.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from .aggregate import ATTEND_FILL, MAX_FILL

_ACT_CODES = {"relu": 0, "leaky_relu": 1, "identity": 2}
_PASSES = {"stats": 0, "out": 1, "b_att": 2, "b_msg": 3, "b_mid": 4}
# the device-pointer slots of ccn_group_train, in its order (see csrc)
_PTR_SLOTS = ("h1", "mask", "cst", "dout", "out", "mx", "den", "tin", "coef",
              "tout", "dw", "db", "dw2", "db2", "rs", "rp", "s", "ss")


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
    one = torch.ones_like(y)
    if kind == "relu":
        return torch.where(y > 0, one, torch.zeros_like(y))
    if kind == "leaky_relu":
        return torch.where(y > 0, one, torch.full_like(y, 0.01))
    if kind == "identity":
        return one
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
    batch statistics are computed on the way (the forward); returns the
    kept values and the statistics [(mean, var)] (attend last)."""
    keep = {"xhat": [], "y": []}
    new_stats = []
    v = h1
    for i in range(cfg.n_loc):
        g, bt, w, b = _local(cfg, params, i)
        mv = _masked_stats(v, mk, n) if stats is None else stats[i]
        new_stats.append(mv)
        xhat, y = _bn(v, *mv, g, bt, cfg.eps)
        keep["xhat"].append(xhat)
        keep["y"].append(y)
        v = _act(y, cfg.act) @ w + b
    keep["msg"] = v
    if cfg.attend:
        wa0, ba0, ga, bta, wa1, ba1 = _att(cfg, params)
        gv = v @ wa0 + ba0
        mv = _masked_stats(gv, mk, n) if stats is None else stats[cfg.n_loc]
        new_stats.append(mv)
        keep["a_xhat"], keep["a_y"] = _bn(gv, *mv, ga, bta, cfg.eps)
        keep["logits"] = _act(keep["a_y"], cfg.attend_act) @ wa1 + ba1
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
        out, mx, den = extras
        wa0, ba0, ga, bta, wa1, ba1 = _att(cfg, params)
        lg = torch.where(mk > 0, keep["logits"],
                         torch.full_like(msg, ATTEND_FILL))
        w = torch.exp(lg - mx[:, None]) / den[:, None]
        dlogit = w * (msg - out[:, None]) * d * mk
        a_y, a_xhat = keep["a_y"], keep["a_xhat"]
        ta = (dlogit @ wa1.t()) * _dact(a_y, cfg.attend_act) * mk
        rsa, rpa = _colsum(ta), _colsum(ta * a_xhat)
        inva = torch.rsqrt(stats[cfg.n_loc][1] + cfg.eps)
        dg1 = ga * inva * (ta - mk * (rsa / n + a_xhat * (rpa / n)))
        k = 4 * cfg.n_loc
        grads[k:k + 6] = [_wgrad(msg, dg1), _colsum(dg1), rpa, rsa,
                          _wgrad(_act(a_y, cfg.attend_act), dlogit),
                          _colsum(dlogit)]
        dv = w * d + dg1 @ wa0.t()
    else:
        mx, cnt = extras
        hit = torch.where(mk > 0, msg, torch.full_like(msg, MAX_FILL))
        eq = (hit == mx[:, None]).to(h1.dtype)
        dv = d * eq * mk / torch.clamp(cnt, min=1.0)[:, None]
    for li in reversed(range(cfg.n_loc)):
        g, _, w_l, _ = _local(cfg, params, li)
        xhat, y = keep["xhat"][li], keep["y"][li]
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


def _pack(cfg, params, stats=None):
    """Packed f32 constants + host offsets in the C order: per local level
    (mu, inv, gamma, beta, W, W^T, b), then for attend (Wa_0, Wa_0^T, ba_0,
    mu_a, inv_a, gamma_a, beta_a, Wa_1, Wa_1^T, ba_1).  Statistics not yet
    known are zeros (the stats passes fill them in: see ``_set_stats``)."""
    parts, offs, off = [], [], 0

    def add(t):
        nonlocal off
        parts.append(t.detach().reshape(-1).float())
        offs.append(off)
        off += t.numel()

    def mu_inv(i, c, like):
        if stats is None:
            return torch.zeros(c, device=like.device), torch.ones(
                c, device=like.device)
        mu, var = stats[i]
        return mu, torch.rsqrt(var + cfg.eps)

    for i in range(cfg.n_loc):
        g, bt, w, b = _local(cfg, params, i)
        for t in (*mu_inv(i, cfg.dims[i], g), g, bt, w, w.t(), b):
            add(t)
    if cfg.attend:
        wa0, ba0, ga, bta, wa1, ba1 = _att(cfg, params)
        for t in (wa0, wa0.t(), ba0, *mu_inv(cfg.n_loc, cfg.att_dim, ga),
                  ga, bta, wa1, wa1.t(), ba1):
            add(t)
    else:
        offs += [0] * 10
    return torch.cat(parts).contiguous(), offs


def _set_stats(cst, offs, cfg, level, mu, var):
    """Write a finished BN's (mu, inv) into the packed constants."""
    base = 7 * level if level < cfg.n_loc else 7 * cfg.n_loc + 3
    c = mu.numel()
    cst[offs[base]:offs[base] + c] = mu
    cst[offs[base + 1]:offs[base + 1] + c] = torch.rsqrt(var + cfg.eps)


def _slots(pass_: str, cfg) -> int:
    """Shared-memory row buffers a pass keeps live (csrc/group_train.cu)."""
    return {"stats": 2, "out": 3 if cfg.attend else 2,
            "b_att": 4, "b_msg": 6 if cfg.attend else 3, "b_mid": 3}[pass_]


def _smem_bytes(pass_: str, cfg, tm: int) -> int:
    cmax = max(cfg.dims + ((cfg.att_dim,) if cfg.attend else ()))
    floats = _slots(pass_, cfg) * tm * cmax + tm
    if pass_ == "stats":
        floats += 2 * cmax
    elif pass_ == "out":
        floats += (3 if cfg.attend else 2) * tm * cfg.dims[-1]
    return 4 * floats


# blocks worth aiming at: two per SM of the H100's 132
_TARGET_BLOCKS = 264


def _pick_launch(pass_: str, cfg, b: int, k: int, m: int):
    """(query tile, plane splits).  Every pass but the out pass splits the
    K planes over several blocks per tile (its outputs are sums or
    per-plane), so it takes the largest tile that fits shared memory (a
    weight gradient takes one atomic add per tile and plane) and splits
    the planes until the card holds ~2 blocks per SM.  The out pass, which
    aggregates over all planes in one block and adds no weight gradient,
    takes the largest tile that still fills the 132 SMs, else the
    smallest."""
    fits = [tm for tm in (32, 16, 8, 4)
            if _smem_bytes(pass_, cfg, tm) <= _build.MAX_SMEM]
    if not fits:
        raise ValueError(f"group train kernel: widths {cfg.dims} too wide")
    tiles = lambda tm: b * -(-m // tm)  # noqa: E731
    if pass_ != "out":
        tm = fits[0]
        return tm, max(1, min(k, -(-_TARGET_BLOCKS // tiles(tm))))
    for tm in fits:
        if tiles(tm) >= 132:
            return tm, 1
    return fits[-1], 1


def _launch(counter, pass_: str, level: int, cfg, h1, mask, cst, offs,
            **ptrs):
    b, k, m, _ = h1.shape
    tm, splits = _pick_launch(pass_, cfg, b, k, m)
    ptrs.update(h1=h1, mask=mask, cst=cst)
    arr = (ctypes.c_void_p * len(_PTR_SLOTS))(*[
        _build.ptr(ptrs[s], torch.bool if s == "mask" else torch.float32, s)
        if s in ptrs else None for s in _PTR_SLOTS])
    dims = cfg.dims
    rc = _build.library().ccn_group_train(
        _PASSES[pass_], level, cfg.n_loc,
        _build.host_array(ctypes.c_int, dims), cfg.att_dim, int(cfg.attend),
        _ACT_CODES[cfg.act], _ACT_CODES[cfg.attend_act],
        _build.host_array(ctypes.c_longlong, offs), b, k, m, tm, splits, arr,
        _build.stream_ptr(h1.device))
    _build.check(rc, f"ccn_group_train({pass_})")
    counter.launches += 1


def _check_inputs(h1, mask, cfg):
    b, k, m, c0 = h1.shape
    if h1.dtype != torch.float32 or c0 != cfg.dims[0]:
        raise ValueError(f"group train kernel: h1 {tuple(h1.shape)} "
                         f"{h1.dtype}, want f32 width {cfg.dims[0]}")
    if tuple(mask.shape) != (b, m, k):
        raise ValueError(f"group train kernel: mask {tuple(mask.shape)}")
    if cfg.n_loc < 1 or cfg.n_loc > 8 or cfg.aggr not in ("max", "attend"):
        raise ValueError(f"group train kernel: {cfg}")
    return h1.contiguous(), mask.contiguous()


def group_train_fwd(h1, mask, cfg: TrainCfg, params):
    """Kernel K7's forward passes for CUDA tensors, the plain version for
    CPU tensors.  Returns what :func:`group_train_fwd_ref` returns."""
    if h1.device.type == "cpu":
        return group_train_fwd_ref(h1, mask, cfg, params)
    h1, mask = _check_inputs(h1, mask, cfg)
    b, k, m, _ = h1.shape
    dev = h1.device
    cst, offs = _pack(cfg, params)
    n = torch.clamp(mask.sum().float(), min=1.0)
    stats = []
    for level in range(cfg.n_bns):
        depth = level if level < cfg.n_loc else cfg.n_loc + 1
        c = cfg.dims[level] if level < cfg.n_loc else cfg.att_dim
        s = torch.zeros(c, device=dev)
        ss = torch.zeros(c, device=dev)
        _launch(group_train_fwd, "stats", depth, cfg, h1, mask, cst, offs,
                s=s, ss=ss)
        mu = s / n
        var = torch.clamp(ss / n - mu * mu, min=0.0)
        stats.append((mu, var))
        _set_stats(cst, offs, cfg, level, mu, var)
    co = cfg.dims[-1]
    out = torch.empty((b, m, co), device=dev)
    dc = torch.empty((b, m, co), device=dev)
    if cfg.attend:
        mx = torch.empty((b, m, co), device=dev)
        _launch(group_train_fwd, "out", 0, cfg, h1, mask, cst, offs,
                out=out, mx=mx, den=dc)
        return out, stats, n, (out, mx, dc)
    _launch(group_train_fwd, "out", 0, cfg, h1, mask, cst, offs,
            out=out, den=dc)
    return out, stats, n, (out, dc)


def group_train_bwd(h1, mask, cfg: TrainCfg, params, stats, n, extras,
                    dout):
    """Kernel K7's backward passes for CUDA tensors, the plain version for
    CPU tensors.  Returns what :func:`group_train_bwd_ref` returns."""
    if h1.device.type == "cpu":
        return group_train_bwd_ref(h1, mask, cfg, params, stats, n, extras,
                                   dout)
    h1, mask = _check_inputs(h1, mask, cfg)
    b, k, m, _ = h1.shape
    dev, L, dims = h1.device, cfg.n_loc, cfg.dims
    cst, offs = _pack(cfg, params, stats)
    dout = dout.float().contiguous()
    zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    grads = [None] * cfg.n_params
    t = torch.empty((b, k, m, dims[L - 1]), device=dev)
    dw, db = zeros(dims[L - 1], dims[L]), zeros(dims[L])
    rs, rp = zeros(dims[L - 1]), zeros(dims[L - 1])
    if cfg.attend:
        out, mx, den = extras
        a = cfg.att_dim
        dwa1, dba1, rsa, rpa = zeros(a, dims[L]), zeros(dims[L]), zeros(a), \
            zeros(a)
        _launch(group_train_bwd, "b_att", 0, cfg, h1, mask, cst, offs,
                dout=dout, out=out, mx=mx, den=den, dw=dwa1, db=dba1,
                rs=rsa, rp=rpa)
        ga = _att(cfg, params)[2].detach()
        inva = torch.rsqrt(stats[L][1] + cfg.eps)
        coef = torch.cat([ga * inva, rsa / n, rpa / n]).contiguous()
        dwa0, dba0 = zeros(dims[L], a), zeros(a)
        _launch(group_train_bwd, "b_msg", 0, cfg, h1, mask, cst, offs,
                dout=dout, out=out, mx=mx, den=den, coef=coef, tout=t,
                dw=dw, db=db, dw2=dwa0, db2=dba0, rs=rs, rp=rp)
        grads[4 * L:4 * L + 6] = [dwa0, dba0, rpa, rsa, dwa1, dba1]
    else:
        mx, cnt = extras
        _launch(group_train_bwd, "b_msg", 0, cfg, h1, mask, cst, offs,
                dout=dout, mx=mx, den=cnt, tout=t, dw=dw, db=db, rs=rs,
                rp=rp)
    grads[4 * (L - 1) + 2:4 * L] = [dw, db]
    for level in range(L - 1, 0, -1):
        grads[4 * level:4 * level + 2] = [rp, rs]
        g = _local(cfg, params, level)[0].detach()
        coef = torch.cat([g * torch.rsqrt(stats[level][1] + cfg.eps),
                          rs / n, rp / n]).contiguous()
        t_in, t = t, torch.empty((b, k, m, dims[level - 1]), device=dev)
        dw, db = zeros(dims[level - 1], dims[level]), zeros(dims[level])
        rs, rp = zeros(dims[level - 1]), zeros(dims[level - 1])
        _launch(group_train_bwd, "b_mid", level, cfg, h1, mask, cst, offs,
                tin=t_in, coef=coef, tout=t, dw=dw, db=db, rs=rs, rp=rp)
        grads[4 * (level - 1) + 2:4 * level] = [dw, db]
    grads[0:2] = [rp, rs]
    # epilogue T_0 -> d_h1: elementwise glue over the k-major slab
    g0 = _local(cfg, params, 0)[0].detach()
    mu0, var0 = stats[0]
    inv0 = torch.rsqrt(var0 + cfg.eps)
    mk = _plane_mask(mask, torch.float32)
    xhat0 = (h1 - mu0) * inv0
    d_h1 = g0 * inv0 * (t - mk * (rs / n + xhat0 * (rp / n)))
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
        raise NotImplementedError("train grouping with a one-layer MLP")
    if aggr == "attend" and (attend_nn is None or len(attend_nn.lins) != 2):
        raise NotImplementedError("attend needs a two-layer attention MLP")
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
