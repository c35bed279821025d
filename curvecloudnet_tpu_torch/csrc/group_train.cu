// K7: grouped message MLP + masked aggregation in TRAIN mode, forward and
// backward, with exact masked BatchNorm batch statistics.
//
// Replaces curvecloudnet_tpu/ops/pallas_group_train.py: the passes of
// _pass_stats (_stats_kernel), _pass_out (_out_kernel), _pass_b_att
// (_b_att_kernel), _pass_b_msg (_b_msg_kernel) and _pass_b_mid
// (_b_mid_kernel), all reaching pl.pallas_call through _call.  One C entry
// runs one pass; ops/group_train.py sequences them and finishes the tiny
// per-channel reductions between passes.
//
// Rows are (plane k, query m) pairs of the k-major slab h1 (B, K, M, C0);
// the mask is query-major (B, M, K).  Per row (notation of the .py):
//     v_0 = h1;  u_i = act(BN_i(v_i));  v_{i+1} = u_i @ W_i + b_i
//     msg = v_L;  attend: g = msg @ Wa0 + ba0;  logits = act_a(BN_a(g)) @ Wa1 + ba1
// A "sequence" index s names v_s (s <= L), g (s = L+1), logits (s = L+2).
//
// Design: one block per tile of TM queries of one batch row loops over the
// K planes; each plane's chain is recomputed from h1 in shared memory
// (K2's design), so no per-pair activation but h1 and the backward's
// cotangent slabs T ever reaches device memory.  The row buffers of the
// chain live in NS shared slots of TM x cmax floats, sequence value s in
// slot s % NS; a dense reads its input pre-BN and applies BN + activation
// as it loads (so the pre-BN values, which the backward needs for x-hat
// and act', stay).  Each thread computes 4x4 output micro-tiles (K2's
// dense_tile).  Weight gradients are 4x4 micro-tiles summed over the
// tile's TM rows and added with f32 atomicAdd (one add per weight per
// block-plane); per-channel sums (batch statistics, bias gradients, the BN
// backward's sum T and sum T*x-hat) likewise.  Atomics make the sums' order
// vary from run to run, within f32 rounding.
//
// Two things keep the work near what the data needs: a plane where no
// query of the tile has a live slot is skipped (the flagship's sa-geo
// windows hold ~3.6 live slots of 25, per curve, so most of a curve tile's
// planes are empty); and every pass but the out pass, whose outputs are
// sums or per-plane slabs, splits the planes over several blocks per tile,
// so the 519- and 1728-query sites still fill the card.
//
// Bound on the H100: FP32 FMAs of the recomputed chains (each pass
// recomputes the chain to its depth: the forward ~L+2 chains, the backward
// ~2L+3 dense-sized products) and the weight-gradient atomics.  No tensor
// cores yet (FP32 FMA, so results stay within f32 rounding of the plain
// version).

#include <cuda_runtime.h>

#define GT_MAXL 8
#define GT_THREADS 256

struct GT {
  int L, A, attend, act, aact, cmax, B, K, M;
  int dims[GT_MAXL + 1];
  // packed-constant offsets, per local level: mu, inv, gamma, beta, W, W^T, b
  long long mu[GT_MAXL], inv[GT_MAXL], gam[GT_MAXL], bet[GT_MAXL];
  long long w[GT_MAXL], wt[GT_MAXL], b[GT_MAXL];
  // attention: Wa0, Wa0^T, ba0, mu_a, inv_a, gamma_a, beta_a, Wa1, Wa1^T, ba1
  long long wa0, wa0t, ba0, mua, inva, gama, beta, wa1, wa1t, ba1;
};

struct Ptrs {
  const float* h1;
  const unsigned char* mask;
  const float* cst;
  const float* dout;
  const float* out_in;  // attend: the forward's output (B, M, CL)
  float* mx;            // out pass: running max out; backward: in
  float* den;           // attend: denominator; max: tie count
  const float* tin;     // b_mid: T slab of the level
  const float* coef;    // (ginv, cg, cp) of the BN whose backward runs here
  float* tout;          // T slab of the level below
  float *dw, *db, *dw2, *db2, *rs, *rp, *s, *ss;
  float* out;           // out pass: (B, M, CL)
};

// BN + activation applied as a dense loads its input; mu == nullptr: none
struct Xf {
  const float *mu, *inv, *g, *b;
  int act;
};

__device__ __forceinline__ float act_fn(float v, int kind) {
  if (kind == 0) return fmaxf(v, 0.f);            // relu
  if (kind == 1) return v > 0.f ? v : 0.01f * v;  // leaky_relu
  return v;                                       // identity
}

__device__ __forceinline__ float dact_fn(float y, int kind) {
  if (kind == 0) return y > 0.f ? 1.f : 0.f;
  if (kind == 1) return y > 0.f ? 1.f : 0.01f;
  return 1.f;
}

// BN as the plain version rounds it, x-hat = (v - mu) * inv and
// y = x-hat * gamma + beta, each op rounded once: the explicit intrinsics
// keep the compiler from contracting some call sites into FMAs and not
// others, so every pass recomputes bit-identical chain values (a max
// aggregation's backward finds its argmax by equality with the forward's)
__device__ __forceinline__ float bn_xhat(float v, float mu, float inv) {
  return __fmul_rn(__fsub_rn(v, mu), inv);
}

__device__ __forceinline__ float bn_y(float xh, float g, float b) {
  return __fadd_rn(__fmul_rn(xh, g), b);
}

__device__ __forceinline__ float xf_apply(const Xf& x, float v, int c) {
  if (x.mu == nullptr) return v;
  return act_fn(bn_y(bn_xhat(v, x.mu[c], x.inv[c]), x.g[c], x.b[c]), x.act);
}

__device__ __forceinline__ int seq_width(const GT& g, int s) {
  return s <= g.L ? g.dims[s] : (s == g.L + 1 ? g.A : g.dims[g.L]);
}

// the transform of the dense leaving sequence value s
__device__ __forceinline__ Xf seq_xf(const GT& g, const float* cst, int s) {
  Xf x;
  if (s < g.L) {
    x.mu = cst + g.mu[s];
    x.inv = cst + g.inv[s];
    x.g = cst + g.gam[s];
    x.b = cst + g.bet[s];
    x.act = g.act;
  } else if (s == g.L + 1) {
    x.mu = cst + g.mua;
    x.inv = cst + g.inva;
    x.g = cst + g.gama;
    x.b = cst + g.beta;
    x.act = g.aact;
  } else {
    x.mu = x.inv = x.g = x.b = nullptr;
    x.act = 2;
  }
  return x;
}

// out (TM, cout) = xf(in (TM, cin)) @ W (cin, cout) (+ bias), row-major
// tiles in shared memory; 4x4 micro-tiles per thread.
template <int TM>
__device__ void dense_tile(const float* in, int cin, float* outp, int cout,
                           const float* __restrict__ W,
                           const float* __restrict__ bias, const Xf xf) {
  const int ncg = (cout + 3) >> 2;
  const int items = (TM / 4) * ncg;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int rg = it / ncg, cg = it - rg * ncg;
    const int r0 = rg * 4, c0 = cg * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float* in0 = in + r0 * cin;
    for (int ci = 0; ci < cin; ++ci) {
      const float* wrow = W + (size_t)ci * cout + c0;
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = (c0 + j < cout) ? wrow[j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = xf_apply(xf, in0[i * cin + ci], ci);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j >= cout) continue;
      const float bb = bias ? bias[c0 + j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        outp[(r0 + i) * cout + c0 + j] = __fadd_rn(acc[i][j], bb);
    }
  }
  __syncthreads();
}

// dW (cin, cout) += xf(A (TM, cin))^T @ D (TM, cout), atomically
template <int TM>
__device__ void wgrad_tile(const float* A, int cin, const Xf xf,
                           const float* D, int cout, float* dW) {
  const int ncg = (cout + 3) >> 2;
  const int items = ((cin + 3) >> 2) * ncg;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int ig = it / ncg, cg = it - ig * ncg;
    const int i0 = ig * 4, c0 = cg * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // the 4 columns' BN affine, hoisted out of the row loop
    float bm[4], bi[4], bg[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = min(i0 + i, cin - 1);
      bm[i] = xf.mu ? xf.mu[c] : 0.f;
      bi[i] = xf.mu ? xf.inv[c] : 1.f;
      bg[i] = xf.mu ? xf.g[c] : 1.f;
      bb[i] = xf.mu ? xf.b[c] : 0.f;
    }
    for (int r = 0; r < TM; ++r) {
      float a[4], d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = A[r * cin + min(i0 + i, cin - 1)];
        a[i] = i0 + i >= cin ? 0.f
               : xf.mu ? act_fn(bn_y(bn_xhat(v, bm[i], bi[i]), bg[i], bb[i]),
                                xf.act)
                       : v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = (c0 + j < cout) ? D[r * cout + c0 + j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i0 + i >= cin) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < cout) atomicAdd(dW + (size_t)(i0 + i) * cout + c0 + j, acc[i][j]);
    }
  }
}

// dst[c] += sum over the TM rows of D (TM, C)
template <int TM>
__device__ void colsum_add(const float* D, int C, float* dst) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += D[r * C + c];
    atomicAdd(dst + c, s);
  }
}

template <int TM>
struct Tile {
  float* sm;      // NS slots of TM * cmax
  float* mcol;    // (TM,) 0/1 mask column of the plane
  int NS, b, m0, k;
  int k0, k1;     // the block's share of the planes (all but the out pass)
  __device__ float* slot(const GT& g, int s) const {
    return sm + (size_t)(s % NS) * TM * g.cmax;
  }
};

// load plane t.k's mask column; returns (block-uniformly) whether any of
// the tile's queries has a live slot there.  A plane with none is skipped
// by every pass: its rows add nothing to any sum (their mask, their
// cotangents and, for attend, their softmax weights are exactly 0).
template <int TM>
__device__ bool plane_mask(const GT& g, const Ptrs& p, const Tile<TM>& t) {
  int live = 0;
  for (int r = threadIdx.x; r < TM; r += blockDim.x) {
    const int m = t.m0 + r;
    const bool on = m < g.M && p.mask[((size_t)t.b * g.M + m) * g.K + t.k];
    t.mcol[r] = on ? 1.f : 0.f;
    live |= on;
  }
  return __syncthreads_or(live);
}

// write zeros into the T slab rows of a skipped plane
template <int TM>
__device__ void zero_tout(const GT& g, const Ptrs& p, const Tile<TM>& t,
                          int C) {
  for (int i = threadIdx.x; i < TM * C; i += blockDim.x) {
    const int r = i / C, m = t.m0 + r;
    if (m < g.M)
      p.tout[(((size_t)t.b * g.K + t.k) * g.M + m) * C + i - r * C] = 0.f;
  }
}

// load plane t.k of h1 (after plane_mask), then run the chain to sequence
// value `target`
template <int TM>
__device__ void chain(const GT& g, const Ptrs& p, const Tile<TM>& t,
                      int target) {
  const int c0 = g.dims[0];
  float* v0 = t.slot(g, 0);
  const float* hk = p.h1 + ((size_t)t.b * g.K + t.k) * (size_t)g.M * c0;
  for (int i = threadIdx.x; i < TM * c0; i += blockDim.x) {
    const int r = i / c0, c = i - r * c0;
    const int m = t.m0 + r;
    v0[i] = m < g.M ? hk[(size_t)m * c0 + c] : 0.f;
  }
  __syncthreads();
  for (int s = 0; s < target; ++s) {
    const float *W, *bias;
    if (s < g.L) {
      W = p.cst + g.w[s];
      bias = p.cst + g.b[s];
    } else if (s == g.L) {
      W = p.cst + g.wa0;
      bias = p.cst + g.ba0;
    } else {
      W = p.cst + g.wa1;
      bias = p.cst + g.ba1;
    }
    dense_tile<TM>(t.slot(g, s), seq_width(g, s), t.slot(g, s + 1),
                   seq_width(g, s + 1), W, bias, seq_xf(g, p.cst, s));
  }
}

// index of (b, m, c) in a (B, M, C) array
__device__ __forceinline__ size_t bmc(const GT& g, int b, int m, int c, int C) {
  return ((size_t)b * g.M + m) * C + c;
}

// the backward of one local level li (its dense W_li and BN_li), given the
// cotangent D (TM, C_{li+1}) of v_{li+1} in shared memory and v_li in slot
// `vs`: dW_li, db_li, the T slab of level li, sum T and sum T * x-hat
template <int TM>
__device__ void level_tail(const GT& g, const Ptrs& p, const Tile<TM>& t,
                           int li, const float* D, int vs, int xs) {
  const int cin = g.dims[li], cout = g.dims[li + 1];
  const float* V = t.slot(g, vs);
  const Xf xf = seq_xf(g, p.cst, li);
  wgrad_tile<TM>(V, cin, xf, D, cout, p.dw);
  colsum_add<TM>(D, cout, p.db);
  float* X = t.slot(g, xs);
  const Xf none = {nullptr, nullptr, nullptr, nullptr, 2};
  dense_tile<TM>(D, cout, X, cin, p.cst + g.wt[li], nullptr, none);
  for (int c = threadIdx.x; c < cin; c += blockDim.x) {
    float rs = 0.f, rp = 0.f;
    for (int r = 0; r < TM; ++r) {
      const float xh = bn_xhat(V[r * cin + c], xf.mu[c], xf.inv[c]);
      const float y = bn_y(xh, xf.g[c], xf.b[c]);
      const float tv = X[r * cin + c] * dact_fn(y, g.act) * t.mcol[r];
      const int m = t.m0 + r;
      if (m < g.M)
        p.tout[(((size_t)t.b * g.K + t.k) * g.M + m) * cin + c] = tv;
      rs += tv;
      rp += tv * xh;
    }
    atomicAdd(p.rs + c, rs);
    atomicAdd(p.rp + c, rp);
  }
  __syncthreads();
}

// pass 0: masked sums (s, ss) of sequence value `depth`
template <int TM>
__device__ void pass_stats(const GT& g, const Ptrs& p, Tile<TM>& t, int depth,
                           float* acc) {
  const int C = seq_width(g, depth);
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) acc[c] = 0.f;
  for (int k = t.k0; k < t.k1; ++k) {
    t.k = k;
    if (!plane_mask<TM>(g, p, t)) continue;
    chain<TM>(g, p, t, depth);
    const float* V = t.slot(g, depth);
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float s = 0.f, ss = 0.f;
      for (int r = 0; r < TM; ++r) {
        const float v = V[r * C + c];
        const float vm = v * t.mcol[r];
        s += vm;
        ss += vm * v;
      }
      acc[c] += s;
      acc[C + c] += ss;
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    atomicAdd(p.s + c, acc[c]);
    atomicAdd(p.ss + c, acc[C + c]);
  }
}

// pass 1: the chain and the online masked aggregation over the planes
template <int TM>
__device__ void pass_out(const GT& g, const Ptrs& p, Tile<TM>& t, float* RM,
                         float* DEN, float* ACC) {
  const int CL = g.dims[g.L];
  for (int i = threadIdx.x; i < TM * CL; i += blockDim.x) {
    RM[i] = -1e30f;
    DEN[i] = 0.f;
    if (g.attend) ACC[i] = 0.f;
  }
  const int target = g.attend ? g.L + 2 : g.L;
  // attend visits the planes with a live slot first; a plane with none
  // is then an exact no-op for every row that has met a live slot (its
  // logit -500 is at least ~150 below the running max, so exp underflows
  // to 0), and is run only for a row that has met none
  for (int sweep = 0; sweep < (g.attend ? 2 : 1); ++sweep)
  for (int k = 0; k < g.K; ++k) {
    t.k = k;
    const bool live = plane_mask<TM>(g, p, t);
    if (!live && !g.attend) {   // max: the fill -100 competes, analytically
      for (int i = threadIdx.x; i < TM * CL; i += blockDim.x) {
        DEN[i] = -100.f > RM[i] ? 1.f : DEN[i] + (RM[i] == -100.f ? 1.f : 0.f);
        RM[i] = fmaxf(RM[i], -100.f);
      }
      continue;
    }
    if (g.attend && live != (sweep == 0)) continue;
    if (!live) {
      int need = 0;
      for (int i = threadIdx.x; i < TM * CL; i += blockDim.x)
        need |= t.m0 + i / CL < g.M && RM[i] <= -350.f;
      if (!__syncthreads_or(need)) continue;
    }
    chain<TM>(g, p, t, target);
    const float* MSG = t.slot(g, g.L);
    const float* LG = t.slot(g, target);
    for (int i = threadIdx.x; i < TM * CL; i += blockDim.x) {
      const float mk = t.mcol[i / CL];
      if (g.attend) {
        const float l = mk > 0.f ? LG[i] : -500.f;
        const float nm = fmaxf(RM[i], l);
        const float sc = expf(RM[i] - nm);
        const float e = expf(l - nm);
        DEN[i] = DEN[i] * sc + e;
        ACC[i] = ACC[i] * sc + e * MSG[i];
        RM[i] = nm;
      } else {
        const float hit = mk > 0.f ? MSG[i] : -100.f;
        DEN[i] = hit > RM[i] ? 1.f : DEN[i] + (hit == RM[i] ? 1.f : 0.f);
        RM[i] = fmaxf(RM[i], hit);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < TM * CL; i += blockDim.x) {
    const int r = i / CL, c = i - r * CL, m = t.m0 + r;
    if (m >= g.M) continue;
    const size_t o = bmc(g, t.b, m, c, CL);
    if (g.attend) {
      p.out[o] = ACC[i] / DEN[i];
      p.mx[o] = RM[i];
    } else {
      p.out[o] = RM[i];
    }
    p.den[o] = DEN[i];
  }
}

// pass 2 (attend): dWa1, dba1 and the BN_a sums, no slab
template <int TM>
__device__ void pass_b_att(const GT& g, const Ptrs& p, Tile<TM>& t) {
  const int L = g.L, CL = g.dims[L], A = g.A;
  for (int k = t.k0; k < t.k1; ++k) {
    t.k = k;
    if (!plane_mask<TM>(g, p, t)) continue;
    chain<TM>(g, p, t, L + 2);
    const float* MSG = t.slot(g, L);
    const float* G = t.slot(g, L + 1);
    float* LG = t.slot(g, L + 2);
    float* X = t.slot(g, L + 3);
    for (int i = threadIdx.x; i < TM * CL; i += blockDim.x) {
      const int r = i / CL, c = i - r * CL, m = t.m0 + r;
      float dl = 0.f;
      if (m < g.M) {
        const size_t o = bmc(g, t.b, m, c, CL);
        const float mk = t.mcol[r];
        const float l = mk > 0.f ? LG[i] : -500.f;
        const float w = expf(l - p.mx[o]) / p.den[o];
        dl = w * (MSG[i] - p.out_in[o]) * p.dout[o] * mk;
      }
      LG[i] = dl;
    }
    __syncthreads();
    const Xf xa = seq_xf(g, p.cst, L + 1);
    wgrad_tile<TM>(G, A, xa, LG, CL, p.dw);
    colsum_add<TM>(LG, CL, p.db);
    const Xf none = {nullptr, nullptr, nullptr, nullptr, 2};
    dense_tile<TM>(LG, CL, X, A, p.cst + g.wa1t, nullptr, none);
    for (int c = threadIdx.x; c < A; c += blockDim.x) {
      float rs = 0.f, rp = 0.f;
      for (int r = 0; r < TM; ++r) {
        const float xh = bn_xhat(G[r * A + c], xa.mu[c], xa.inv[c]);
        const float y = bn_y(xh, xa.g[c], xa.b[c]);
        const float ta = X[r * A + c] * dact_fn(y, g.aact) * t.mcol[r];
        rs += ta;
        rp += ta * xh;
      }
      atomicAdd(p.rs + c, rs);
      atomicAdd(p.rp + c, rp);
    }
    __syncthreads();
  }
}

// pass 3: the aggregation's backward + the last local level
template <int TM>
__device__ void pass_b_msg(const GT& g, const Ptrs& p, Tile<TM>& t) {
  const int L = g.L, CL = g.dims[L], A = g.A;
  for (int k = t.k0; k < t.k1; ++k) {
    t.k = k;
    if (!plane_mask<TM>(g, p, t)) {
      zero_tout<TM>(g, p, t, g.dims[L - 1]);
      continue;
    }
    chain<TM>(g, p, t, g.attend ? L + 2 : L);
    float* MSG = t.slot(g, L);
    float* D;
    if (g.attend) {
      const float* G = t.slot(g, L + 1);
      float* LG = t.slot(g, L + 2);
      float* X = t.slot(g, L + 3);
      float* WD = t.slot(g, L + 4);
      for (int i = threadIdx.x; i < TM * CL; i += blockDim.x) {
        const int r = i / CL, c = i - r * CL, m = t.m0 + r;
        float wd = 0.f, dl = 0.f;
        if (m < g.M) {
          const size_t o = bmc(g, t.b, m, c, CL);
          const float mk = t.mcol[r];
          const float l = mk > 0.f ? LG[i] : -500.f;
          const float w = expf(l - p.mx[o]) / p.den[o];
          wd = w * p.dout[o];
          dl = w * (MSG[i] - p.out_in[o]) * p.dout[o] * mk;
        }
        WD[i] = wd;
        LG[i] = dl;
      }
      __syncthreads();
      const Xf none = {nullptr, nullptr, nullptr, nullptr, 2};
      dense_tile<TM>(LG, CL, X, A, p.cst + g.wa1t, nullptr, none);
      const Xf xa = seq_xf(g, p.cst, L + 1);
      const float *ginv = p.coef, *cg = p.coef + A, *cp = p.coef + 2 * A;
      for (int c = threadIdx.x; c < A; c += blockDim.x) {
        for (int r = 0; r < TM; ++r) {
          const float mk = t.mcol[r];
          const float xh = bn_xhat(G[r * A + c], xa.mu[c], xa.inv[c]);
          const float y = bn_y(xh, xa.g[c], xa.b[c]);
          const float ta = X[r * A + c] * dact_fn(y, g.aact) * mk;
          X[r * A + c] = ginv[c] * (ta - mk * (cg[c] + xh * cp[c]));
        }
      }
      __syncthreads();
      wgrad_tile<TM>(MSG, CL, none, X, A, p.dw2);
      colsum_add<TM>(X, A, p.db2);
      dense_tile<TM>(X, A, LG, CL, p.cst + g.wa0t, nullptr, none);
      for (int i = threadIdx.x; i < TM * CL; i += blockDim.x) LG[i] += WD[i];
      __syncthreads();
      D = LG;
    } else {
      for (int i = threadIdx.x; i < TM * CL; i += blockDim.x) {
        const int r = i / CL, c = i - r * CL, m = t.m0 + r;
        float dm = 0.f;
        if (m < g.M) {
          const size_t o = bmc(g, t.b, m, c, CL);
          const float mk = t.mcol[r];
          const float hit = mk > 0.f ? MSG[i] : -100.f;
          const float eq = hit == p.mx[o] ? 1.f : 0.f;
          dm = p.dout[o] * eq * mk / fmaxf(p.den[o], 1.f);
        }
        MSG[i] = dm;
      }
      __syncthreads();
      D = MSG;
    }
    level_tail<TM>(g, p, t, L - 1, D, L - 1, g.attend ? L + 3 : L + 1);
  }
}

// pass 4: level `lv`'s BN backward from its T slab, then level lv-1
template <int TM>
__device__ void pass_b_mid(const GT& g, const Ptrs& p, Tile<TM>& t, int lv) {
  const int C = g.dims[lv];
  const float *ginv = p.coef, *cg = p.coef + C, *cp = p.coef + 2 * C;
  const float *mu = p.cst + g.mu[lv], *inv = p.cst + g.inv[lv];
  for (int k = t.k0; k < t.k1; ++k) {
    t.k = k;
    if (!plane_mask<TM>(g, p, t)) {
      zero_tout<TM>(g, p, t, g.dims[lv - 1]);
      continue;
    }
    chain<TM>(g, p, t, lv);
    float* V = t.slot(g, lv);
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      for (int r = 0; r < TM; ++r) {
        const int m = t.m0 + r;
        const float tin =
            m < g.M ? p.tin[(((size_t)t.b * g.K + k) * g.M + m) * C + c] : 0.f;
        const float xh = bn_xhat(V[r * C + c], mu[c], inv[c]);
        V[r * C + c] = ginv[c] * (tin - t.mcol[r] * (cg[c] + xh * cp[c]));
      }
    }
    __syncthreads();
    level_tail<TM>(g, p, t, lv - 1, V, lv - 1, lv + 1);
  }
}

template <int TM>
__global__ void __launch_bounds__(GT_THREADS)
group_train_kernel(GT g, Ptrs p, int pass, int level, int NS, int kper) {
  extern __shared__ float sm[];
  Tile<TM> t;
  t.sm = sm;
  t.NS = NS;
  t.mcol = sm + (size_t)NS * TM * g.cmax;
  t.b = blockIdx.y;
  t.m0 = blockIdx.x * TM;
  t.k = 0;
  t.k0 = blockIdx.z * kper;
  t.k1 = min(g.K, t.k0 + kper);
  float* extra = t.mcol + TM;
  const int CL = g.dims[g.L];
  switch (pass) {
    case 0: pass_stats<TM>(g, p, t, level, extra); break;
    case 1:
      pass_out<TM>(g, p, t, extra, extra + TM * CL, extra + 2 * TM * CL);
      break;
    case 2: pass_b_att<TM>(g, p, t); break;
    case 3: pass_b_msg<TM>(g, p, t); break;
    default: pass_b_mid<TM>(g, p, t, level); break;
  }
}

// shared-memory row buffers each pass keeps live (ops/group_train._slots)
static int pass_slots(int pass, int attend) {
  switch (pass) {
    case 0: return 2;
    case 1: return attend ? 3 : 2;
    case 2: return 4;
    case 3: return attend ? 6 : 3;
    default: return 3;
  }
}

template <int TM>
static cudaError_t launch(const GT& g, const Ptrs& p, int pass, int level,
                          int splits, cudaStream_t st) {
  const int NS = pass_slots(pass, g.attend);
  size_t floats = (size_t)NS * TM * g.cmax + TM;
  if (pass == 0) floats += 2 * (size_t)g.cmax;
  if (pass == 1) floats += (g.attend ? 3 : 2) * (size_t)TM * g.dims[g.L];
  const size_t smem = floats * sizeof(float);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      group_train_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int kper = (g.K + splits - 1) / splits;
  dim3 grid((g.M + TM - 1) / TM, g.B, (g.K + kper - 1) / kper);
  group_train_kernel<TM><<<grid, GT_THREADS, smem, st>>>(g, p, pass, level,
                                                          NS, kper);
  return cudaGetLastError();
}

// pass: 0 stats (level = sequence depth), 1 out, 2 b_att, 3 b_msg, 4 b_mid
// (level = the BN level whose T slab arrives).  dims (L+1,) host; offs host
// offsets into the packed constants (7 per local level, then 10 for the
// attention MLP: see ops/group_train._pack).  ptrs: GT_NPTR device
// pointers in the order of ops/group_train._PTR_SLOTS (h1, mask, cst, dout,
// out, mx, den, tin, coef, tout, dw, db, dw2, db2, rs, rp, s, ss).
// Accumulated outputs (dw, db, dw2, db2, rs, rp, s, ss) must be zeroed.
// splits > 1 splits the K planes over that many blocks per query tile
// (every pass but the out pass, whose outputs are sums or per-plane).
extern "C" int ccn_group_train(int pass, int level, int L, const int* dims,
                               int A, int attend, int act, int attend_act,
                               const long long* offs, int B, int K, int M,
                               int tm, int splits, void* const* ptrs,
                               void* stream) {
  if (L < 1 || L > GT_MAXL || pass < 0 || pass > 4 || B < 1 || K < 1 ||
      M < 1 || (attend && A < 1) || splits < 1 || splits > K ||
      (pass == 1 && splits != 1))
    return (int)cudaErrorInvalidValue;
  GT g;
  g.L = L;
  g.A = attend ? A : 0;
  g.attend = attend;
  g.act = act;
  g.aact = attend_act;
  g.B = B;
  g.K = K;
  g.M = M;
  g.cmax = attend ? A : 1;
  for (int i = 0; i <= L; ++i) {
    g.dims[i] = dims[i];
    if (dims[i] > g.cmax) g.cmax = dims[i];
  }
  for (int i = 0; i < L; ++i) {
    const long long* o = offs + 7 * i;
    g.mu[i] = o[0];
    g.inv[i] = o[1];
    g.gam[i] = o[2];
    g.bet[i] = o[3];
    g.w[i] = o[4];
    g.wt[i] = o[5];
    g.b[i] = o[6];
  }
  const long long* o = offs + 7 * L;
  g.wa0 = o[0];
  g.wa0t = o[1];
  g.ba0 = o[2];
  g.mua = o[3];
  g.inva = o[4];
  g.gama = o[5];
  g.beta = o[6];
  g.wa1 = o[7];
  g.wa1t = o[8];
  g.ba1 = o[9];
  Ptrs p;
  p.h1 = (const float*)ptrs[0];
  p.mask = (const unsigned char*)ptrs[1];
  p.cst = (const float*)ptrs[2];
  p.dout = (const float*)ptrs[3];
  p.out = (float*)ptrs[4];
  p.out_in = (const float*)ptrs[4];
  p.mx = (float*)ptrs[5];
  p.den = (float*)ptrs[6];
  p.tin = (const float*)ptrs[7];
  p.coef = (const float*)ptrs[8];
  p.tout = (float*)ptrs[9];
  p.dw = (float*)ptrs[10];
  p.db = (float*)ptrs[11];
  p.dw2 = (float*)ptrs[12];
  p.db2 = (float*)ptrs[13];
  p.rs = (float*)ptrs[14];
  p.rp = (float*)ptrs[15];
  p.s = (float*)ptrs[16];
  p.ss = (float*)ptrs[17];
  cudaStream_t st = (cudaStream_t)stream;
  switch (tm) {
    case 4: return (int)launch<4>(g, p, pass, level, splits, st);
    case 8: return (int)launch<8>(g, p, pass, level, splits, st);
    case 16: return (int)launch<16>(g, p, pass, level, splits, st);
    case 32: return (int)launch<32>(g, p, pass, level, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}
