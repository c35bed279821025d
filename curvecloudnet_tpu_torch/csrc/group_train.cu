// K7: grouped message MLP + masked aggregation in TRAIN mode, forward and
// backward, with exact masked BatchNorm batch statistics.
//
// Replaces curvecloudnet_tpu/ops/pallas_group_train.py: the passes of
// _pass_stats (_stats_kernel), _pass_out (_out_kernel), _pass_b_att
// (_b_att_kernel), _pass_b_msg (_b_msg_kernel) and _pass_b_mid
// (_b_mid_kernel), all reaching pl.pallas_call through _call.
// ops/group_train.py sequences the kernels below; notation as there, per
// (plane, query) row:
//     v_0 = h1;  u_i = act(BN_i(v_i));  v_{i+1} = u_i @ W_i + b_i
//     msg = v_L;  attend: g = msg @ Wa0 + ba0;  logits = act_a(BN_a(g)) @ Wa1 + ba1
//
// Bound on the H100: the multiply-adds of the dense layers and of their
// two backward products on the live rows -- at the FP32 rate (67 TFLOP/s)
// the flagship's 15 sites need ~3.4 ms forward and (with the chain
// recomputed, as the plain backward does) ~10 ms backward; 3xTF32 runs
// three TF32 products per multiply-add, a floor of 3x those operations at
// 495 TFLOP/s.  What the design does about it:
//  * Live rows only.  The wrapper compacts the live (plane, query) rows of
//    a call once, in the forward, query-major (a query's live planes in
//    plane order, queries in order): the aggregation then reads each
//    query's rows as one contiguous run, and the k-major h1 is gathered by
//    a row index.  Rows of a dead slot are never loaded or multiplied: by
//    the contract of ops/group_train.py their cotangents are exactly 0, and
//    queries with no live slot (whose outputs every consumer masks, so that
//    their dout is 0) get the max fill -100 under max and 0 under attend.
//  * Store, do not recompute.  Each dense runs once: the forward stores
//    v_1..v_L (and g, logits under attend) of the live rows, and the
//    backward reads them.  The max backward finds its argmax by equality
//    with the stored values.
//  * Every product is one tiled GEMM over the row list: gt_gemm takes
//    64-row x 64-column output tiles over a 32-deep inner stage in 3xTF32
//    mma.sync m16n8k8 (tf32_mma.cuh), 4 warps of 32 x 32.  Its A operand
//    is rows of a stored array (or of h1 through the row index), with an
//    elementwise transform applied on load (BN + activation, the BN
//    backward, the max or softmax backward) and split into (hi, lo) as it
//    is stored in shared memory; B (a weight matrix, its transpose, or the
//    rows of a cotangent) streams in by cp.async, double-buffered.  The
//    epilogue adds the bias, or multiplies by act'(y), or adds the softmax
//    term, stores, and sums its 64 rows per column (batch statistics, or
//    the BN backward's sum T and sum T * x-hat).  The weight gradient is
//    the same GEMM with the rows as the inner dimension (A transposed in
//    shared memory): a block keeps its 64 x 64 tile of dW in its
//    accumulators over its share of the rows.
//  * No atomics.  Every sum across blocks (statistics, dW, biases, the BN
//    backward's sums) is written as one partial per block and summed in a
//    fixed order by gt_finalize, so gradients repeat bit for bit.
//
// The bfloat16 variant (j.bf16; a model computing in bfloat16, the JAX
// package's cdt = h1's dtype: _dot, _dot_t and _dot_wgrad cast both
// operands to bfloat16 and accumulate in f32) is the same kernels with
// each product one mma.sync m16n8k16 on bfloat16 operands in place of
// three TF32 ones: the A operand (the transformed activations or deltas,
// kept raw f32 in shared memory) and B (the weights, or a cotangent's
// rows) are rounded to bfloat16, to nearest even, as their fragments are
// packed; everything else (transforms, epilogues, statistics, finalize,
// aggregation) stays f32.  h1 is read as bfloat16 (j.xbf, j.exbf;
// gt_rowstats' bfloat16 twin), and the local levels' BN-output cotangents
// T are stored rounded to bfloat16 (j.rnd: the JAX package keeps them in
// h1's dtype between its backward passes) after their sums are taken.

#include "tf32_mma.cuh"

#include <cuda_bf16.h>

#define GT_THREADS 128
#define GT_BM 64   // output rows (weight gradient: input channels) a tile
#define GT_BN 64   // output columns a tile
#define GT_BK 32   // inner depth a stage
#define GT_SA 36   // A stage row stride, [m][k] layout (4 mod 32)
#define GT_SAT 72  // A stage row stride, [k][m] layout (8 mod 32)
#define GT_SB 72   // B stage row stride (8 mod 32)
#define GT_A_WORDS (GT_BM * GT_SA > GT_BK * GT_SAT ? GT_BM * GT_SA : GT_BK * GT_SAT)

// A-operand transforms
enum { TR_NONE = 0, TR_BN_ACT = 1, TR_BNB = 2, TR_MAXB = 3, TR_DLOGIT = 4 };
// epilogues
enum { EP_FWD = 0, EP_DGRAD = 1, EP_ATT = 2 };

struct GJob {
  // A: rows of x (row stride ldx; row r at xidx[r] when xidx is set)
  const float* x;
  const int* xidx;
  const float* x2;  // TR_BNB: the stored v of the level; TR_DLOGIT: msg
  const float *mu, *inv, *gam, *bet;  // BN of the transform (and TR_BNB)
  const float *c0, *c1, *c2;          // TR_BNB: (gamma inv, sum T / n, sum T x-hat / n)
  const int* qry;                     // row -> query (b * M + m)
  const float *qd, *qmx, *qaux, *qout;  // per query: dout, max, den | count, out
  float* asave;                       // the transformed A, (R, K)
  const float* w;                     // B: row-major (K, N), or the rows (R, N)
  const float* bias;
  float* y;                           // output (R, N)
  float* part;                        // per-block partial sums
  // epilogue EP_DGRAD: x-hat and y of the output's level from rows of ex
  const float* ex;
  const int* exidx;
  const float *emu, *einv, *egam, *ebet;
  const float* elg;  // EP_ATT: the logits (R, N)
  int ldx, tr, act, R, K, N, ep, stats, ldex, eact, rps;
  // bfloat16 products; x, ex hold bfloat16 (h1); round the stored y
  int bf16, xbf, exbf, rnd;
};

// f32 of x's element i (x bfloat16 when bf)
__device__ __forceinline__ float elem(const float* x, size_t i, int bf) {
  return bf ? load_f32(reinterpret_cast<const __nv_bfloat16*>(x) + i)
            : __ldg(x + i);
}

// y rounded to bfloat16 (nearest even) and back
__device__ __forceinline__ float bf16_round(float y) {
  return __bfloat162float(__float2bfloat16_rn(y));
}

__device__ __forceinline__ float dact_fn(float y, int kind) {
  if (kind == 0) return y > 0.f ? 1.f : 0.f;
  if (kind == 1) return y > 0.f ? 1.f : 0.01f;
  return 1.f;
}

// BN as the plain version rounds it, x-hat = (v - mu) * inv and
// y = x-hat * gamma + beta, each op rounded once: the explicit intrinsics
// keep the compiler from contracting some call sites into FMAs and not
// others, so the forward's activation and the backward's act' and x-hat
// see the same y
__device__ __forceinline__ float bn_xhat(float v, float mu, float inv) {
  return __fmul_rn(__fsub_rn(v, mu), inv);
}

__device__ __forceinline__ float bn_y(float xh, float g, float b) {
  return __fadd_rn(__fmul_rn(xh, g), b);
}

__device__ __forceinline__ float transform(const GJob& j, float x, float x2,
                                           int r, int c) {
  switch (j.tr) {
    case TR_NONE:
      return x;
    case TR_BN_ACT:
      return act_fn(bn_y(bn_xhat(x, j.mu[c], j.inv[c]), j.gam[c], j.bet[c]),
                    j.act);
    case TR_BNB: {  // gamma inv (t - (sum t / n + x-hat sum t x-hat / n))
      const float xh = bn_xhat(x2, j.mu[c], j.inv[c]);
      return __fmul_rn(j.c0[c],
                       __fsub_rn(x, __fadd_rn(j.c1[c], __fmul_rn(xh, j.c2[c]))));
    }
    case TR_MAXB: {  // dout at the query's argmax, shared among its ties
      const size_t o = (size_t)j.qry[r] * j.ldx + c;
      return x == j.qmx[o] ? __fdiv_rn(j.qd[o], fmaxf(j.qaux[o], 1.f)) : 0.f;
    }
    default: {  // TR_DLOGIT: softmax weight w (msg - out) dout
      const size_t o = (size_t)j.qry[r] * j.ldx + c;
      const float w = __fdiv_rn(expf(x - j.qmx[o]), j.qaux[o]);
      return __fmul_rn(__fmul_rn(w, __fsub_rn(x2, j.qout[o])), j.qd[o]);
    }
  }
}

// Raw A values of one stage in registers, 4 float4 a thread (and x2's,
// where the transform reads it): non-WG rows m0.. (64) x columns k0..
// (32) of x; WG rows k0.. (32, bounded by rend) x columns m0.. (64).
// row[i] is -1 past the rows.
struct ATile {
  float v[4][4], v2[4][4];
  int row[4], col[4];
};

template <bool WG>
__device__ __forceinline__ void load_a(const GJob& j, ATile& a, int m0,
                                       int k0, int rend) {
  const bool two = j.tr == TR_BNB || j.tr == TR_DLOGIT;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = threadIdx.x + GT_THREADS * i;
    const int tr = WG ? f >> 4 : f >> 3;
    const int tc = WG ? (f & 15) * 4 : (f & 7) * 4;
    const int r = WG ? k0 + tr : m0 + tr;
    const int c = WG ? m0 + tc : k0 + tc;
    const int ncol = j.K;  // WG: K is the channel count of x
    a.row[i] = r < rend ? r : -1;
    a.col[i] = c;
#pragma unroll
    for (int e = 0; e < 4; ++e) a.v[i][e] = a.v2[i][e] = 0.f;
    if (r >= rend) continue;
    const size_t base = (size_t)(j.xidx ? j.xidx[r] : r) * j.ldx;
    const size_t al = reinterpret_cast<size_t>(j.x);
    if ((j.ldx & 3) == 0 && (al & (j.xbf ? 7 : 15)) == 0 && c + 3 < ncol) {
      const float4 q =
          j.xbf ? load4_f32(reinterpret_cast<const __nv_bfloat16*>(j.x) +
                            base + c)
                : load4_f32(j.x + base + c);
      a.v[i][0] = q.x; a.v[i][1] = q.y; a.v[i][2] = q.z; a.v[i][3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < ncol) a.v[i][e] = elem(j.x, base + c + e, j.xbf);
    }
    if (two) {  // x2 has x's layout, never gathered
      const float* p2 = j.x2 + (size_t)r * j.ldx + c;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < ncol) a.v2[i][e] = __ldg(p2 + e);
    }
  }
}

// Transform, (non-WG, column tile 0) save, split and store a loaded tile
// (BF: stored raw into hi, rounded to bfloat16 as mma_stage packs it).
template <bool WG, bool BF>
__device__ __forceinline__ void store_a(const GJob& j, const ATile& a,
                                        uint32_t* hi, uint32_t* lo,
                                        bool save) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = threadIdx.x + GT_THREADS * i;
    const int tr = WG ? f >> 4 : f >> 3;
    const int tc = WG ? (f & 15) * 4 : (f & 7) * 4;
    float t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = a.col[i] + e;
      t[e] = (a.row[i] >= 0 && c < j.K)
                 ? transform(j, a.v[i][e], a.v2[i][e], a.row[i], c)
                 : 0.f;
    }
    if (save && a.row[i] >= 0) {
      float* d = j.asave + (size_t)a.row[i] * j.K + a.col[i];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (a.col[i] + e < j.K) d[e] = t[e];
    }
    const int o = WG ? tr * GT_SAT + tc : tr * GT_SA + tc;
    if constexpr (BF) {
      *reinterpret_cast<float4*>(hi + o) = make_float4(t[0], t[1], t[2], t[3]);
      continue;
    }
    uint4 h, l;
    h.x = tf32_rna(t[0]); h.y = tf32_rna(t[1]);
    h.z = tf32_rna(t[2]); h.w = tf32_rna(t[3]);
    l.x = tf32_lo(t[0], h.x); l.y = tf32_lo(t[1], h.y);
    l.z = tf32_lo(t[2], h.z); l.w = tf32_lo(t[3], h.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// One stage's products: acc[i][jn] (rows wm*32 + i*16.., columns
// wn*32 + jn*8..) += A (hi, lo) x B (split here), 3xTF32; BF: A (raw f32
// in Ahi) and B rounded to bfloat16 as they are packed, one m16n8k16
// product a 16-deep step.
template <bool WG, bool BF>
__device__ __forceinline__ void mma_stage(const uint32_t* Ahi,
                                          const uint32_t* Alo, const float* Bs,
                                          float (&acc)[2][4][4], int wm,
                                          int wn, int g, int t) {
  if constexpr (BF) {
    const float* A = reinterpret_cast<const float*>(Ahi);
#pragma unroll
    for (int kk = 0; kk < GT_BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // row m (+8 for odd e), k (+8 e >= 2)
          const int m = wm * 32 + i * 16 + g + (e & 1) * 8;
          const int k = kk + 2 * t + (e >> 1) * 8;
          a[i][e] = WG ? pack_bf16(A[k * GT_SAT + m], A[(k + 1) * GT_SAT + m])
                       : pack_bf16(A[m * GT_SA + k], A[m * GT_SA + k + 1]);
        }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const float* b = Bs + (kk + 2 * t) * GT_SB + wn * 32 + jn * 8 + g;
        const uint32_t b0 = pack_bf16(b[0], b[GT_SB]);
        const uint32_t b1 = pack_bf16(b[8 * GT_SB], b[9 * GT_SB]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][jn], a[i], b0, b1);
      }
    }
    return;
  }
#pragma unroll
  for (int kk = 0; kk < GT_BK; kk += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = wm * 32 + i * 16 + g;
      int o[4];
      if (WG) {
        o[0] = (kk + t) * GT_SAT + m;
        o[1] = o[0] + 8;
        o[2] = o[0] + 4 * GT_SAT;
        o[3] = o[2] + 8;
      } else {
        o[0] = m * GT_SA + kk + t;
        o[1] = o[0] + 8 * GT_SA;
        o[2] = o[0] + 4;
        o[3] = o[1] + 4;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[i][e] = Ahi[o[e]];
        al[i][e] = Alo[o[e]];
      }
    }
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const float* b = Bs + (kk + t) * GT_SB + wn * 32 + jn * 8 + g;
      const float w0 = b[0], w1 = b[4 * GT_SB];
      const uint32_t bh0 = tf32_rna(w0), bh1 = tf32_rna(w1);
      const uint32_t bl0 = tf32_lo(w0, bh0), bl1 = tf32_lo(w1, bh1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_tf32(acc[i][jn], al[i], bh0, bh1);
        mma_tf32(acc[i][jn], ah[i], bl0, bl1);
        mma_tf32(acc[i][jn], ah[i], bh0, bh1);
      }
    }
  }
}

__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// The non-WG epilogue: value, store, and the per-column sums of this
// tile's rows (fixed order: a thread's rows, then the g lanes, then the
// two row warps) into part (gridDim.x, 2N) when j.stats.
__device__ __forceinline__ void epilogue(const GJob& j,
                                         const float (&acc)[2][4][4],
                                         float* red, int m0, int n0,
                                         int ncols, int wm, int wn, int g,
                                         int t) {
  const int tid = threadIdx.x;
  float sa[4][2], sb[4][2];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
    sa[jn][0] = sa[jn][1] = sb[jn][0] = sb[jn][1] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (r >= j.R) continue;
      const int q = j.ep == EP_ATT ? j.qry[r] : 0;
      const size_t erow = j.ep == EP_DGRAD
          ? (size_t)(j.exidx ? j.exidx[r] : r) * j.ldex : 0;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int n = n0 + wn * 32 + jn * 8 + 2 * t + p;
          if (n >= j.N) continue;
          const float a = acc[i][jn][2 * h + p];
          float v, u = 0.f;
          if (j.ep == EP_FWD) {
            v = __fadd_rn(a, j.bias[n]);
            u = __fmul_rn(v, v);
          } else if (j.ep == EP_DGRAD) {
            const float xh =
                bn_xhat(elem(j.ex, erow + n, j.exbf), j.emu[n], j.einv[n]);
            v = __fmul_rn(a, dact_fn(bn_y(xh, j.egam[n], j.ebet[n]), j.eact));
            u = __fmul_rn(v, xh);
          } else {  // EP_ATT: msg's cotangent w dout + dg1 @ Wa0^T
            const size_t o = (size_t)q * j.N + n;
            const float w = __fdiv_rn(
                expf(j.elg[(size_t)r * j.N + n] - j.qmx[o]), j.qaux[o]);
            v = __fadd_rn(__fmul_rn(w, j.qd[o]), a);
          }
          j.y[(size_t)r * j.N + n] = j.rnd ? bf16_round(v) : v;
          sa[jn][p] += v;
          sb[jn][p] += u;
        }
    }
  if (!j.stats) return;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      sa[jn][p] = sum_over_g(sa[jn][p]);
      sb[jn][p] = sum_over_g(sb[jn][p]);
    }
  if (g == 0) {
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = wn * 32 + jn * 8 + 2 * t + p;
        red[wm * 64 + c] = sa[jn][p];
        red[128 + wm * 64 + c] = sb[jn][p];
      }
  }
  __syncthreads();
  if (tid < ncols) {
    float* pr = j.part + (size_t)blockIdx.x * 2 * j.N;
    pr[n0 + tid] = red[tid] + red[64 + tid];
    pr[j.N + n0 + tid] = red[128 + tid] + red[192 + tid];
  }
}

// Non-WG: y (R, N) = T(A) (R, K) @ B (K, N), epilogue j.ep, per-block
// column sums into part (gridDim.x, 2N) when j.stats.  WG: part
// (gridDim.z, K + 1, N) = per row split, T(A)^T (K, rows) @ B (rows, N)
// and, in blocks of the first channel tile, row K: the column sums of B.
template <bool WG, bool BF>
__global__ void __launch_bounds__(GT_THREADS)
    gt_gemm(const GJob j) {
  extern __shared__ float4 sm4[];
  uint32_t* Ahi = reinterpret_cast<uint32_t*>(sm4);  // 2 stages each
  uint32_t* Alo = Ahi + 2 * GT_A_WORDS;
  float* Bs = reinterpret_cast<float*>(Alo + 2 * GT_A_WORDS);
  float* red = Bs + 2 * GT_BK * GT_SB;  // 4 x 64
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * GT_BM, n0 = blockIdx.y * GT_BN;
  // the inner range: K channels, or this split's rows
  const int kbeg = WG ? blockIdx.z * j.rps : 0;
  const int kend = WG ? min(j.R, kbeg + j.rps) : j.K;
  const int nst = max(0, (kend - kbeg + GT_BK - 1) / GT_BK);
  const int ncols = min(GT_BN, j.N - n0);
  const WLayer B = {j.w + n0, kend, ncols, j.N,
                    (j.N & 3) == 0 && (reinterpret_cast<size_t>(j.w) & 15) == 0};
  const bool save = !WG && j.asave != nullptr && blockIdx.y == 0;
  const bool dbsum = WG && blockIdx.x == 0;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.f;
  float db = 0.f;

  ATile at;
  if (nst > 0) {
    stage_w(Bs, GT_SB, B, kbeg, GT_BK);
    cp_async_commit();
    load_a<WG>(j, at, m0, kbeg, WG ? kend : j.R);
    store_a<WG, BF>(j, at, Ahi, Alo, save);
  }
  for (int s = 0; s < nst; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    cp_async_wait<0>();
    __syncthreads();
    const bool more = s + 1 < nst;
    if (more) {
      stage_w(Bs + nxt * GT_BK * GT_SB, GT_SB, B, kbeg + (s + 1) * GT_BK,
              GT_BK);
      cp_async_commit();
      load_a<WG>(j, at, m0, kbeg + (s + 1) * GT_BK, WG ? kend : j.R);
    }
    const float* bs = Bs + cur * GT_BK * GT_SB;
    if (dbsum && (tid & 63) < ncols) {
      const int half = tid >> 6;
      for (int r = 0; r < 16; ++r) db += bs[(half * 16 + r) * GT_SB + (tid & 63)];
    }
    mma_stage<WG, BF>(Ahi + cur * GT_A_WORDS, Alo + cur * GT_A_WORDS, bs,
                      acc, wm, wn, g, t);
    if (more)
      store_a<WG, BF>(j, at, Ahi + nxt * GT_A_WORDS, Alo + nxt * GT_A_WORDS,
                      save);
  }

  if constexpr (WG) {
    const size_t zb = (size_t)blockIdx.z * (j.K + 1) * j.N;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (m >= j.K) continue;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int n = n0 + wn * 32 + jn * 8 + 2 * t + p;
            if (n < j.N) j.part[zb + (size_t)m * j.N + n] = acc[i][jn][2 * h + p];
          }
      }
    if (dbsum) {
      __syncthreads();
      red[tid] = db;
      __syncthreads();
      if (tid < ncols)
        j.part[zb + (size_t)j.K * j.N + n0 + tid] = red[tid] + red[64 + tid];
    }
  } else {
    epilogue(j, acc, red, m0, n0, ncols, wm, wn, g, t);
  }
}

// Masked sums (v, v * v) of the rows of x (through idx) per 64-row tile:
// part (gridDim.x, 2C), the statistics of the first BN; x float or
// bfloat16 (T).
template <class T>
__global__ void gt_rowstats(const T* __restrict__ x,
                            const int* __restrict__ idx, int ldx, int R, int C,
                            float* __restrict__ part) {
  const int r0 = blockIdx.x * GT_BM, r1 = min(R, r0 + GT_BM);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f, ss = 0.f;
    for (int r = r0; r < r1; ++r) {
      const float v = load_f32(x + (size_t)idx[r] * ldx + c);
      s += v;
      ss += __fmul_rn(v, v);
    }
    part[(size_t)blockIdx.x * 2 * C + c] = s;
    part[(size_t)blockIdx.x * 2 * C + C + c] = ss;
  }
}

// out[c] = sum over p of part[p, c] in a fixed order (8 strided lanes,
// then the lanes in order), for c < ncol, and with pair also
// out[ncol + c] from part[p, ncol + c].  mode 1 (statistics; pair):
// aux = (mean, var, rsqrt(var + eps)) of the sums (s, ss) over n rows;
// mode 2 (BN backward; pair): aux = (gamma inv, sum T / n, sum T x-hat / n).
__global__ void __launch_bounds__(256)
    gt_finalize(const float* __restrict__ part, int P, long long ld,
                long long ncol, int pair, float* __restrict__ out, int mode,
                float n, float eps, const float* __restrict__ gam,
                const float* __restrict__ inv, float* aux0, float* aux1,
                float* aux2) {
  __shared__ float sa[8][32], sb[8][32];
  const int lane = threadIdx.x >> 5, cl = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * 32 + cl;
  float a = 0.f, b = 0.f;
  if (c < ncol)
    for (int p = lane; p < P; p += 8) {
      a += part[p * ld + c];
      if (pair) b += part[p * ld + ncol + c];
    }
  sa[lane][cl] = a;
  sb[lane][cl] = b;
  __syncthreads();
  if (lane != 0 || c >= ncol) return;
  a = b = 0.f;
  for (int l = 0; l < 8; ++l) {
    a += sa[l][cl];
    b += sb[l][cl];
  }
  out[c] = a;
  if (pair) out[ncol + c] = b;
  if (mode == 1) {
    const float mu = __fdiv_rn(a, n);
    const float var =
        fmaxf(__fsub_rn(__fdiv_rn(b, n), __fmul_rn(mu, mu)), 0.f);
    aux0[c] = mu;
    aux1[c] = var;
    aux2[c] = rsqrtf(__fadd_rn(var, eps));
  } else if (mode == 2) {
    aux0[c] = __fmul_rn(gam[c], inv[c]);
    aux1[c] = __fdiv_rn(a, n);
    aux2[c] = __fdiv_rn(b, n);
  }
}

// The masked aggregation of each query's run of rows [start[q],
// start[q+1]) in v (R, C) (query-major): max with the fill -100 where the
// query has a dead slot (aux: the count of slots at the max, dead slots
// included); attend with the softmax over the rows' logits lg (aux: the
// denominator, mx: the largest logit; a query with no live slot: out 0).
__global__ void gt_aggregate(const float* __restrict__ v,
                             const float* __restrict__ lg,
                             const int* __restrict__ start, int Q, int C,
                             int K, int attend, float* __restrict__ out,
                             float* __restrict__ mx, float* __restrict__ aux) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)Q * C) return;
  const int q = (int)(i / C), c = (int)(i - (long long)q * C);
  const int s = start[q], e = start[q + 1], dead = K - (e - s);
  if (!attend) {
    float m = dead > 0 ? -100.f : -__int_as_float(0x7f800000);
    for (int r = s; r < e; ++r) m = fmaxf(m, v[(size_t)r * C + c]);
    float cnt = dead > 0 && m == -100.f ? (float)dead : 0.f;
    for (int r = s; r < e; ++r) cnt += v[(size_t)r * C + c] == m ? 1.f : 0.f;
    out[i] = m;
    aux[i] = cnt;
    return;
  }
  if (e == s) {
    out[i] = 0.f;
    mx[i] = -500.f;
    aux[i] = 1.f;
    return;
  }
  float m = -__int_as_float(0x7f800000);
  for (int r = s; r < e; ++r) m = fmaxf(m, lg[(size_t)r * C + c]);
  float den = 0.f, acc = 0.f;
  for (int r = s; r < e; ++r) {
    const float w = expf(lg[(size_t)r * C + c] - m);
    den += w;
    acc += w * v[(size_t)r * C + c];
  }
  out[i] = acc / den;
  mx[i] = m;
  aux[i] = den;
}

static size_t gemm_smem() {
  return (4 * (size_t)GT_A_WORDS + 2 * GT_BK * GT_SB + 4 * 64) * 4;
}

template <bool WG, bool BF>
static cudaError_t launch_gemm(const GJob& j, int splits, cudaStream_t st) {
  const size_t smem = gemm_smem();
  cudaError_t e = cudaFuncSetAttribute(
      gt_gemm<WG, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int rows = WG ? j.K : j.R;  // WG: the tile's rows are channels
  dim3 grid(max(1, (rows + GT_BM - 1) / GT_BM), (j.N + GT_BN - 1) / GT_BN,
            WG ? splits : 1);
  gt_gemm<WG, BF><<<grid, GT_THREADS, smem, st>>>(j);
  return cudaGetLastError();
}

// One product over the row list.  ptrs: device pointers in the order of
// ops/group_train._GEMM_PTRS; ints: ldx, tr, act, R, K, N, ep, stats,
// ldex, eact, rps, bf16, xbf, exbf, rnd.  wg = 1: the weight gradient,
// splits row splits of rps rows.  Outputs (y, part, asave) need no
// zeroing.
extern "C" int ccn_gt_gemm(int wg, void* const* ptrs, const int* ints,
                           int splits, void* stream) {
  GJob j;
  const float** f[] = {&j.x, &j.x2, &j.mu, &j.inv, &j.gam, &j.bet, &j.c0,
                       &j.c1, &j.c2, &j.qd, &j.qmx, &j.qaux, &j.qout, &j.w,
                       &j.bias, &j.ex, &j.emu, &j.einv, &j.egam, &j.ebet,
                       &j.elg};
  const int nf = sizeof(f) / sizeof(f[0]);
  for (int i = 0; i < nf; ++i) *f[i] = (const float*)ptrs[i];
  j.xidx = (const int*)ptrs[nf];
  j.qry = (const int*)ptrs[nf + 1];
  j.exidx = (const int*)ptrs[nf + 2];
  j.asave = (float*)ptrs[nf + 3];
  j.y = (float*)ptrs[nf + 4];
  j.part = (float*)ptrs[nf + 5];
  j.ldx = ints[0];
  j.tr = ints[1];
  j.act = ints[2];
  j.R = ints[3];
  j.K = ints[4];
  j.N = ints[5];
  j.ep = ints[6];
  j.stats = ints[7];
  j.ldex = ints[8];
  j.eact = ints[9];
  j.rps = ints[10];
  j.bf16 = ints[11];
  j.xbf = ints[12];
  j.exbf = ints[13];
  j.rnd = ints[14];
  if (j.R < 0 || j.K < 1 || j.N < 1 || j.tr < 0 || j.tr > TR_DLOGIT ||
      (wg && (splits < 1 || j.rps < 1 || j.rps % GT_BK)) ||
      ((j.xbf || j.exbf || j.rnd) && !j.bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (j.bf16)
    return (int)(wg ? launch_gemm<true, true>(j, splits, st)
                    : launch_gemm<false, true>(j, 1, st));
  return (int)(wg ? launch_gemm<true, false>(j, splits, st)
                  : launch_gemm<false, false>(j, 1, st));
}

extern "C" int ccn_gt_rowstats(const float* x, const int* idx, int ldx, int R,
                               int C, float* part, void* stream) {
  const int tiles = R > 0 ? (R + GT_BM - 1) / GT_BM : 1;
  gt_rowstats<<<tiles, 256, 0, (cudaStream_t)stream>>>(x, idx, ldx, R, C,
                                                       part);
  return (int)cudaGetLastError();
}

// x (rows of ldx) bfloat16; the rest as ccn_gt_rowstats
extern "C" int ccn_gt_rowstats_bf16(const __nv_bfloat16* x, const int* idx,
                                    int ldx, int R, int C, float* part,
                                    void* stream) {
  const int tiles = R > 0 ? (R + GT_BM - 1) / GT_BM : 1;
  gt_rowstats<<<tiles, 256, 0, (cudaStream_t)stream>>>(x, idx, ldx, R, C,
                                                       part);
  return (int)cudaGetLastError();
}

extern "C" int ccn_gt_finalize(const float* part, int P, long long ld,
                               long long ncol, int pair, float* out, int mode,
                               float n, float eps, const float* gam,
                               const float* inv, float* aux0, float* aux1,
                               float* aux2, void* stream) {
  if (P < 1 || ncol < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (ncol + 31) / 32;
  gt_finalize<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      part, P, ld, ncol, pair, out, mode, n, eps, gam, inv, aux0, aux1, aux2);
  return (int)cudaGetLastError();
}

extern "C" int ccn_gt_aggregate(const float* v, const float* lg,
                                const int* start, int Q, int C, int K,
                                int attend, float* out, float* mx, float* aux,
                                void* stream) {
  const long long n = (long long)Q * C;
  if (n < 1) return (int)cudaErrorInvalidValue;
  gt_aggregate<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      v, lg, start, Q, C, K, attend, out, mx, aux);
  return (int)cudaGetLastError();
}
