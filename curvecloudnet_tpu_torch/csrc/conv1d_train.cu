// K8: the conv1d-fast-v2 train chain over gap-expanded rows, forward and
// backward, with exact masked BatchNorm batch statistics.
//
// Replaces curvecloudnet_tpu/ops/pallas_conv1d.py: _run_fwd_layer
// (_fwd_layer_kernel, pallas_call at :407), _run_bwd_reduce
// (_bwd_reduce_kernel, :431) and _run_bwd_t (_bwd_t_kernel, :477), which
// conv1d_chain_train's custom VJP drives.  One C entry runs one pass over
// the whole batch; ops/conv1d_train.py sequences them.  Per layer, with
// m(q) = [q < used] and u = 0 outside [0, n_exp):
//     z(q)  = u(q) W_0 + sum_{d=1..h} (u(q-d) + u(q+d)) W_d + b
//     u'(q) = leaky(BN(z(q))) * m(q)
// backward, with dz = inv * (dxh - m * (c1 + xhat * c2)):
//     d_u_prev(q) = dz(q) W_0^T + sum_d (dz(q-d) + dz(q+d)) W_d^T
//     dW_d = sum_p (u(p-d) + u(p+d))^T dz(p)   (u(p)^T dz(p) for d = 0)
//
// Design.  The window products are 3xTF32 tensor-core GEMMs (conv_tc.cuh),
// with the shifts always on the C_out-wide side, so the (possibly wide)
// layer input is read once as a plain operand:
//  * forward: a block takes CV_ROWS slots (a tile of CV_ROWS - 2h and its
//    h-row halo) and multiplies u by the stacked taps [W_0 | ... | W_h],
//    streaming u in 32-deep stages; z = P_0(q) + sum_d (P_d(q-d) + P_d(q+d))
//    + b in the epilogue, then the tile's (count, mean, M2);
//  * t pass, d_u_prev: window(dz) ((h+1) C_out deep, resident in shared
//    memory) times W^T ((h+1) C_out x C_in), in column chunks, so the wide
//    output is written once;
//  * t pass, dW and db: u^T window(dz) with the slots as the inner
//    dimension: for inputs up to 32 channels in the d_u_prev kernel, a
//    partial a tile (12 KB, 5 MB a call for a 32-wide layer); for wider a
//    separate kernel whose blocks each sum a split's stages (a partial a
//    block, ~50 blocks: 5 MB for the 262-wide layer, where partials a
//    tile would take 39 MB).
// The forward and the t pass rebuild the layer input u from the previous
// layer's pre-BN z as they load it (BN affine, leaky, tail mask), so u never
// reaches device memory, as in the Pallas kernels.  What the TPU carries
// across its sequential grid in accumulator outputs (s1, s2; the four
// reduce sums; dW and db) is written here as one partial per block and
// summed by a second kernel in a fixed order: no atomics, so a step's
// gradients do not depend on the order blocks ran (train BatchNorm over the
// flagship's 33 steps amplifies rounding ~1000x).  The statistics combine
// per-block (count, mean, M2) with Chan's formula: the mean and biased
// variance of the two-pass plain version, without the cancellation of the
// JAX kernel's one-pass E[z^2] - mean^2.  The BN affine and the BN backward
// round each operation once (explicit _rn intrinsics), as the plain
// version's elementwise ops do, so the kink decisions y >= 0 of the forward
// and of both backward passes agree with each other and with it (all three
// read the stored z).  The reduce pass is bytes-bound: where the next
// layer's input is at most TDF_MAX wide (the flagship chains' inner layers)
// its sums are taken in that layer's t pass, from the d_u_prev it holds in
// registers and the z_prev it already loads (prev_sums), so they cost no
// pass over device memory and no launch; the standalone reduce kernel runs
// for the chain's last layer and behind wider inputs.
//
// Bound on the H100: the multiply-adds of the window products (the
// flagship's step_31 first layer: 49164 slots x 786 x 32, ~2.5 GFLOP
// forward, twice that in the t pass) and the bytes of the 262-wide input
// row; 3xTF32 runs three TF32 products a multiply-add (a floor of 3x the
// operations at 495 TFLOP/s) to f32 accuracy.

#include <algorithm>

#include <cuda_bf16.h>

#include "conv_tc.cuh"

#define CT_THREADS 256
#define DZ_BATCH 6  // rows of dz whose loads a thread keeps in flight

__device__ __forceinline__ float leaky(float y) {
  return y >= 0.f ? y : __fmul_rn(0.01f, y);
}

__device__ __forceinline__ float dleaky(float y) {
  return y >= 0.f ? 1.f : 0.01f;
}

// y = xhat * gamma + beta with xhat = (z - mean) * inv; bn holds
// (mean, inv, gamma, beta) of C channels
__device__ __forceinline__ float bn_y(float z, const float* bn, int c, int C,
                                      float* xhat) {
  const float xh = __fmul_rn(__fsub_rn(z, bn[c]), bn[C + c]);
  *xhat = xh;
  return __fadd_rn(__fmul_rn(xh, bn[2 * C + c]), bn[3 * C + c]);
}

// per-channel vectors handed over as the caller holds them (no packing
// on the host): a BN's (mean, inv, gamma, beta), then the BN backward's
// (c1, c2); v[0] null for no BN
struct Vecs {
  const float* v[6];
};

// the layer input u at slot g (in [0, n_exp)), channel c, from the value v
// of the previous layer's z there: v itself when bn has no vectors (xe),
// else leaky(BN(v)) * m(g)
__device__ __forceinline__ float u_of(float v, const Vecs& bn, int g, int c,
                                      int live_end) {
  if (bn.v[0] == nullptr) return v;
  const float xh = __fmul_rn(__fsub_rn(v, bn.v[0][c]), bn.v[1][c]);
  const float y = __fadd_rn(__fmul_rn(xh, bn.v[2][c]), bn.v[3][c]);
  return g < live_end ? leaky(y) : 0.f;
}

// u at slot g, channel c of one sample's rows src (C wide); 0 outside
// [0, n_exp)
__device__ __forceinline__ float u_at(const float* src, const Vecs& bn, int g,
                                      int c, int C, int n_exp, int live_end) {
  if (g < 0 || g >= n_exp) return 0.f;
  return u_of(src[(size_t)g * C + c], bn, g, c, live_end);
}

// dz of a live slot's (du, z) at channel c; coef holds (mean, inv, gamma,
// beta, c1, c2)
__device__ __forceinline__ float dz_of(float du, float z, const float* coef,
                                       int c, int C) {
  float xh;
  const float y = bn_y(z, coef, c, C, &xh);
  const float dxh = __fmul_rn(__fmul_rn(du, dleaky(y)), coef[2 * C + c]);
  const float t = __fadd_rn(coef[4 * C + c], __fmul_rn(xh, coef[5 * C + c]));
  return __fmul_rn(coef[C + c], __fsub_rn(dxh, t));
}

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s pairwise combination of (count, mean, M2)
__device__ __forceinline__ Moments chan(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// A forward tile's statistics: its first cnt rows of zt (cout wide, cnt <=
// CV_ROWS) in 8 groups of 16, each group's (count, mean, M2) in two
// passes, then the groups combined in order by Chan's formula into part
// (count, cout means, cout M2s); scratch holds 16 cout floats (may lie
// over anything but zt) and is read after a __syncthreads.
__device__ __forceinline__ void tile_moments(const float* zt, float* scratch,
                                             int cnt, int cout, float* part) {
  float* gm = scratch;  // 8 x cout
  float* gq = scratch + 8 * cout;
  for (int i = threadIdx.x; i < 8 * cout; i += blockDim.x) {
    const int k = i / cout, co = i - k * cout;
    const int r0 = 16 * k, r1 = min(r0 + 16, cnt);
    float s = 0.f;
    for (int r = r0; r < r1; ++r) s += zt[(size_t)r * cout + co];
    const float mean = r1 > r0 ? s / (float)(r1 - r0) : 0.f;
    float m2 = 0.f;
    for (int r = r0; r < r1; ++r) {
      const float d = zt[(size_t)r * cout + co] - mean;
      m2 = fmaf(d, d, m2);
    }
    gm[i] = mean;
    gq[i] = m2;
  }
  __syncthreads();
  for (int co = threadIdx.x; co < cout; co += blockDim.x) {
    Moments acc = {0.f, 0.f, 0.f};
    for (int k = 0; k < 8; ++k)
      acc = chan(acc, {(float)max(0, min(16, cnt - 16 * k)), gm[k * cout + co],
                       gq[k * cout + co]});
    part[1 + co] = acc.mean;
    part[1 + cout + co] = acc.m2;
  }
  if (threadIdx.x == 0) part[0] = (float)cnt;
}

// forward: z of a tile of CV_ROWS - 2h slots and its (count, mean, M2) per
// channel.  The block's CV_ROWS rows are the tile and its h-row halo; the
// product u [W_0 | ... | W_h] streams u (rebuilt from z_prev on load) in
// 32-deep stages; z = P_0(q) + sum_d (P_d(q-d) + P_d(q+d)) + b.
template <int NT>
__global__ void __launch_bounds__(CV_THREADS, 2) conv1d_train_fwd_kernel(
    const float* __restrict__ zp, Vecs bnp, const float* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ used,
    float* __restrict__ z, float* __restrict__ parts, int n_exp, int cin,
    int cout, int h) {
  constexpr int LDP = CvDims<NT>::LDP;
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int tile = CV_ROWS - 2 * h, t0 = blockIdx.x * tile;
  const int base = t0 - h;  // slot of tile row 0
  const int live_end = min(used[b], n_exp);
  const float* src = zp + (size_t)b * n_exp * cin;
  float acc[NT][4];
  zero_acc<NT>(acc);
  gemm_stream<NT>(
      acc, smem, reinterpret_cast<uint32_t*>(smem + 2 * CV_ROWS * CV_LDA), cin,
      [&](int c, float(&ra)[16]) {
        const int k = c * CV_KC + (threadIdx.x & 31);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int row = (threadIdx.x + CV_THREADS * j) >> 5;
          ra[j] = k < cin ? u_at(src, bnp, base + row, k, cin, n_exp,
                                 live_end)
                          : 0.f;
        }
      },
      [&](int c, float(&rb)[NT]) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          rb[j] = tap_at<NT>(w, cin, cout, h, c * CV_KC, j);
      });
  float* P = smem;                    // CV_ROWS x LDP
  float* zt = smem + CV_ROWS * LDP;   // tile x cout
  store_acc<NT>(P, LDP, (threadIdx.x >> 5) * 16, acc);
  __syncthreads();
  const int n_out = min(tile, n_exp - t0) * cout;
  for (RowCol it(threadIdx.x, cout); it.r < tile; it.next()) {
    const float v = shift_sum(P, LDP, it.r + h, it.c, cout, h) + bias[it.c];
    const int i = it.r * cout + it.c;
    zt[i] = v;
    if (i < n_out) z[((size_t)b * n_exp + t0) * cout + i] = v;
  }
  __syncthreads();
  tile_moments(zt, smem, max(0, min(t0 + tile, live_end) - t0), cout,
               parts + ((size_t)b * gridDim.x + blockIdx.x) * (2 * cout + 1));
}

// one block per channel: the P tile partials combined in a fixed order
__global__ void conv1d_train_moments_kernel(const float* __restrict__ parts,
                                            int P, int cout,
                                            float* __restrict__ mean,
                                            float* __restrict__ var) {
  __shared__ float sn[CT_THREADS], sm[CT_THREADS], s2[CT_THREADS];
  const int co = blockIdx.x, t = threadIdx.x;
  Moments acc = {0.f, 0.f, 0.f};
  for (int p = t; p < P; p += blockDim.x) {
    const float* row = parts + (size_t)p * (2 * cout + 1);
    acc = chan(acc, {row[0], row[1 + co], row[1 + cout + co]});
  }
  sn[t] = acc.n;
  sm[t] = acc.mean;
  s2[t] = acc.m2;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) {
      const Moments m = chan({sn[t], sm[t], s2[t]},
                             {sn[t + s], sm[t + s], s2[t + s]});
      sn[t] = m.n;
      sm[t] = m.mean;
      s2[t] = m.m2;
    }
    __syncthreads();
  }
  if (t == 0) {
    mean[co] = sm[0];
    var[co] = sn[0] > 0.f ? fmaxf(s2[0] / sn[0], 0.f) : 0.f;
  }
}

// reduce: the tile's live-slot sums of dxh, dxh * xhat, da, da * xhat
// (block 32 x 8: channel lanes x row lanes).  The chain runs it for its
// last layer (whose d_u comes from outside) and for a layer whose
// successor is wider than TDF_MAX; every other layer's sums come from its
// successor's t pass (conv1d_train_tdup_kernel, prev_sums).
__global__ void conv1d_train_reduce_kernel(
    const float* __restrict__ du, const float* __restrict__ z, Vecs bn,
    const int* __restrict__ used, float* __restrict__ parts, int n_exp, int C,
    int tile) {
  __shared__ float red[4][8][32];
  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r_end = min(t0 + tile, min(used[b], n_exp));
  float* part = parts + ((size_t)b * gridDim.x + blockIdx.x) * 4 * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + tx;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if (c < C) {
      for (int g = t0 + ty; g < r_end; g += 8) {
        const size_t off = ((size_t)b * n_exp + g) * C + c;
        const float xh = __fmul_rn(__fsub_rn(z[off], bn.v[0][c]), bn.v[1][c]);
        const float y = __fadd_rn(__fmul_rn(xh, bn.v[2][c]), bn.v[3][c]);
        const float da = __fmul_rn(du[off], dleaky(y));
        const float dxh = __fmul_rn(da, bn.v[2][c]);
        a0 += dxh;
        a1 = fmaf(dxh, xh, a1);
        a2 += da;
        a3 = fmaf(da, xh, a3);
      }
    }
    red[0][ty][tx] = a0;
    red[1][ty][tx] = a1;
    red[2][ty][tx] = a2;
    red[3][ty][tx] = a3;
    __syncthreads();
    if (ty < 4 && c < C) {
      float s = 0.f;
      for (int k = 0; k < 8; ++k) s += red[ty][k][tx];
      part[(size_t)ty * C + c] = s;
    }
    __syncthreads();
  }
}

// column sums of P partial rows of width W, in a fixed order (block 32 x 8)
__global__ void conv1d_train_colsum_kernel(const float* __restrict__ parts,
                                           int P, int W,
                                           float* __restrict__ out) {
  __shared__ float red[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < W)
    for (int p = threadIdx.y; p < P; p += 8) s += parts[(size_t)p * W + col];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < W) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += red[k][threadIdx.x];
    out[col] = t;
  }
}

// t, d_u_prev: a block takes CV_ROWS slots, builds dz over them and an
// h-row halo, then the windows [dz(q), dz(q-1) + dz(q+1), ...] as a resident
// A operand ((h+1) cout deep), and multiplies them by W^T (wt, (h+1) cout x
// cin) in column chunks of NP, its 32-deep stages double-buffered through
// registers and split as they are stored.  With NW > 0 (inputs up to
// TDF_MAX channels) the block also takes its tile's dW and db: u (rebuilt
// from z_prev on load) transposed times the windows, the tile's CV_ROWS
// slots as the inner dimension in one pass (warp w: channels 16 (w & 1)..,
// 8 NW columns from 8 NW (w >> 1)); db by 8 row lanes added in order; one
// partial row a tile, summed by colsum.  Without it the dW kernel reads the
// dz this kernel writes.
//
// With prev_sums (fused dW only) the block also takes the previous layer's
// reduce sums over its tile: at each live slot q and input channel c,
// da = d_u_prev(q, c) leaky'(y_prev), dxh = da gamma_prev, and the four
// terms dxh, dxh xhat_prev, da, da xhat_prev, with xhat_prev and y_prev
// rebuilt from z_prev and the previous BN.  The block loads its tile of
// z_prev (to build u) in the accumulators' fragment layout, so a thread
// keeps the raw z_prev of its 16 fragment positions in registers (zq)
// until d_u_prev lies at the same positions in the accumulators (C_in <=
// 32: one column chunk): a thread adds its two rows, the warp's 8 row
// lanes are added by a butterfly (xor 4, 8, 16), the 8 warps in order; the
// 4 C_in sums go to the end of the tile's partial row, so colsum adds them
// with dW and db.  Nothing more is read from device memory, no shared
// memory is added, nothing is launched, and the order is fixed (no
// atomics): the sums repeat bit for bit.
#define TDF_MAX 32   // widest input of the fused dW
#define TDF_LDU 40   // [slot][channel] stride of its u (8 mod 32)

template <int NT, int NW>
__global__ void __launch_bounds__(CV_THREADS, 2) conv1d_train_tdup_kernel(
    const float* __restrict__ du, const float* __restrict__ z,
    const float* __restrict__ zp, Vecs coef, Vecs bnp,
    const float* __restrict__ wt, const int* __restrict__ used,
    float* __restrict__ dup, float* __restrict__ dzbuf,
    float* __restrict__ parts, int n_exp, int cin, int cout, int h,
    int lda_w, int prev_sums) {
  constexpr int NP = CvDims<NT>::NP, LDB = CvDims<NT>::LDB;
  constexpr int BSTAGE = CvDims<NT>::BSTAGE;
  extern __shared__ float smem[];
  const int b = blockIdx.y, t0 = blockIdx.x * CV_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int K = (h + 1) * cout, KP = (K + 7) & ~7;
  const int KB = NW ? 32 * NW : KP;  // window columns built (0 past K)
  const int nkc = (K + CV_KC - 1) / CV_KC, nnc = (cin + NP - 1) / NP;
  const int live_end = min(used[b], n_exp);
  const bool sums = NW > 0 && prev_sums;
  float* Aw = smem;                            // CV_ROWS x lda_w
  float* U = Aw + CV_ROWS * lda_w;             // NW: CV_ROWS x TDF_LDU
  float* reg = U + (NW ? CV_ROWS * TDF_LDU : 0);
  uint32_t* Bs = reinterpret_cast<uint32_t*>(reg);  // the B stages, after:
  float* dzs = reg;  // (CV_ROWS + 2h) x cout, then its window offsets,
  int2* wtab = reinterpret_cast<int2*>(
      dzs + (((CV_ROWS + 2 * h) * cout + 1) & ~1));
  float* cf = reinterpret_cast<float*>(wtab + KB);  // coef (6 cout)
  float* dbl = cf + 6 * cout;                       // NW: db's 8 lanes
  // B stage s: rows kc * CV_KC.. of wt, columns nc * NP.. (s = nc nkc + kc)
  auto fetch_b = [&](int s, float(&rb)[NT]) {
    const int nc = s / nkc, kc = s - nc * nkc;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int idx = threadIdx.x + CV_THREADS * j;
      const int k = kc * CV_KC + idx / NP, n = nc * NP + idx % NP;
      rb[j] = (k < K && n < cin) ? __ldg(wt + (size_t)k * cin + n) : 0.f;
    }
  };
  float rb[NT];
  fetch_b(0, rb);
  for (int k = threadIdx.x; k < KB; k += CV_THREADS)
    wtab[k] = window_offsets(k, cout, h);
  for (int i = threadIdx.x; i < 6 * cout; i += CV_THREADS)
    cf[i] = coef.v[i / cout][i % cout];
  // NW: the tile's z_prev, a thread its accumulator fragment's positions
  // (rows r0 + g, + 8; channels 8 j + 2 t, + 1), kept for the sums
  float zq[NT][4];
  if constexpr (NW > 0) {
    const float* src = zp + (size_t)b * n_exp * cin;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
        const int q = t0 + row;
        const bool in = c < cin && q < n_exp;
        zq[j][e] = in ? __ldg(src + (size_t)q * cin + c) : 0.f;
        U[row * TDF_LDU + c] = in ? u_of(zq[j][e], bnp, q, c, live_end) : 0.f;
      }
  }
  __syncthreads();
  // dz over the tile and its halo, DZ_BATCH rows' loads in flight a
  // thread; dead and outside slots: da = 0 and m = 0, so dz = 0
  const int n_dz = (CV_ROWS + 2 * h) * cout;
  const long long f0 = ((long long)b * n_exp + t0 - h) * cout;  // of i = 0
  RowCol it(threadIdx.x, cout);
  for (int i0 = threadIdx.x; i0 < n_dz; i0 += DZ_BATCH * CV_THREADS) {
    float vd[DZ_BATCH], vz[DZ_BATCH];
    RowCol at = it;
#pragma unroll
    for (int j = 0; j < DZ_BATCH; ++j, at.next()) {
      const int i = i0 + j * CV_THREADS, q = t0 - h + at.r;
      const bool live = i < n_dz && q >= 0 && q < live_end;
      vd[j] = live ? du[f0 + i] : 0.f;
      vz[j] = live ? z[f0 + i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < DZ_BATCH; ++j, it.next()) {
      const int i = i0 + j * CV_THREADS, q = t0 - h + it.r;
      if (i >= n_dz) break;
      const float v = (q >= 0 && q < live_end)
                          ? dz_of(vd[j], vz[j], cf, it.c, cout)
                          : 0.f;
      dzs[i] = v;
      if (!NW && it.r >= h && it.r < CV_ROWS + h && q < n_exp)
        dzbuf[f0 + i] = v;  // for the dW kernel
    }
  }
  __syncthreads();
  for (RowCol w(threadIdx.x, KB); w.r < CV_ROWS; w.next())
    Aw[w.r * lda_w + w.c] = window_at(dzs, w.r, cout, wtab[w.c]);
  if constexpr (NW > 0)
    for (int i = threadIdx.x; i < 8 * cout; i += CV_THREADS) {
      const int k = i / cout, co = i - k * cout;
      float v = 0.f;
      for (int r = k; r < CV_ROWS; r += 8) v += dzs[(r + h) * cout + co];
      dbl[i] = v;
    }
  __syncthreads();
  if constexpr (NW > 0) {  // the tile's dW and db
    const int mt = warp & 1, n0 = 8 * NW * (warp >> 1);
    float aw[NW][4];
    zero_acc(aw);
    warp_mma<NW, true, true>(
        aw, U, TDF_LDU, mt * 16, reinterpret_cast<const uint32_t*>(Aw) + n0,
        nullptr, lda_w, CV_ROWS / 8);
    const size_t wpart = (size_t)K * cin + cout + (sums ? 4 * cin : 0);
    float* part = parts + ((size_t)b * gridDim.x + blockIdx.x) * wpart;
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = mt * 16 + g + 8 * (e >> 1);
        const int n = n0 + 8 * j + 2 * t + (e & 1);
        if (ci < cin && n < K) {
          const int d = n / cout, co = n - d * cout;
          part[((size_t)d * cin + ci) * cout + co] = aw[j][e];
        }
      }
    for (int co = threadIdx.x; co < cout; co += CV_THREADS) {
      float v = 0.f;
      for (int k = 0; k < 8; ++k) v += dbl[k * cout + co];
      part[(size_t)K * cin + co] = v;
    }
    __syncthreads();  // dbl lies under the B stages
  }
  put_b<NT>(Bs, rb);
  __syncthreads();
  float acc[NT][4];
  zero_acc<NT>(acc);
  const int total = nkc * nnc;
  for (int s = 0; s < total; ++s) {
    const int nc = s / nkc, kc = s - nc * nkc, cur = s & 1;
    const bool more = s + 1 < total;
    if (more) fetch_b(s + 1, rb);
    const uint32_t* B = Bs + cur * BSTAGE;
    warp_mma<NT, false>(acc, Aw + kc * CV_KC, lda_w, r0, B, B + CV_KC * LDB,
                        LDB, (min(CV_KC, K - kc * CV_KC) + 7) / 8);
    if (more) put_b<NT>(Bs + (cur ^ 1) * BSTAGE, rb);
    if (kc == nkc - 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = t0 + r0 + g + 8 * (e >> 1);
          const int n = nc * NP + 8 * j + 2 * t + (e & 1);
          if (q < n_exp && n < cin)
            dup[((size_t)b * n_exp + q) * cin + n] = acc[j][e];
          if (more) acc[j][e] = 0.f;  // the last chunk's feed the sums
        }
    }
    __syncthreads();
  }
  if (!sums) return;
  // the previous layer's reduce sums over the tile's live slots (the one
  // column chunk of d_u_prev is in acc; the B stages are free)
  float* red = reinterpret_cast<float*>(Bs);  // 8 warps x 4 x 32 channels
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = 8 * j + 2 * t + c;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if (n < cin) {
        const float mu = __ldg(bnp.v[0] + n), inv = __ldg(bnp.v[1] + n);
        const float gam = __ldg(bnp.v[2] + n), bet = __ldg(bnp.v[3] + n);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + g + 8 * hh;
          if (t0 + row < live_end) {
            const float xh = __fmul_rn(__fsub_rn(zq[j][2 * hh + c], mu), inv);
            const float y = __fadd_rn(__fmul_rn(xh, gam), bet);
            const float da = __fmul_rn(acc[j][2 * hh + c], dleaky(y));
            const float dxh = __fmul_rn(da, gam);
            s[0] = __fadd_rn(s[0], dxh);
            s[1] = __fadd_rn(s[1], __fmul_rn(dxh, xh));
            s[2] = __fadd_rn(s[2], da);
            s[3] = __fadd_rn(s[3], __fmul_rn(da, xh));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int m = 4; m < 32; m <<= 1)
          s[k] = __fadd_rn(s[k], __shfl_xor_sync(0xffffffffu, s[k], m));
        if (g == 0) red[(warp * 4 + k) * 32 + n] = s[k];
      }
    }
  __syncthreads();
  const size_t wpart = (size_t)K * cin + cout + 4 * cin;
  float* part = parts + ((size_t)b * gridDim.x + blockIdx.x) * wpart +
                (size_t)K * cin + cout;
  for (int i = threadIdx.x; i < 4 * cin; i += CV_THREADS) {
    const int k = i / cin, n = i - k * cin;
    float v = 0.f;
    for (int w = 0; w < CV_THREADS / 32; ++w)
      v = __fadd_rn(v, red[(w * 4 + k) * 32 + n]);
    part[i] = v;
  }
}

// t, dW and db: block (m-chunk, split s, sample b) takes input channels
// 64 mc.. and the split's slots [s rps, (s+1) rps) (up to live_end + h:
// past it every window of dz is 0) in stages of 32 slots: u (rebuilt from
// z_prev on load, double-buffered through registers) as the transposed A
// operand, the windows of the stage's dz (written by the d_u_prev kernel)
// as B, split as they are stored.  Warp w takes channels 16 (w & 3).. and
// rows 16 (w >> 2).. of each stage; the two row halves are added in a
// fixed order.  db (m-chunk-0 blocks): thread (k, co) adds rows k, k + 8,
// .. of every stage, and the 8 lanes k are added in order.  The block
// writes one partial row (dW in its ((h+1) cin, cout) layout, then db),
// which colsum adds up in a fixed order: no atomics, so repeated steps give
// bitwise-equal gradients.
#define TDW_ROWS 32
#define TDW_M 64
#define TDW_LDU 72  // [slot][channel] stride of u (8 mod 32)

template <int NT>
__global__ void __launch_bounds__(CV_THREADS, 2) conv1d_train_tdw_kernel(
    const float* __restrict__ dzbuf, const float* __restrict__ zp, Vecs bnp,
    const int* __restrict__ used, float* __restrict__ parts, int n_exp,
    int cin, int cout, int h, int rps) {
  constexpr int NP = CvDims<NT>::NP, LDB = CvDims<NT>::LDB;
  constexpr int LDP = CvDims<NT>::LDP;
  extern __shared__ float smem[];
  const int mc = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int m0 = mc * TDW_M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, kh = warp >> 2;
  const int N = (h + 1) * cout;
  const int live_end = min(used[b], n_exp);
  const int p_begin = s * rps;
  const int p_end = min(min(p_begin + rps, n_exp), live_end + h);
  const int nst = p_end > p_begin ? (p_end - p_begin + TDW_ROWS - 1) / TDW_ROWS
                                  : 0;
  float* U = smem;                          // TDW_ROWS x TDW_LDU
  uint32_t* Bh = reinterpret_cast<uint32_t*>(U + TDW_ROWS * TDW_LDU);
  uint32_t* Bl = Bh + TDW_ROWS * LDB;
  float* dzs = reinterpret_cast<float*>(Bl + TDW_ROWS * LDB);
  int2* wtab = reinterpret_cast<int2*>(
      dzs + (((TDW_ROWS + 2 * h) * cout + 1) & ~1));
  for (int n = threadIdx.x; n < NP; n += CV_THREADS)
    wtab[n] = window_offsets(n, cout, h);
  const float* src = zp + (size_t)b * n_exp * cin;
  const int ci = m0 + (threadIdx.x & 63);  // the same in every row loaded
  auto fetch_u = [&](int st, float(&ru)[8]) {
    const int p0 = p_begin + st * TDW_ROWS;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = (threadIdx.x + CV_THREADS * j) >> 6;
      ru[j] = ci < cin ? u_at(src, bnp, p0 + row, ci, cin, n_exp, live_end)
                       : 0.f;
    }
  };
  float acc[NT][4];
  zero_acc<NT>(acc);
  float dbacc[3] = {0.f, 0.f, 0.f};  // 8 cout <= 3 CV_THREADS
  float ru[8];
  if (nst > 0) fetch_u(0, ru);
  for (int st = 0; st < nst; ++st) {
    const int p0 = p_begin + st * TDW_ROWS;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = threadIdx.x + CV_THREADS * j;
      U[(idx >> 6) * TDW_LDU + (idx & 63)] = ru[j];
    }
    // rows p0 - h .. of dz (outside [0, n_exp) 0), as one flat run
    const int n_dz = (TDW_ROWS + 2 * h) * cout;
    const long long f0 = ((long long)b * n_exp + p0 - h) * cout;
    const long long f_lo = (long long)b * n_exp * cout;
    const long long f_hi = f_lo + (long long)n_exp * cout;
    for (int i = threadIdx.x; i < n_dz; i += CV_THREADS)
      dzs[i] = (f0 + i >= f_lo && f0 + i < f_hi) ? dzbuf[f0 + i] : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TDW_ROWS * NP / CV_THREADS; ++j) {
      const int i = threadIdx.x + CV_THREADS * j;
      const int p = i / NP, n = i - p * NP;
      put_split(Bh, Bl, p * LDB + n, window_at(dzs, p, cout, wtab[n]));
    }
    if (mc == 0)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i = threadIdx.x + CV_THREADS * j;
        if (i < 8 * cout) {
          const int k = i / cout, co = i - k * cout;
          for (int p = k; p < TDW_ROWS; p += 8)
            dbacc[j] += dzs[(p + h) * cout + co];
        }
      }
    __syncthreads();
    if (st + 1 < nst) fetch_u(st + 1, ru);
    if (m0 + mt * 16 < cin)  // warps past C_in have nothing to add
      warp_mma<NT, true>(acc, U + kh * 16 * TDW_LDU, TDW_LDU, mt * 16,
                         Bh + kh * 16 * LDB, Bl + kh * 16 * LDB, LDB, 2);
    __syncthreads();
  }
  float* red = smem;  // TDW_M x LDP: the second row half's sums
  float* dbl = smem + TDW_M * LDP;  // 8 x cout: db's lanes
  if (kh == 1) store_acc<NT>(red, LDP, mt * 16, acc);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = threadIdx.x + CV_THREADS * j;
    if (i < 8 * cout) dbl[i] = dbacc[j];
  }
  __syncthreads();
  const size_t wpart = (size_t)(h + 1) * cin * cout + cout;
  float* part = parts + ((size_t)b * gridDim.y + s) * wpart;
  if (kh == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 16 + g + 8 * (e >> 1);
        const int n = 8 * j + 2 * t + (e & 1);
        const int ci = m0 + m;
        if (ci < cin && n < N) {
          const int d = n / cout, co = n - d * cout;
          part[((size_t)d * cin + ci) * cout + co] =
              acc[j][e] + red[m * LDP + n];
        }
      }
  }
  if (mc == 0)
    for (int co = threadIdx.x; co < cout; co += CV_THREADS) {
      float v = 0.f;
      for (int k = 0; k < 8; ++k) v += dbl[k * cout + co];
      part[(size_t)(h + 1) * cin * cout + co] = v;
    }
}

// ---------------------------------------------------------------------------
// The bfloat16 variant (a model computing in bfloat16; the JAX package's
// cdt = xe's dtype in _fwd_layer_kernel and _bwd_t_kernel): every window
// product rounds its operands to bfloat16 and sums in f32, with the
// symmetric pairs summed and rounded in bfloat16 on the input side
// (u(q-d) + u(q+d) forward and for dW, dz(q-d) + dz(q+d) for d_u_prev), so
// the shifts cannot move to the output side as in the f32 kernels.  One
// mma.sync m16n8k16 a 16-deep step (cb_taps in conv_tc.cuh, K1's bfloat16
// routine).  Layer 1 reads xe as bfloat16; later layers read the f32 z of
// the layer before and round u = leaky(BN(z)) * m as they stage it.
//  * forward (K8-bf16 fwd): replaces pallas_conv1d._run_fwd_layer's
//    pallas_call (:407) on a bfloat16 xe.  Bound on the H100: bytes (the
//    nuScenes step_31 layer 1 reads ~26 MB of the 262-wide xe; layers 2-3
//    read and write ~6.3 MB of f32 z each: ~0.017 ms for the three), the
//    products at the bfloat16 rate far below.  Design (K1-bf16's, conv1d_chain.cu,
//    with one layer a call and z out):
//    - the taps and the bias are packed once a call
//      (conv1d_train_pack_fwd_bf16_kernel) into the image cb1_taps reads,
//      from the f32 W as the caller holds it; a block copies the taps in
//      once (cp.async) and keeps them resident, or, past the shared
//      memory, a 64-column chunk's taps at a time;
//    - persistent blocks of 2 x rows threads (rows 256, or 128 where the
//      buffers do not fit) walk the tiles of rows - 2h slots; the input
//      streams through a cp.async ring of CB_KC-column chunks (a 2-, 8- or
//      16-byte copy a thread, zero-filled outside [0, n_exp)), the next
//      tile's first chunks prefetched under this tile's epilogue; a
//      bfloat16 xe is read from the ring as it lies; an f32 z_prev lands
//      raw and is turned once an element into u = leaky(BN(z)) * m,
//      rounded to bfloat16, with the BN vectors in shared memory once a
//      block;
//    - pairs u(q-d) + u(q+d) by add.rn.bf16x2, one mma.sync m16n8k16 a
//      16-deep step (cb1_taps);
//    - z = acc + b is staged in shared memory once: 16-byte stores of the
//      tile's rows (one contiguous run of z) and, from the same stage,
//      the tile's (count, mean, M2) over 16-row groups (two passes within
//      a group, groups combined in order by Chan's formula); the partial
//      rows are combined in a fixed order by conv1d_train_moments_kernel
//      (a combine by the last block to finish read ~5 us slower a call):
//      no atomics.
//  * t pass (K8-bf16 t): W^T's taps are packed once a call into
//    bfloat16 pair images, a column chunk after another
//    (conv1d_train_pack_wt_bf16_kernel), which blocks copy into shared
//    memory with cp.async (no block packs weights);
//  * t pass, inputs up to TDF_MAX wide: everything in one kernel, as the
//    f32 twin: a block's CV_ROWS slots (a tile of CV_ROWS - 2h and its
//    halo) stage dz (rounded to bfloat16 rows; db from the f32 values by
//    fixed row lanes) and u (rebuilt from z_prev, rounded, z_prev kept in
//    registers in the d_u_prev accumulators' layout); d_u_prev = the
//    rounded dz pairs times the image; dW a tap at a time = u's rounded
//    pairs (ldmatrix.trans, transposed A) times the tile's dz rows
//    (ldmatrix.trans, B); prev_sums from the d_u_prev in registers; one
//    partial row a tile (dW, db, the sums), summed by colsum;
//  * t pass, wider inputs: the d_u_prev kernel (dz written out in f32,
//    the image double-buffered a column chunk at a time), then one dW
//    kernel for every tap: a block a (channel chunk of TBW_M, row split,
//    sample) stages u's rows p - h .. p + TBW_ROWS + h once a stage with
//    16-byte loads and the stage's dz once, rounded once, and forms each
//    tap's pairs from shared memory; db from the staged f32 dz; one
//    partial row a (sample, split), summed by colsum.
// No atomics anywhere: repeated steps give bitwise-equal gradients.
// Bound on the H100: the window products at the bfloat16 rate (989
// TFLOP/s) and the bytes of z_prev / xe, dz and d_u_prev.

// a bfloat16 row buffer c wide: row stride in halves, 8 mod 64
__host__ __device__ __forceinline__ int bf_ld(int c) {
  return ((c + 63) & ~63) + 8;
}

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// an element held in registers (a 16-byte word's share), as f32
__device__ __forceinline__ float load_el(const float* p) { return *p; }
__device__ __forceinline__ float load_el(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// K8-bf16's forward.  The launch's plan (ops/conv1d_train.py
// plan_fwd_bf16, which packs these fields in this order); byte offsets of
// the shared-memory parts, each 16-byte aligned: the taps at 0, then the
// input ring, the bfloat16 u stage (f32 input only), the z stage, the BN
// vectors (f32 input only), the moments' scratch.
struct FbPlan {
  int rows;        // slots a block (256 or 128; 2 rows threads)
  int stages;      // chunks of the input ring (2 .. FB_MAX_STAGES)
  int resident;    // 1: every chunk's taps stay in shared memory
  int taps_words;  // shared words of the taps (all, or one chunk's)
  int kp, ldn;     // the image's tap layout (cb1_taps): rows a tap / 2, stride
  int ldz;         // the z stage's row stride in floats
  int bias_off;    // the image's words before the bias
  int img_words;   // the image's words
  int ring_off, a_off, z_off, bn_off, mom_off, smem;
};

#define FB_MAX_STAGES 4
#define FB_LDF (CB_KC + 4)  // an f32 ring row's stride in floats (272 B)

// W ((h+1) cin, cout) f32 and b (cout) -> the image: word (d kp + k/2) ldn
// + n holds W[d cin + k][n] (low half) and W[d cin + k + 1][n] (high half)
// rounded to bfloat16 (nearest even; 0 past cin and cout), then the bias
// as float bits at bias_off (0 past cout)
__global__ void conv1d_train_pack_fwd_bf16_kernel(
    const float* __restrict__ w, const float* __restrict__ bias,
    uint32_t* __restrict__ img, int cin, int cout, int h, FbPlan p) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.img_words;
       i += gridDim.x * blockDim.x) {
    uint32_t v = 0u;
    if (i < p.bias_off) {
      const int row = i / p.ldn, n = i - row * p.ldn;
      const int d = row / p.kp, k = 2 * (row - d * p.kp);
      float lo = 0.f, hi = 0.f;
      if (n < cout) {
        const float* m = w + ((size_t)d * cin + k) * cout + n;
        if (k < cin) lo = __ldg(m);
        if (k + 1 < cin) hi = __ldg(m + cout);
      }
      v = pack_bf16(lo, hi);
    } else if (i - p.bias_off < cout) {
      v = __float_as_uint(__ldg(bias + i - p.bias_off));
    }
    img[i] = v;
  }
}

// the plan's shared memory holds its parts in order, 16-byte aligned
static bool fb_fits(const FbPlan& p, int bf, int cin, int cout, int h) {
  const int rows = p.rows, tile = rows - 2 * h;
  const int ring = p.stages * rows * (bf ? CB_LDK * 2 : FB_LDF * 4);
  const int chunk_taps = (h + 1) * (CB_KC / 2) * p.ldn;
  return (rows == 128 || rows == 256) && tile >= 1 && p.stages >= 2 &&
         p.stages <= FB_MAX_STAGES && p.kp == ((cin + 15) & ~15) / 2 &&
         p.ldn >= ((cout + 7) & ~7) + 8 && p.ldn % 4 == 0 &&
         p.ldz >= cout && p.ldz % 4 == 0 && p.bias_off == (h + 1) * p.kp * p.ldn &&
         p.img_words >= p.bias_off + cout &&
         p.taps_words == (p.resident ? p.bias_off : chunk_taps) &&
         p.taps_words % 4 == 0 &&
         p.ring_off >= p.taps_words * 4 && p.a_off >= p.ring_off + ring &&
         p.z_off >= p.a_off + (bf ? 0 : rows * CB_LDK * 2) &&
         p.bn_off >= p.z_off + tile * p.ldz * 4 &&
         p.mom_off >= p.bn_off + (bf ? 0 : 16 * cin) &&
         p.smem >= p.mom_off + 2 * (rows / 16) * cout * 4 &&
         p.smem <= 232448 && p.ring_off % 16 == 0 && p.a_off % 16 == 0 &&
         p.z_off % 16 == 0 && p.bn_off % 16 == 0 && p.mom_off % 16 == 0;
}

// Persistent blocks (2 ROWS threads) over the B x ceil(n_exp / tile)
// tiles of tile = ROWS - 2h slots; a block's rows are its tile and the
// h-slot halo each side.  TP: unsigned short (xe's bfloat16 bits, read
// from the ring as they are) or float (a previous layer's z, turned into
// u = leaky(BN(z)) * m rounded to bfloat16 in the u stage).
template <int NT, int ROWS, class TP>
__global__ void __launch_bounds__(2 * ROWS, 1) conv1d_train_fwd_bf16_kernel(
    const TP* __restrict__ zp, Vecs bnp, const uint32_t* __restrict__ img,
    const int* __restrict__ used, float* __restrict__ z,
    float* __restrict__ parts, int B, int n_exp, int cin, int cout, int h,
    int unit, int zvec, FbPlan p) {
  constexpr bool BF = sizeof(TP) == 2;
  constexpr int LDR = BF ? CB_LDK : FB_LDF;  // ring row stride, elements
  constexpr int NTH = 2 * ROWS, G = ROWS / 16;
  extern __shared__ float4 fb_sm4[];
  char* sm = reinterpret_cast<char*>(fb_sm4);
  uint32_t* Wsm = reinterpret_cast<uint32_t*>(sm);
  TP* ring = reinterpret_cast<TP*>(sm + p.ring_off);
  unsigned short* U = reinterpret_cast<unsigned short*>(sm + p.a_off);
  float* zs = reinterpret_cast<float*>(sm + p.z_off);
  float* bnv = reinterpret_cast<float*>(sm + p.bn_off);
  float* mom = reinterpret_cast<float*>(sm + p.mom_off);
  const float* fbias = reinterpret_cast<const float*>(img) + p.bias_off;
  const int stage = ROWS * LDR, tile = ROWS - 2 * h;
  const int tps = (n_exp + tile - 1) / tile, n_tiles = B * tps;
  const int nch = (cin + CB_KC - 1) / CB_KC;
  const int r0 = (threadIdx.x >> 5) * 16, nt = (cout + 7) >> 3;
  const bool has_bn = bnp.v[0] != nullptr;

  auto prologue = [&](int ti) {  // chunks 0 .. stages - 2 of tile ti
    const int b = ti / tps, base = (ti - b * tps) * tile - h;
    for (int c = 0; c < p.stages - 1; ++c) {
      if (c < nch)
        cb_issue<ROWS, TP, LDR>(ring + c * stage,
                                zp + (size_t)b * n_exp * cin, base, n_exp,
                                cin, c * CB_KC, unit);
      cp_async_commit();
    }
  };
  if (p.resident) cb_copy(Wsm, img, p.taps_words / 4);
  if (!BF && has_bn)
    for (int i = threadIdx.x; i < 4 * cin; i += NTH)
      bnv[i] = __ldg(bnp.v[i / cin] + i % cin);
  bool prefetched = false;
  for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const int b = ti / tps, t0 = (ti - b * tps) * tile, base = t0 - h;
    const int live_end = min(__ldg(used + b), n_exp);
    const TP* xb = zp + (size_t)b * n_exp * cin;
    if (!prefetched) prologue(ti);
    float acc[NT][4];
    zero_acc<NT>(acc);
    for (int c = 0; c < nch; ++c) {
      cb_wait_ring(p.stages);
      __syncthreads();  // chunk c landed; every warp is done with c - 1
      const int cn = c + p.stages - 1;
      if (cn < nch)
        cb_issue<ROWS, TP, LDR>(ring + (cn % p.stages) * stage, xb, base,
                                n_exp, cin, cn * CB_KC, unit);
      cp_async_commit();
      const int k0 = c * CB_KC, kc = min(CB_KC, cin - k0);
      const uint32_t* W = Wsm + (k0 / 2) * p.ldn;
      int kp = p.kp;
      const unsigned short* A;
      if constexpr (BF) {
        A = reinterpret_cast<const unsigned short*>(ring +
                                                    (c % p.stages) * stage);
      } else {
        // u of the chunk's rows, rounded to bfloat16 once an element (0
        // outside [0, n_exp) and past cin; past the live slots too when
        // there is a previous BN)
        const float* R = ring + (c % p.stages) * stage;
        for (int i = threadIdx.x; i < ROWS * (CB_KC / 4); i += NTH) {
          const int r = i / (CB_KC / 4), c4 = (i - r * (CB_KC / 4)) * 4;
          const int gs = base + r;
          const float4 v = *reinterpret_cast<const float4*>(R + r * LDR + c4);
          const float e[4] = {v.x, v.y, v.z, v.w};
          float u[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ch = k0 + c4 + j;
            float x = e[j];
            if (has_bn && ch < cin) {
              const float xh =
                  __fmul_rn(__fsub_rn(x, bnv[ch]), bnv[cin + ch]);
              const float y =
                  __fadd_rn(__fmul_rn(xh, bnv[2 * cin + ch]), bnv[3 * cin + ch]);
              x = gs < live_end ? leaky(y) : 0.f;
            }
            u[j] = gs >= 0 && gs < n_exp && ch < cin ? x : 0.f;
          }
          *reinterpret_cast<uint2*>(U + r * CB_LDK + c4) =
              make_uint2(pack_bf16(u[0], u[1]), pack_bf16(u[2], u[3]));
        }
        A = U;
      }
      if (!p.resident) {  // this chunk's taps: (h+1) runs of kc rows
        const int rows2 = min(CB_KC / 2, kp - k0 / 2) * p.ldn / 4;
        for (int d = 0; d <= h; ++d)
          for (int i = threadIdx.x; i < rows2; i += NTH)
            cp_async16(Wsm + (d * (CB_KC / 2)) * p.ldn + 4 * i,
                       img + ((size_t)d * kp + k0 / 2) * p.ldn + 4 * i);
        cp_async_commit();
        cp_async_wait<0>();
        W = Wsm;
        kp = CB_KC / 2;
      }
      if (!BF || !p.resident) __syncthreads();
      cb1_taps<NT, ROWS>(acc, A, CB_LDK, r0, W, kp, p.ldn, kc, h, nt);
    }
    __syncthreads();  // the ring and the u stage are free
    prefetched = ti + (int)gridDim.x < n_tiles;
    if (prefetched) prologue(ti + gridDim.x);
    // z = acc + b at the tile's rows (block rows h .. h + tile - 1)
    {
      const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + 2 * t;
        if (j >= nt || n >= cout) continue;
        const float b0 = __ldg(fbias + n);
        const float b1 = n + 1 < cout ? __ldg(fbias + n + 1) : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + g + 8 * hh - h;
          if (r < 0 || r >= tile) continue;
          zs[r * p.ldz + n] = acc[j][2 * hh] + b0;
          if (n + 1 < cout) zs[r * p.ldz + n + 1] = acc[j][2 * hh + 1] + b1;
        }
      }
    }
    __syncthreads();
    // the tile's rows out (one contiguous run of z), and from the same
    // stage the moments of each 16-row group over the live slots
    const int n_out = min(tile, n_exp - t0);
    const int cnt = max(0, min(t0 + tile, live_end) - t0);
    float* zo = z + ((size_t)b * n_exp + t0) * cout;
    if (zvec) {
      const int w4 = cout / 4;
      for (int i = threadIdx.x; i < n_out * w4; i += NTH) {
        const int r = i / w4;
        *reinterpret_cast<float4*>(zo + (size_t)i * 4) =
            *reinterpret_cast<const float4*>(zs + r * p.ldz + (i - r * w4) * 4);
      }
    } else {
      for (int i = threadIdx.x; i < n_out * cout; i += NTH) {
        const int r = i / cout;
        zo[i] = zs[r * p.ldz + i - r * cout];
      }
    }
    for (int i = threadIdx.x; i < G * cout; i += NTH) {
      const int k = i / cout, co = i - k * cout;
      const int ra = 16 * k, rb = min(ra + 16, cnt);
      float sum = 0.f;
      for (int r = ra; r < rb; ++r) sum += zs[r * p.ldz + co];
      const float mean = rb > ra ? sum / (float)(rb - ra) : 0.f;
      float m2 = 0.f;
      for (int r = ra; r < rb; ++r) {
        const float d = zs[r * p.ldz + co] - mean;
        m2 = fmaf(d, d, m2);
      }
      mom[i] = mean;
      mom[G * cout + i] = m2;
    }
    __syncthreads();
    float* part = parts + (size_t)ti * (2 * cout + 1);
    for (int co = threadIdx.x; co < cout; co += NTH) {
      Moments m = {0.f, 0.f, 0.f};
      for (int k = 0; k < G; ++k)
        m = chan(m, {(float)max(0, min(16, cnt - 16 * k)), mom[k * cout + co],
                     mom[(G + k) * cout + co]});
      part[1 + co] = m.mean;
      part[1 + cout + co] = m.m2;
    }
    if (threadIdx.x == 0) part[0] = (float)cnt;
  }
  cp_async_wait<0>();
}

// The bfloat16 t pass (K8-bf16 t).
#define TB_PAD 4       // rows of a u stage beyond its slots each side (>= h)
#define TF_LDU 40      // fused kernel: u's row stride in halves (80 B)
#define TBW_M 128      // wide dW kernel: input channels a block (a warp 16)
#define TBW_ROWS 64    // wide dW kernel: slots a stage
#define TBW_LDU (TBW_M + 8)  // its u row stride in halves (272 B)

// words of one column chunk (np columns) of the packed W^T image: (h+1)
// kp rows of np + 8 words, kp = cout rounded to 16, halved
__host__ __device__ __forceinline__ int timg_words(int cout, int h, int np) {
  return (h + 1) * (((cout + 15) & ~15) / 2) * (np + 8);
}

// the smallest power of two >= c (c <= 128): a thread's fixed column of
// a 256-thread pass over rows x cpow, with 256 / cpow row lanes
__host__ __device__ __forceinline__ int pow2_cols(int c) {
  return c <= 32 ? 32 : c <= 64 ? 64 : 128;
}

// W ((h+1) cin, cout) f32 -> the image cb_taps reads, column chunk nc
// (cin columns nc np ..) after chunk nc - 1: word (d kp + k/2) (np + 8) + n
// of a chunk holds W^T's rows k, k + 1 (k < cout) of tap d at column n as
// bfloat16 pairs (rounded to nearest even; 0 past cout, cin and np)
__global__ void conv1d_train_pack_wt_bf16_kernel(const float* __restrict__ w,
                                                 uint32_t* __restrict__ img,
                                                 int cin, int cout, int h,
                                                 int np, int total) {
  const int kp = ((cout + 15) & ~15) / 2, ldn = np + 8;
  const int cw = timg_words(cout, h, np);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int nc = i / cw, r = i - nc * cw;
    const int row = r / ldn, n = r - row * ldn;
    const int d = row / kp, k = 2 * (row - d * kp), ci = nc * np + n;
    float lo = 0.f, hi = 0.f;
    if (n < np && ci < cin) {
      const float* m = w + ((size_t)d * cin + ci) * cout;
      if (k < cout) lo = __ldg(m + k);
      if (k + 1 < cout) hi = __ldg(m + k + 1);
    }
    img[i] = pack_bf16(lo, hi);
  }
}

// copies n16 16-byte words of src into dst (shared memory), cp.async
__device__ __forceinline__ void copy_image(uint32_t* dst, const uint32_t* src,
                                           int n16) {
  for (int i = threadIdx.x; i < n16; i += CV_THREADS)
    cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const unsigned short* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const unsigned short* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// The A fragment of dW's product for tap d: channels m0 .. m0 + 15 (the
// product's rows) by slots k0 .. k0 + 15 (its inner dimension) of the
// pairs u(p - d) + u(p + d), summed and rounded in bfloat16 (tap 0: u(p)),
// from U ([slot row][channel], bfloat16, stride ldu halves, 16-byte rows;
// rows k0 - d .. k0 + 15 + d must lie in the buffer) by ldmatrix.trans.
__device__ __forceinline__ void pair_frag(uint32_t (&a)[4],
                                          const unsigned short* U, int ldu,
                                          int k0, int m0, int d) {
  const int lane = threadIdx.x & 31, mm = lane >> 3;
  const int row = k0 + (mm >> 1) * 8 + (lane & 7), col = m0 + (mm & 1) * 8;
  if (d == 0) {
    ldsm_x4_trans(a, U + row * ldu + col);
    return;
  }
  uint32_t lo[4], hi[4];
  ldsm_x4_trans(lo, U + (row - d) * ldu + col);
  ldsm_x4_trans(hi, U + (row + d) * ldu + col);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a[e] = pack_bf16(__uint_as_float(lo[e] << 16) + __uint_as_float(hi[e] << 16),
                     __uint_as_float(lo[e] & 0xffff0000u) +
                         __uint_as_float(hi[e] & 0xffff0000u));
}

// dz over the block's CV_ROWS rows (slots base ..; 0 at dead and outside
// slots) into A (bfloat16, stride lda, columns up to pow2_cols(cout) 0 past
// cout), and into dzbuf (f32) at the tile's rows h .. h + tile - 1 when
// dzbuf is given; thread column c = tid % cpow adds the f32 dz of its tile
// rows, ascending, into *db (rows tid / cpow + k 256 / cpow).
__device__ __forceinline__ void stage_dz(const float* __restrict__ du,
                                         const float* __restrict__ z,
                                         const float* cf, unsigned short* A,
                                         int lda, float* __restrict__ dzbuf,
                                         int b, int n_exp, int base, int h,
                                         int live_end, int cout, float* db) {
  const int cpow = pow2_cols(cout), lanes = CV_THREADS / cpow;
  const int c = threadIdx.x & (cpow - 1), tile = CV_ROWS - 2 * h;
  float s = 0.f;
#pragma unroll 4
  for (int r = threadIdx.x / cpow; r < CV_ROWS; r += lanes) {
    const int q = base + r;
    float v = 0.f;
    if (c < cout && q >= 0 && q < live_end) {
      const size_t off = ((size_t)b * n_exp + q) * cout + c;
      v = dz_of(__ldg(du + off), __ldg(z + off), cf, c, cout);
    }
    const bool in_tile = r >= h && r < h + tile;
    if (dzbuf != nullptr && c < cout && in_tile && q < n_exp)
      dzbuf[((size_t)b * n_exp + q) * cout + c] = v;
    if (in_tile) s += v;
    if (c < lda) A[r * lda + c] = bf16_bits(v);
  }
  *db = s;
}

// dW's B fragments of one 16-slot step: dz rows k0 .. k0 + 15 of columns
// n0 .. n0 + 7 (D: [slot row][channel], bfloat16, stride ldd)
__device__ __forceinline__ void dz_frag(uint32_t& b0, uint32_t& b1,
                                        const unsigned short* D, int ldd,
                                        int k0, int n0) {
  ldsm_x2_trans(b0, b1, D + (k0 + (threadIdx.x & 15)) * ldd + n0);
}

// t pass, inputs up to TDF_MAX wide (everything in one kernel): block
// (tile, sample) over CV_ROWS rows, slots base = t0 - h ..; the image's one
// column chunk (32 columns) copied in; u (from z_prev or xe, the thread's
// z_prev at its d_u_prev fragment positions kept in zq) into U, dz into A;
// d_u_prev by cb_taps; prev_sums from it and zq; dW a tap at a time, warp
// w: channels 16 (w & 1) .., n-tiles NTO / 4 from (w >> 1) NTO / 4, over
// the block's 128 rows with the halo rows' dz masked out; db by lanes.
// The tile's partial row: dW ((h+1) cin, cout), db, [4 cin sums].
template <int NTO, class TP>
__global__ void __launch_bounds__(CV_THREADS, 2) conv1d_train_tfused_bf16_kernel(
    const float* __restrict__ du, const float* __restrict__ z,
    const TP* __restrict__ zp, Vecs coef, Vecs bnp,
    const uint32_t* __restrict__ img, const int* __restrict__ used,
    float* __restrict__ dup, float* __restrict__ parts, int n_exp, int cin,
    int cout, int h, int prev_sums) {
  constexpr int NQ = NTO / 4, LDN = 40;
  extern __shared__ float4 tf_sm4[];
  const int kp = ((cout + 15) & ~15) / 2, lda = bf_ld(cout);
  const int cw = timg_words(cout, h, 32);
  uint32_t* Wt = reinterpret_cast<uint32_t*>(tf_sm4);
  unsigned short* A = reinterpret_cast<unsigned short*>(Wt + cw);
  unsigned short* U = A + CV_ROWS * lda;  // (CV_ROWS + 2 TB_PAD) rows
  float* cf = reinterpret_cast<float*>(U + (CV_ROWS + 2 * TB_PAD) * TF_LDU);
  float* dbl = cf + 6 * cout;   // CV_THREADS
  float* red = dbl + CV_THREADS;  // 8 warps x 4 x 32
  const int b = blockIdx.y, tile = CV_ROWS - 2 * h;
  const int t0 = blockIdx.x * tile, base = t0 - h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int live_end = min(used[b], n_exp);
  const bool sums = prev_sums != 0;
  copy_image(Wt, img, cw / 4);
  for (int i = threadIdx.x; i < 6 * cout; i += CV_THREADS)
    cf[i] = coef.v[i / cout][i % cout];
  for (int i = threadIdx.x; i < TB_PAD * TF_LDU; i += CV_THREADS) {
    U[i] = 0;
    U[(CV_ROWS + TB_PAD) * TF_LDU + i] = 0;
  }
  // z_prev at the thread's fragment positions (rows r0 + g, + 8; channels
  // 8 j + 2 t, + 1), u from it into U
  float zq[4][4];
  const TP* src = zp + (size_t)b * n_exp * cin;
  unsigned short* U0 = U + TB_PAD * TF_LDU;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + g + 8 * hh, q = base + row, c = 8 * j + 2 * t;
      float u[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = c + e < cin && q >= 0 && q < n_exp;
        const float v = in ? load_f32(src + (size_t)q * cin + c + e) : 0.f;
        zq[j][2 * hh + e] = v;
        u[e] = in ? u_of(v, bnp, q, c + e, live_end) : 0.f;
      }
      *reinterpret_cast<uint32_t*>(U0 + row * TF_LDU + c) =
          pack_bf16(u[0], u[1]);
    }
  __syncthreads();  // cf
  float db;
  stage_dz(du, z, cf, A, lda, nullptr, b, n_exp, base, h, live_end, cout,
           &db);
  dbl[threadIdx.x] = db;
  cp_async_wait<0>();
  __syncthreads();
  // d_u_prev
  float acc[4][4];
  zero_acc<4>(acc);
  cb_taps<4>(acc, A, lda, r0, Wt, kp, LDN, cout, h, (cin + 7) >> 3);
  const int n_out = min(tile, n_exp - t0);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1) - h, c = 8 * j + 2 * t + (e & 1);
      if (r >= 0 && r < n_out && c < cin)
        dup[((size_t)b * n_exp + t0 + r) * cin + c] = acc[j][e];
    }
  const size_t wpart = (size_t)(h + 1) * cin * cout + cout + (sums ? 4 * cin : 0);
  float* part = parts + ((size_t)b * gridDim.x + blockIdx.x) * wpart;
  if (sums) {
    // the previous layer's reduce sums over the tile's live slots, as the
    // f32 twin takes them: a thread's two rows, the 8 row lanes by a
    // butterfly, the 8 warps in order
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 8 * j + 2 * t + c;
        float sv[4] = {0.f, 0.f, 0.f, 0.f};
        if (n < cin) {
          const float mu = __ldg(bnp.v[0] + n), inv = __ldg(bnp.v[1] + n);
          const float gam = __ldg(bnp.v[2] + n), bet = __ldg(bnp.v[3] + n);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + g + 8 * hh;
            if (row >= h && row < h + tile && base + row < live_end) {
              const float xh =
                  __fmul_rn(__fsub_rn(zq[j][2 * hh + c], mu), inv);
              const float y = __fadd_rn(__fmul_rn(xh, gam), bet);
              const float da = __fmul_rn(acc[j][2 * hh + c], dleaky(y));
              const float dxh = __fmul_rn(da, gam);
              sv[0] = __fadd_rn(sv[0], dxh);
              sv[1] = __fadd_rn(sv[1], __fmul_rn(dxh, xh));
              sv[2] = __fadd_rn(sv[2], da);
              sv[3] = __fadd_rn(sv[3], __fmul_rn(da, xh));
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int m = 4; m < 32; m <<= 1)
            sv[k] = __fadd_rn(sv[k], __shfl_xor_sync(0xffffffffu, sv[k], m));
          if (g == 0) red[(warp * 4 + k) * 32 + n] = sv[k];
        }
      }
  }
  // dW, a tap at a time: the halo rows' dz (rows < h, >= h + tile) masked
  const int mt = warp & 1, nq0 = (warp >> 1) * NQ;
  const int nt = (cout + 7) >> 3;
  for (int d = 0; d <= h; ++d) {
    float aw[NQ][4];
    zero_acc<NQ>(aw);
    if (16 * mt < cin) {
#pragma unroll 2
      for (int ks = 0; ks < CV_ROWS / 16; ++ks) {
        uint32_t a[4];
        pair_frag(a, U0, TF_LDU, 16 * ks, 16 * mt, d);
        const int ra = 16 * ks + 2 * t, rb = ra + 8;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (nq0 + q >= nt) break;
          uint32_t b0, b1;
          dz_frag(b0, b1, A, lda, 16 * ks, 8 * (nq0 + q));
          if (ks == 0 || ks == CV_ROWS / 16 - 1) {
            const auto keep = [&](int r) {
              return r >= h && r < h + tile;
            };
            b0 &= (keep(ra) ? 0xffffu : 0u) | (keep(ra + 1) ? 0xffff0000u : 0u);
            b1 &= (keep(rb) ? 0xffffu : 0u) | (keep(rb + 1) ? 0xffff0000u : 0u);
          }
          mma_bf16(aw[q], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 16 * mt + g + 8 * (e >> 1);
        const int co = 8 * (nq0 + q) + 2 * t + (e & 1);
        if (ci < cin && co < cout)
          part[((size_t)d * cin + ci) * cout + co] = aw[q][e];
      }
  }
  __syncthreads();  // dbl, red
  const size_t n_dw = (size_t)(h + 1) * cin * cout;
  const int cpow = pow2_cols(cout);
  for (int co = threadIdx.x; co < cout; co += CV_THREADS) {
    float v = 0.f;
    for (int k = 0; k < CV_THREADS / cpow; ++k) v += dbl[k * cpow + co];
    part[n_dw + co] = v;
  }
  if (sums)
    for (int i = threadIdx.x; i < 4 * cin; i += CV_THREADS) {
      const int k = i / cin, n = i - k * cin;
      float v = 0.f;
      for (int w = 0; w < CV_THREADS / 32; ++w)
        v = __fadd_rn(v, red[(w * 4 + k) * 32 + n]);
      part[n_dw + cout + i] = v;
    }
}

// t, d_u_prev for wider inputs: dz over the block's CV_ROWS slots (f32
// into dzbuf at the tile's rows), rounded to bfloat16 rows, times the
// image's column chunks of 8 NT, each copied in (cp.async) while the chunk
// before it is multiplied.
template <int NT>
__global__ void __launch_bounds__(CV_THREADS, 1) conv1d_train_tdup_bf16_kernel(
    const float* __restrict__ du, const float* __restrict__ z, Vecs coef,
    const uint32_t* __restrict__ img, const int* __restrict__ used,
    float* __restrict__ dup, float* __restrict__ dzbuf, int n_exp, int cin,
    int cout, int h) {
  constexpr int NP = 8 * NT, LDN = NP + 8;
  extern __shared__ float4 tb_sm4[];
  const int lda = bf_ld(cout), kp = ((cout + 15) & ~15) / 2;
  const int cw = timg_words(cout, h, NP);
  uint32_t* Wt = reinterpret_cast<uint32_t*>(tb_sm4);  // two chunks
  unsigned short* A = reinterpret_cast<unsigned short*>(Wt + 2 * cw);
  float* cf = reinterpret_cast<float*>(A + CV_ROWS * lda);  // 6 cout
  const int b = blockIdx.y;
  const int tile = CV_ROWS - 2 * h, t0 = blockIdx.x * tile;
  const int live_end = min(used[b], n_exp);
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int nch = (cin + NP - 1) / NP;
  copy_image(Wt, img, cw / 4);
  for (int i = threadIdx.x; i < 6 * cout; i += CV_THREADS)
    cf[i] = coef.v[i / cout][i % cout];
  __syncthreads();
  float db;
  stage_dz(du, z, cf, A, lda, dzbuf, b, n_exp, t0 - h, h, live_end, cout,
           &db);
  const int n_out = min(tile, n_exp - t0);
  for (int nc = 0; nc < nch; ++nc) {
    if (nc + 1 < nch) {
      copy_image(Wt + ((nc + 1) & 1) * cw, img + (size_t)(nc + 1) * cw,
                 cw / 4);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n0 = nc * NP, ncols = min(NP, cin - n0);
    float acc[NT][4];
    zero_acc<NT>(acc);
    cb_taps<NT>(acc, A, lda, r0, Wt + (nc & 1) * cw, kp, LDN, cout, h,
                (ncols + 7) >> 3);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1) - h, c = 8 * j + 2 * t + (e & 1);
        if (r >= 0 && r < n_out && c < ncols)
          dup[((size_t)b * n_exp + t0 + r) * cin + n0 + c] = acc[j][e];
      }
    __syncthreads();  // the chunk's buffer is copied over next
  }
}

// t, dW and db for wider inputs, every tap: block (channel chunk mc and tap
// group, split s, sample b) takes input channels TBW_M mc .. and taps
// d0 .. d0 + TG - 1 over the split's live slots [s rps, (s+1) rps) in
// stages of TBW_ROWS: u's rows p0 - TB_PAD .. p0 + TBW_ROWS + TB_PAD - 1
// (rebuilt from z_prev or xe, rounded to bfloat16) staged once with
// 16-byte loads of the rows, the stage's dz rows (dzbuf) rounded once;
// warp w takes channels 16 w .. of every tap: A = the tap's pairs of u
// (pair_frag), B = the dz rows (dz_frag, loaded once a step for every
// tap).  db (mc = 0, first tap group): thread column c adds the f32 dz of
// its rows, the lanes added in order.  zp must be 16-byte aligned.
template <int NTO, int TG, class TP>
__global__ void __launch_bounds__(CV_THREADS, 1) conv1d_train_tdw_bf16_kernel(
    const float* __restrict__ dzbuf, const TP* __restrict__ zp, Vecs bnp,
    const int* __restrict__ used, float* __restrict__ parts, int n_exp,
    int cin, int cout, int h, int rps) {
  constexpr int EW = 16 / sizeof(TP);  // elements a 16-byte word
  extern __shared__ float4 tw_sm4[];
  const int ldd = ((cout + 15) & ~15) + 8;  // halves
  unsigned short* U = reinterpret_cast<unsigned short*>(tw_sm4);
  unsigned short* D = U + (TBW_ROWS + 2 * TB_PAD) * TBW_LDU;  // TBW_ROWS x ldd
  float* dbl = reinterpret_cast<float*>(D + TBW_ROWS * ldd);  // CV_THREADS
  const int n_tg = (h + TG) / TG;
  const int mc = blockIdx.x / n_tg, d0 = (blockIdx.x - mc * n_tg) * TG;
  const int s = blockIdx.y, b = blockIdx.z;
  const int m0 = mc * TBW_M, nchan = min(TBW_M, cin - m0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = (cout + 7) >> 3;
  const int live_end = min(used[b], n_exp);
  const int p_begin = s * rps;
  const int p_end = min(min(p_begin + rps, n_exp), live_end);
  const bool dbb = blockIdx.x == 0;
  const int cpow = pow2_cols(cout), lanes = CV_THREADS / cpow;
  const int dc = threadIdx.x & (cpow - 1);
  const int wpr = (nchan + EW - 1) / EW + 1;  // words a u row
  const uint4* zw = reinterpret_cast<const uint4*>(zp);
  float acc[TG][NTO][4];
#pragma unroll
  for (int dd = 0; dd < TG; ++dd) zero_acc<NTO>(acc[dd]);
  float dbacc = 0.f;
  for (int p0 = p_begin; p0 < p_end; p0 += TBW_ROWS) {
    // u's rows: the 16-byte words over channels m0 .. m0 + nchan - 1
    for (int i = threadIdx.x; i < (TBW_ROWS + 2 * TB_PAD) * wpr;
         i += CV_THREADS) {
      const int r = i / wpr, k = i - r * wpr, q = p0 - TB_PAD + r;
      unsigned short* dst = U + r * TBW_LDU;
      if (q < 0 || q >= n_exp) {
        for (int e = 0; e < EW; ++e)
          if (k * EW + e < nchan) dst[k * EW + e] = 0;
        continue;
      }
      const long long e0 = ((long long)b * n_exp + q) * cin + m0;
      const long long wi = e0 / EW + k;
      const int c0 = (int)(wi * EW - e0);
      if (c0 >= nchan) continue;
      const uint4 v = __ldg(zw + wi);
      const TP* el = reinterpret_cast<const TP*>(&v);
#pragma unroll
      for (int e = 0; e < EW; ++e) {
        const int c = c0 + e;
        if (c >= 0 && c < nchan)
          dst[c] = bf16_bits(u_of(load_el(el + e), bnp, q, m0 + c,
                                  live_end));
      }
    }
    // the stage's dz rows (0 past p_end), db by thread columns
    for (int r = threadIdx.x / cpow; r < TBW_ROWS; r += lanes) {
      const int p = p0 + r;
      const float v = (dc < cout && p < p_end)
                          ? __ldg(dzbuf + ((size_t)b * n_exp + p) * cout + dc)
                          : 0.f;
      dbacc += v;
      if (dc < ldd) D[r * ldd + dc] = bf16_bits(v);
    }
    __syncthreads();
    if (16 * warp < nchan) {
      const unsigned short* U0 = U + TB_PAD * TBW_LDU;
#pragma unroll 1
      for (int ks = 0; ks < TBW_ROWS / 16; ++ks) {
        uint32_t bf[NTO][2];
#pragma unroll
        for (int j = 0; j < NTO; ++j)
          if (j < nt) dz_frag(bf[j][0], bf[j][1], D, ldd, 16 * ks, 8 * j);
#pragma unroll
        for (int dd = 0; dd < TG; ++dd) {
          if (d0 + dd > h) break;
          uint32_t a[4];
          pair_frag(a, U0, TBW_LDU, 16 * ks, 16 * warp, d0 + dd);
#pragma unroll
          for (int j = 0; j < NTO; ++j)
            if (j < nt) mma_bf16(acc[dd][j], a, bf[j][0], bf[j][1]);
        }
      }
    }
    __syncthreads();
  }
  const size_t n_dw = (size_t)(h + 1) * cin * cout;
  float* part = parts + ((size_t)b * gridDim.y + s) * (n_dw + cout);
#pragma unroll
  for (int dd = 0; dd < TG; ++dd) {
    if (d0 + dd > h) break;
#pragma unroll
    for (int j = 0; j < NTO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 16 * warp + g + 8 * (e >> 1);
        const int co = 8 * j + 2 * t + (e & 1);
        if (ci < nchan && co < cout)
          part[((size_t)(d0 + dd) * cin + m0 + ci) * cout + co] =
              acc[dd][j][e];
      }
  }
  if (dbb) {
    dbl[threadIdx.x] = dbacc;
    __syncthreads();
    for (int co = threadIdx.x; co < cout; co += CV_THREADS) {
      float v = 0.f;
      for (int k = 0; k < lanes; ++k) v += dbl[k * cpow + co];
      part[n_dw + co] = v;
    }
  }
}

static int colsum(const float* parts, int P, int W, float* out,
                  cudaStream_t s) {
  conv1d_train_colsum_kernel<<<(W + 31) / 32, dim3(32, 8), 0, s>>>(parts, P,
                                                                    W, out);
  return (int)cudaGetLastError();
}

// NT of a product NP = 8 NT columns wide: 4, 8 or 12 (<= 96), else 0
static int nt_of(int n) { return n <= 32 ? 4 : n <= 64 ? 8 : n <= 96 ? 12 : 0; }

template <int NT>
static int launch_fwd(const float* zp, const Vecs& bnp, const float* w,
                      const float* bias, const int* used, float* z,
                      float* parts, int B, int n_exp, int cin, int cout, int h,
                      int tile, cudaStream_t s) {
  const int words = std::max(stream_words<NT>(),
                             CV_ROWS * CvDims<NT>::LDP + tile * cout);
  const size_t smem = (size_t)words * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_fwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_exp + tile - 1) / tile, B);
  conv1d_train_fwd_kernel<NT><<<grid, CV_THREADS, smem, s>>>(
      zp, bnp, w, bias, used, z, parts, n_exp, cin, cout, h);
  return (int)cudaGetLastError();
}

// z_prev (B, n_exp, cin) f32; pm, pi, pg, pb the previous layer's (mean,
// inv, gamma, beta) (cin each) or null on layer 1; w ((h+1) cin, cout);
// bias (cout);
// used (B,) int32 -> z (B, n_exp, cout), mean, var (cout); tile = CV_ROWS -
// 2h slots a block; parts is scratch of B * ceil(n_exp / tile) rows of
// 2 cout + 1 floats; (h+1) cout <= 96.
extern "C" int ccn_conv1d_train_fwd(const float* zp, const float* pm,
                                    const float* pi, const float* pg,
                                    const float* pb, const float* w,
                                    const float* bias,
                                    const int* used, float* z, float* parts,
                                    float* mean, float* var, int B, int n_exp,
                                    int cin, int cout, int h, int tile,
                                    void* stream) {
  const int nt = nt_of((h + 1) * cout);
  if (B < 1 || n_exp < 1 || cin < 1 || cout < 1 || h < 0 ||
      tile != CV_ROWS - 2 * h || tile < 1 || nt == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Vecs bnp = {{pm, pi, pg, pb, nullptr, nullptr}};
  int rc = nt == 4 ? launch_fwd<4>(zp, bnp, w, bias, used, z, parts, B, n_exp,
                                   cin, cout, h, tile, s)
         : nt == 8 ? launch_fwd<8>(zp, bnp, w, bias, used, z, parts, B, n_exp,
                                   cin, cout, h, tile, s)
                   : launch_fwd<12>(zp, bnp, w, bias, used, z, parts, B,
                                    n_exp, cin, cout, h, tile, s);
  if (rc != 0) return rc;
  conv1d_train_moments_kernel<<<cout, CT_THREADS, 0, s>>>(
      parts, B * ((n_exp + tile - 1) / tile), cout, mean, var);
  return (int)cudaGetLastError();
}

static int reduce(const float* du, const float* z, const Vecs& bn,
                  const int* used, float* parts, float* sums, int B, int n_exp,
                  int C, int tile, cudaStream_t s) {
  dim3 grid((n_exp + tile - 1) / tile, B);
  conv1d_train_reduce_kernel<<<grid, dim3(32, 8), 0, s>>>(du, z, bn, used,
                                                          parts, n_exp, C,
                                                          tile);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return colsum(parts, (int)(grid.x * grid.y), 4 * C, sums, s);
}

// d_u, z (B, n_exp, C) f32; bn (mean, inv, gamma, beta) (4 C); used (B,)
// -> sums (4 C): dxh, dxh * xhat, da, da * xhat; parts is scratch of
// B * ceil(n_exp / tile) rows of 4 C floats.
extern "C" int ccn_conv1d_train_reduce(const float* du, const float* z,
                                       const float* bn, const int* used,
                                       float* parts, float* sums, int B,
                                       int n_exp, int C, int tile,
                                       void* stream) {
  if (B < 1 || n_exp < 1 || C < 1 || tile < 1)
    return (int)cudaErrorInvalidValue;
  return reduce(du, z, {{bn, bn + C, bn + 2 * C, bn + 3 * C, nullptr, nullptr}},
                used, parts, sums, B, n_exp, C, tile, (cudaStream_t)stream);
}

template <int NT, int NW>
static int launch_tdup(const float* du, const float* z, const float* zp,
                       const Vecs& coef, const Vecs& bnp, const float* wt,
                       const int* used, float* dup, float* dzbuf, float* parts,
                       int B, int n_exp, int cin, int cout, int h,
                       int prev_sums, cudaStream_t s) {
  static_assert(NW == 0 || NT == 4, "the fused dW takes one 32-wide chunk");
  const int K = (h + 1) * cout, KP = (K + 7) & ~7;
  const int KB = NW ? 32 * NW : KP;
  const int lda_w = ((KP + 31) & ~31) + 4;
  const int below = ((((CV_ROWS + 2 * h) * cout + 1) & ~1) + 2 * KB +
                     6 * cout + (NW ? 8 * cout : 0));
  const int words = CV_ROWS * lda_w + (NW ? CV_ROWS * TDF_LDU : 0) +
                    std::max(2 * CvDims<NT>::BSTAGE, below);
  const size_t smem = (size_t)words * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_tdup_kernel<NT, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_exp + CV_ROWS - 1) / CV_ROWS, B);
  conv1d_train_tdup_kernel<NT, NW><<<grid, CV_THREADS, smem, s>>>(
      du, z, zp, coef, bnp, wt, used, dup, dzbuf, parts, n_exp, cin, cout, h,
      lda_w, prev_sums);
  return (int)cudaGetLastError();
}

template <int NT>
static int launch_tdw(const float* dzbuf, const float* zp, const Vecs& bnp,
                      const int* used, float* parts, int B, int n_exp, int cin,
                      int cout, int h, int splits, int rps, cudaStream_t s) {
  const int words = std::max(
      TDW_ROWS * TDW_LDU + 2 * TDW_ROWS * CvDims<NT>::LDB +
          (TDW_ROWS + 2 * h) * cout + 1 + 2 * CvDims<NT>::NP,
      TDW_M * CvDims<NT>::LDP + 8 * cout);
  const size_t smem = (size_t)words * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_tdw_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((cin + TDW_M - 1) / TDW_M, splits, B);
  conv1d_train_tdw_kernel<NT><<<grid, CV_THREADS, smem, s>>>(
      dzbuf, zp, bnp, used, parts, n_exp, cin, cout, h, rps);
  return (int)cudaGetLastError();
}

// d_u, z (B, n_exp, cout); z_prev (B, n_exp, cin) (xe on layer 1); m, i,
// g, b, c1, c2 this layer's (mean, inv, gamma, beta) and the BN backward's
// (c1, c2) (cout each); pm, pi, pg, pb the previous layer's BN (cin each)
// or null; wt (h+1, cout, cin) -> d_u_prev (B, n_exp,
// cin) and sums ((h+1) cin cout + cout): dW row-major ((h+1) cin, cout),
// then db.  dW and db are summed over `splits` row ranges of `rps` slots
// (a multiple of 32; ops/conv1d_train.py dw_splits) a sample; dzbuf is
// scratch of B n_exp cout floats (dz), parts of B * splits rows of the
// sums' width; (h+1) cout <= 96.  With prev_sums (cin <= TDF_MAX and a
// previous BN) sums also holds, after db, the previous layer's reduce sums
// over d_u_prev (4 cin: dxh, dxh * xhat, da, da * xhat), as
// ccn_conv1d_train_reduce would give them.
extern "C" int ccn_conv1d_train_t(const float* du, const float* z,
                                  const float* zp, const float* m,
                                  const float* i, const float* g,
                                  const float* b, const float* c1,
                                  const float* c2, const float* pm,
                                  const float* pi, const float* pg,
                                  const float* pb, const float* wt,
                                  const int* used, float* dup, float* dzbuf,
                                  float* parts, float* sums, int B, int n_exp,
                                  int cin, int cout, int h, int splits,
                                  int rps, int prev_sums, void* stream) {
  const int nt = nt_of((h + 1) * cout);
  if (B < 1 || n_exp < 1 || cin < 1 || cout < 1 || h < 0 || nt == 0 ||
      splits < 1 || rps < 1 || rps % TDW_ROWS != 0 ||
      (long long)splits * rps < n_exp ||
      (prev_sums && (cin > TDF_MAX || pm == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Vecs coef = {{m, i, g, b, c1, c2}};
  const Vecs bnp = {{pm, pi, pg, pb, nullptr, nullptr}};
  int rc;
  if (cin <= TDF_MAX) {  // dW fused into the d_u_prev kernel, a tile a split
    if (rps != CV_ROWS || splits != (n_exp + CV_ROWS - 1) / CV_ROWS)
      return (int)cudaErrorInvalidValue;
    const int K = (h + 1) * cout;
    rc = K <= 32 ? launch_tdup<4, 1>(du, z, zp, coef, bnp, wt, used, dup,
                                     nullptr, parts, B, n_exp, cin, cout, h,
                                     prev_sums, s)
       : K <= 64 ? launch_tdup<4, 2>(du, z, zp, coef, bnp, wt, used, dup,
                                     nullptr, parts, B, n_exp, cin, cout, h,
                                     prev_sums, s)
                 : launch_tdup<4, 3>(du, z, zp, coef, bnp, wt, used, dup,
                                     nullptr, parts, B, n_exp, cin, cout, h,
                                     prev_sums, s);
  } else {
    rc = launch_tdup<12, 0>(du, z, zp, coef, bnp, wt, used, dup, dzbuf,
                            nullptr, B, n_exp, cin, cout, h, 0, s);
    if (rc != 0) return rc;
    rc = nt == 4 ? launch_tdw<4>(dzbuf, zp, bnp, used, parts, B, n_exp, cin,
                                 cout, h, splits, rps, s)
       : nt == 8 ? launch_tdw<8>(dzbuf, zp, bnp, used, parts, B, n_exp, cin,
                                 cout, h, splits, rps, s)
                 : launch_tdw<12>(dzbuf, zp, bnp, used, parts, B, n_exp, cin,
                                  cout, h, splits, rps, s);
  }
  if (rc != 0) return rc;
  return colsum(parts, B * splits,
                (h + 1) * cin * cout + cout + (prev_sums ? 4 * cin : 0), sums,
                s);
}

template <int NT, int ROWS, class TP>
static int fb_launch(const TP* zp, const Vecs& bnp, const uint32_t* img,
                     const int* used, float* z, float* parts, int B,
                     int n_exp, int cin, int cout, int h, int unit, int zvec,
                     const FbPlan& p, cudaStream_t s) {
  auto* kernel = conv1d_train_fwd_bf16_kernel<NT, ROWS, TP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, 2 * ROWS, p.smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tile = ROWS - 2 * h;
  const long long tiles = (long long)B * ((n_exp + tile - 1) / tile);
  const int grid = (int)std::min<long long>(tiles, (long long)per_sm * sms);
  kernel<<<grid, 2 * ROWS, p.smem, s>>>(zp, bnp, img, used, z, parts, B,
                                        n_exp, cin, cout, h, unit, zvec, p);
  return (int)cudaGetLastError();
}

template <int ROWS, class TP>
static int fb_rows(const TP* zp, const Vecs& bnp, const uint32_t* img,
                   const int* used, float* z, float* parts, int B, int n_exp,
                   int cin, int cout, int h, int unit, int zvec,
                   const FbPlan& p, cudaStream_t s) {
  const int nt = nt_of(cout);
  return nt == 4 ? fb_launch<4, ROWS>(zp, bnp, img, used, z, parts, B, n_exp,
                                      cin, cout, h, unit, zvec, p, s)
       : nt == 8 ? fb_launch<8, ROWS>(zp, bnp, img, used, z, parts, B, n_exp,
                                      cin, cout, h, unit, zvec, p, s)
                 : fb_launch<12, ROWS>(zp, bnp, img, used, z, parts, B,
                                       n_exp, cin, cout, h, unit, zvec, p, s);
}

template <class TP>
static int fwd_bf16(const TP* zp, const Vecs& bnp, const uint32_t* img,
                    const int* used, float* z, float* parts, int B, int n_exp,
                    int cin, int cout, int h, int zvec, const FbPlan& p,
                    cudaStream_t s) {
  // elements a copy of the input: what cin and the rows' addresses allow
  const size_t a = reinterpret_cast<size_t>(zp);
  int unit = 1;
  for (int u = 16 / (int)sizeof(TP); u > 1; u /= 2)
    if (cin % u == 0 && a % (u * sizeof(TP)) == 0) {
      unit = u;
      break;
    }
  return p.rows == 256 ? fb_rows<256>(zp, bnp, img, used, z, parts, B, n_exp,
                                      cin, cout, h, unit, zvec, p, s)
                       : fb_rows<128>(zp, bnp, img, used, z, parts, B, n_exp,
                                      cin, cout, h, unit, zvec, p, s);
}

// ccn_conv1d_train_fwd under the bfloat16 contract: z_prev (B, n_exp, cin)
// bfloat16 when zbf (xe, layer 1, no previous BN) else f32; w f32 ((h+1) cin, cout) and b (cout) as the
// caller holds them (packed into img, scratch of the plan's img_words
// words, 16-byte aligned, by the first launch); parts scratch of B
// ceil(n_exp / tile) rows of 2 cout + 1 floats; tile = rows - 2h; plan
// host ints in FbPlan's order (ops/conv1d_train.py plan_fwd_bf16);
// cout <= 96.  Three launches: the pack, the layer, the moments.
extern "C" int ccn_conv1d_train_fwd_bf16(
    const void* zp, int zbf, const float* pm, const float* pi,
    const float* pg, const float* pb, const float* w, const float* bias,
    const int* used, uint32_t* img, float* z, float* parts, float* mean,
    float* var, int B, int n_exp, int cin, int cout, int h, int tile,
    const int* plan, void* stream) {
  FbPlan p;
  int* f = reinterpret_cast<int*>(&p);
  for (int i = 0; i < (int)(sizeof(FbPlan) / sizeof(int)); ++i) f[i] = plan[i];
  if (B < 1 || n_exp < 1 || cin < 1 || cout < 1 || h < 0 ||
      tile != p.rows - 2 * h || nt_of(cout) == 0 || (zbf && pm != nullptr) ||
      reinterpret_cast<size_t>(img) % 16 != 0 ||
      !fb_fits(p, zbf, cin, cout, h))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Vecs bnp = {{pm, pi, pg, pb, nullptr, nullptr}};
  const int pack_blocks = std::min((p.img_words + 255) / 256, 132 * 4);
  conv1d_train_pack_fwd_bf16_kernel<<<pack_blocks, 256, 0, s>>>(
      w, bias, img, cin, cout, h, p);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int zvec = cout % 4 == 0 && reinterpret_cast<size_t>(z) % 16 == 0;
  rc = zbf ? fwd_bf16(static_cast<const unsigned short*>(zp), bnp, img, used,
                      z, parts, B, n_exp, cin, cout, h, zvec, p, s)
           : fwd_bf16(static_cast<const float*>(zp), bnp, img, used, z,
                      parts, B, n_exp, cin, cout, h, zvec, p, s);
  if (rc != 0) return rc;
  conv1d_train_moments_kernel<<<cout, CT_THREADS, 0, s>>>(
      parts, B * ((n_exp + tile - 1) / tile), cout, mean, var);
  return (int)cudaGetLastError();
}

template <int NTO, class TP>
static int launch_tfused_bf16(const float* du, const float* z, const TP* zp,
                              const Vecs& coef, const Vecs& bnp,
                              const uint32_t* img, const int* used,
                              float* dup, float* parts, int B, int n_exp,
                              int cin, int cout, int h, int prev_sums,
                              cudaStream_t s) {
  const size_t smem = (size_t)timg_words(cout, h, 32) * 4 +
                      (size_t)CV_ROWS * bf_ld(cout) * 2 +
                      (size_t)(CV_ROWS + 2 * TB_PAD) * TF_LDU * 2 +
                      (6 * cout + CV_THREADS + 8 * 4 * 32) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_tfused_bf16_kernel<NTO, TP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_exp + CV_ROWS - 2 * h - 1) / (CV_ROWS - 2 * h), B);
  conv1d_train_tfused_bf16_kernel<NTO, TP><<<grid, CV_THREADS, smem, s>>>(
      du, z, zp, coef, bnp, img, used, dup, parts, n_exp, cin, cout, h,
      prev_sums);
  return (int)cudaGetLastError();
}

template <class TP>
static int tfused_bf16(const float* du, const float* z, const TP* zp,
                       const Vecs& coef, const Vecs& bnp, const uint32_t* img,
                       const int* used, float* dup, float* parts, int B,
                       int n_exp, int cin, int cout, int h, int prev_sums,
                       cudaStream_t s) {
  const int nt = nt_of(cout);
  return nt == 4 ? launch_tfused_bf16<4>(du, z, zp, coef, bnp, img, used, dup,
                                         parts, B, n_exp, cin, cout, h,
                                         prev_sums, s)
       : nt == 8 ? launch_tfused_bf16<8>(du, z, zp, coef, bnp, img, used, dup,
                                         parts, B, n_exp, cin, cout, h,
                                         prev_sums, s)
                 : launch_tfused_bf16<12>(du, z, zp, coef, bnp, img, used,
                                          dup, parts, B, n_exp, cin, cout, h,
                                          prev_sums, s);
}

static int launch_tdup_bf16(const float* du, const float* z, const Vecs& coef,
                            const uint32_t* img, const int* used, float* dup,
                            float* dzbuf, int B, int n_exp, int cin, int cout,
                            int h, cudaStream_t s) {
  const size_t smem = (size_t)2 * timg_words(cout, h, 64) * 4 +
                      (size_t)CV_ROWS * bf_ld(cout) * 2 + 6 * cout * 4;
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_tdup_bf16_kernel<8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tile = CV_ROWS - 2 * h;
  dim3 grid((n_exp + tile - 1) / tile, B);
  conv1d_train_tdup_bf16_kernel<8><<<grid, CV_THREADS, smem, s>>>(
      du, z, coef, img, used, dup, dzbuf, n_exp, cin, cout, h);
  return (int)cudaGetLastError();
}

template <int NTO, class TP>
static int launch_tdw_bf16(const float* dzbuf, const TP* zp, const Vecs& bnp,
                           const int* used, float* parts, int B, int n_exp,
                           int cin, int cout, int h, int splits, int rps,
                           cudaStream_t s) {
  constexpr int TG = 12 / NTO;  // taps a block: TG NTO 8-column tiles
  const size_t smem = (size_t)(TBW_ROWS + 2 * TB_PAD) * TBW_LDU * 2 +
                      (size_t)TBW_ROWS * (((cout + 15) & ~15) + 8) * 2 +
                      CV_THREADS * 4;
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_tdw_bf16_kernel<NTO, TG, TP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(((cin + TBW_M - 1) / TBW_M) * ((h + TG) / TG), splits, B);
  conv1d_train_tdw_bf16_kernel<NTO, TG, TP><<<grid, CV_THREADS, smem, s>>>(
      dzbuf, zp, bnp, used, parts, n_exp, cin, cout, h, rps);
  return (int)cudaGetLastError();
}

template <class TP>
static int tdw_bf16(const float* dzbuf, const TP* zp, const Vecs& bnp,
                    const int* used, float* parts, int B, int n_exp, int cin,
                    int cout, int h, int splits, int rps, cudaStream_t s) {
  const int nt = nt_of(cout);
  return nt == 4 ? launch_tdw_bf16<4>(dzbuf, zp, bnp, used, parts, B, n_exp,
                                      cin, cout, h, splits, rps, s)
       : nt == 8 ? launch_tdw_bf16<8>(dzbuf, zp, bnp, used, parts, B, n_exp,
                                      cin, cout, h, splits, rps, s)
                 : launch_tdw_bf16<12>(dzbuf, zp, bnp, used, parts, B, n_exp,
                                       cin, cout, h, splits, rps, s);
}

// ccn_conv1d_train_t under the bfloat16 contract: z_prev bfloat16 when zbf
// (xe, layer 1) else f32, 16-byte aligned; w f32 ((h+1) cin, cout), as the
// forward takes it; img scratch of ceil(cin / np) timg_words(cout, h, np)
// words (np = 32 for cin <= TDF_MAX, else 64): W^T's taps packed once a
// call; h <= TB_PAD, cout <= 96.  Inputs up to TDF_MAX wide: splits, rps
// are the tiles of CV_ROWS - 2h slots, parts scratch of B * splits rows of
// (h+1) cin cout + cout (+ 4 cin with prev_sums) floats, dzbuf unused;
// with prev_sums (a previous BN) sums also holds, after db, the previous
// layer's reduce sums over d_u_prev, as ccn_conv1d_train_t gives them.
// Wider inputs: splits, rps the row splits (rps a multiple of TBW_ROWS;
// ops/conv1d_train.py dw_splits), parts of B * splits rows of (h+1) cin
// cout + cout floats, dzbuf scratch of B n_exp cout floats, no prev_sums.
extern "C" int ccn_conv1d_train_t_bf16(
    const float* du, const float* z, const void* zp, int zbf, const float* m,
    const float* i, const float* g, const float* b, const float* c1,
    const float* c2, const float* pm, const float* pi, const float* pg,
    const float* pb, const float* w, const int* used, float* dup,
    float* dzbuf, void* img, float* parts, float* sums, int B, int n_exp,
    int cin, int cout, int h, int splits, int rps, int prev_sums,
    void* stream) {
  const bool fused = cin <= TDF_MAX;
  const int tile = CV_ROWS - 2 * h;
  if (B < 1 || n_exp < 1 || cin < 1 || cout < 1 || h < 0 || h > TB_PAD ||
      nt_of(cout) == 0 || splits < 1 || rps < 1 ||
      (long long)splits * rps < n_exp || (zbf && pm != nullptr) ||
      (prev_sums && (pm == nullptr || zbf || !fused)) ||
      (fused && (rps != tile || splits != (n_exp + tile - 1) / tile)) ||
      (!fused && (rps % TBW_ROWS != 0 || dzbuf == nullptr ||
                  reinterpret_cast<uintptr_t>(zp) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Vecs coef = {{m, i, g, b, c1, c2}};
  const Vecs bnp = {{pm, pi, pg, pb, nullptr, nullptr}};
  const int np = fused ? 32 : 64;
  const int total = ((cin + np - 1) / np) * timg_words(cout, h, np);
  uint32_t* wimg = static_cast<uint32_t*>(img);
  conv1d_train_pack_wt_bf16_kernel<<<(total + CV_THREADS - 1) / CV_THREADS,
                                     CV_THREADS, 0, s>>>(w, wimg, cin, cout,
                                                         h, np, total);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const __nv_bfloat16* zb = static_cast<const __nv_bfloat16*>(zp);
  const float* zf = static_cast<const float*>(zp);
  if (fused) {
    rc = zbf ? tfused_bf16(du, z, zb, coef, bnp, wimg, used, dup, parts, B,
                           n_exp, cin, cout, h, prev_sums, s)
             : tfused_bf16(du, z, zf, coef, bnp, wimg, used, dup, parts, B,
                           n_exp, cin, cout, h, prev_sums, s);
  } else {
    rc = launch_tdup_bf16(du, z, coef, wimg, used, dup, dzbuf, B, n_exp, cin,
                          cout, h, s);
    if (rc != 0) return rc;
    rc = zbf ? tdw_bf16(dzbuf, zb, bnp, used, parts, B, n_exp, cin, cout, h,
                        splits, rps, s)
             : tdw_bf16(dzbuf, zf, bnp, used, parts, B, n_exp, cin, cout, h,
                        splits, rps, s);
  }
  if (rc != 0) return rc;
  return colsum(parts, B * splits,
                (h + 1) * cin * cout + cout + (prev_sums ? 4 * cin : 0), sums,
                s);
}
