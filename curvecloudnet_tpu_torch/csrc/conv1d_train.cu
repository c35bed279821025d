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
//  * forward: a block's CV_ROWS slots (a tile of CV_ROWS - 2h and its
//    halo) as bfloat16 rows in shared memory, KCH input channels at a
//    time, times the taps packed as bfloat16 pairs; z = acc + b (f32),
//    then the tile's (count, mean, M2) as the f32 kernel takes them;
//  * t pass, d_u_prev: the block's dz (f32, written out for dW) rounded
//    to bfloat16 rows, times the packed W^T taps in column chunks;
//  * t pass, dW and db: a block a (channel chunk of TDW_M, tap d, row
//    split, sample): u's rounded pairs (transposed A) times the rounded
//    dz rows of the split's stages of TDW_ROWS slots; db from the f32 dz;
//    one partial row a (sample, split), summed by colsum (no atomics);
//  * prev_sums: the previous layer's reduce sums over d_u_prev by the
//    reduce kernel, in the same entry.
// Bound on the H100: the window products at the bfloat16 rate (989
// TFLOP/s) and the bytes of z_prev / xe, dz and d_u_prev.

#define KCH 64  // input channels a forward stage

// a bfloat16 row buffer c wide: row stride in halves, 8 mod 64
__host__ __device__ __forceinline__ int bf_ld(int c) {
  return ((c + 63) & ~63) + 8;
}

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// u at slot g, channel c of one sample's rows src (C wide, float or
// bfloat16 TP); 0 outside [0, n_exp)
template <class TP>
__device__ __forceinline__ float u_at_t(const TP* src, const Vecs& bn, int g,
                                        int c, int C, int n_exp,
                                        int live_end) {
  if (g < 0 || g >= n_exp) return 0.f;
  return u_of(load_f32(src + (size_t)g * C + c), bn, g, c, live_end);
}

// Taps d = 0..h of a row-major ((h+1) K, N) matrix M (tap d's rows d K..),
// rows k0 .. k0 + kc - 1 of each, columns n0 .. n0 + ncols - 1, packed as
// bfloat16 pairs for cb_taps: word (d kp + k/2) ldn + n holds rows k, k + 1
// (rounded to nearest even; 0 past K, kc and ncols); kp = kc rounded to 16,
// halved.
__device__ __forceinline__ void pack_taps(uint32_t* Wt, const float* M, int K,
                                          int N, int h, int k0, int kc,
                                          int n0, int ncols, int kp,
                                          int ldn) {
  const int np = ldn - 8;
  for (int i = threadIdx.x; i < (h + 1) * kp * np; i += CV_THREADS) {
    const int n = i % np, row = i / np;
    const int d = row / kp, k = 2 * (row - d * kp);
    float lo = 0.f, hi = 0.f;
    if (n < ncols) {
      const float* m = M + ((size_t)d * K + k0 + k) * N + n0 + n;
      if (k < kc && k0 + k < K) lo = __ldg(m);
      if (k + 1 < kc && k0 + k + 1 < K) hi = __ldg(m + N);
    }
    Wt[(size_t)row * ldn + n] = pack_bf16(lo, hi);
  }
}

template <int NT, class TP>
__global__ void __launch_bounds__(CV_THREADS, 1) conv1d_train_fwd_bf16_kernel(
    const TP* __restrict__ zp, Vecs bnp, const float* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ used,
    float* __restrict__ z, float* __restrict__ parts, int n_exp, int cin,
    int cout, int h, int a_words) {
  constexpr int NP = 8 * NT, LDN = NP + 8, LDA = KCH + 8;
  constexpr int KP = KCH / 2;
  extern __shared__ float4 fb_sm4[];
  unsigned short* A = reinterpret_cast<unsigned short*>(fb_sm4);
  float* zt = reinterpret_cast<float*>(fb_sm4);  // over A, after the product
  uint32_t* Wt = reinterpret_cast<uint32_t*>(fb_sm4) + a_words;
  const int b = blockIdx.y;
  const int tile = CV_ROWS - 2 * h, t0 = blockIdx.x * tile;
  const int base = t0 - h;  // slot of block row 0
  const int live_end = min(used[b], n_exp);
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const TP* src = zp + (size_t)b * n_exp * cin;
  const int nt = (cout + 7) >> 3;
  float acc[NT][4];
  zero_acc<NT>(acc);
  for (int c0 = 0; c0 < cin; c0 += KCH) {
    const int kc = min(KCH, cin - c0);
    for (int i = threadIdx.x; i < CV_ROWS * KCH; i += CV_THREADS) {
      const int r = i / KCH, c = i - r * KCH;
      A[r * LDA + c] =
          c < kc ? bf16_bits(u_at_t(src, bnp, base + r, c0 + c, cin, n_exp,
                                    live_end))
                 : (unsigned short)0;
    }
    pack_taps(Wt, w, cin, cout, h, c0, kc, 0, cout, KP, LDN);
    __syncthreads();
    cb_taps<NT>(acc, A, LDA, r0, Wt, KP, LDN, kc, h, nt);
    __syncthreads();
  }
  // z = acc + b at the tile's rows (block rows h .. h + tile - 1), into zt
  // (tile x cout, over A) and out
  const int n_out = min(tile, n_exp - t0);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1) - h, c = 8 * j + 2 * t + (e & 1);
      if (r < 0 || r >= tile || c >= cout) continue;
      const float v = acc[j][e] + bias[c];
      zt[r * cout + c] = v;
      if (r < n_out) z[((size_t)b * n_exp + t0 + r) * cout + c] = v;
    }
  __syncthreads();
  tile_moments(zt, reinterpret_cast<float*>(Wt),
               max(0, min(t0 + tile, live_end) - t0), cout,
               parts + ((size_t)b * gridDim.x + blockIdx.x) * (2 * cout + 1));
}

// t, d_u_prev: dz over the block's CV_ROWS slots (f32 into dzbuf at the
// tile's rows; 0 at dead and outside slots), rounded to bfloat16 rows, times
// W^T's taps (wt (h+1, cout, cin)) in column chunks of 8 NT.
template <int NT>
__global__ void __launch_bounds__(CV_THREADS, 1) conv1d_train_tdup_bf16_kernel(
    const float* __restrict__ du, const float* __restrict__ z, Vecs coef,
    const float* __restrict__ wt, const int* __restrict__ used,
    float* __restrict__ dup, float* __restrict__ dzbuf, int n_exp, int cin,
    int cout, int h) {
  constexpr int NP = 8 * NT, LDN = NP + 8;
  extern __shared__ float4 tb_sm4[];
  const int lda = bf_ld(cout), kp = ((cout + 15) & ~15) / 2;
  unsigned short* A = reinterpret_cast<unsigned short*>(tb_sm4);
  float* cf = reinterpret_cast<float*>(A + CV_ROWS * lda);  // 6 cout
  uint32_t* Wt = reinterpret_cast<uint32_t*>(cf + 6 * cout);
  const int b = blockIdx.y;
  const int tile = CV_ROWS - 2 * h, t0 = blockIdx.x * tile;
  const int base = t0 - h;
  const int live_end = min(used[b], n_exp);
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int i = threadIdx.x; i < 6 * cout; i += CV_THREADS)
    cf[i] = coef.v[i / cout][i % cout];
  __syncthreads();
  const int c16 = (cout + 15) & ~15;
  for (int i = threadIdx.x; i < CV_ROWS * c16; i += CV_THREADS) {
    const int r = i / c16, c = i - r * c16, q = base + r;
    float v = 0.f;
    if (c < cout && q >= 0 && q < live_end) {
      const size_t off = ((size_t)b * n_exp + q) * cout + c;
      v = dz_of(du[off], z[off], cf, c, cout);
    }
    if (c < cout && r >= h && r < h + tile && q < n_exp)
      dzbuf[((size_t)b * n_exp + q) * cout + c] = v;
    A[r * lda + c] = bf16_bits(v);
  }
  const int n_out = min(tile, n_exp - t0);
  for (int n0 = 0; n0 < cin; n0 += NP) {
    const int ncols = min(NP, cin - n0);
    pack_taps(Wt, wt, cout, cin, h, 0, cout, n0, ncols, kp, LDN);
    __syncthreads();
    float acc[NT][4];
    zero_acc<NT>(acc);
    cb_taps<NT>(acc, A, lda, r0, Wt, kp, LDN, cout, h, (ncols + 7) >> 3);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1) - h, c = 8 * j + 2 * t + (e & 1);
        if (r >= 0 && r < n_out && c < ncols)
          dup[((size_t)b * n_exp + t0 + r) * cin + n0 + c] = acc[j][e];
      }
    __syncthreads();
  }
}

// t, dW and db: block (channel chunk mc and tap d, split s, sample b) takes
// input channels TDW_M mc.. and the split's slots [s rps, (s+1) rps) (up to
// live_end + h) in stages of TDW_ROWS: the pairs of u (rounded to bfloat16,
// rebuilt from z_prev or xe, rows p - h .. of the stage) as the transposed
// A operand, the stage's dz rounded to bfloat16 as B; warp w takes channels
// 16 (w & 3).. and the stage's slots 16 (w >> 2)..; the two slot halves
// are added in a fixed order.  db (mc = d = 0 blocks): thread (k, co) adds
// the f32 dz of rows k, k + 8, .. of every stage, the 8 lanes in order.
template <int NT, class TP>
__global__ void __launch_bounds__(CV_THREADS, 1) conv1d_train_tdw_bf16_kernel(
    const float* __restrict__ dzbuf, const TP* __restrict__ zp, Vecs bnp,
    const int* __restrict__ used, float* __restrict__ parts, int n_exp,
    int cin, int cout, int h, int rps) {
  constexpr int LDU = TDW_M + 8;  // halves
  extern __shared__ float4 tw_sm4[];
  const int ldd = ((cout + 7) & ~7) + 8;  // halves
  unsigned short* U = reinterpret_cast<unsigned short*>(tw_sm4);
  unsigned short* D = U + (TDW_ROWS + 2 * h) * LDU;  // TDW_ROWS x ldd
  float* red = reinterpret_cast<float*>(tw_sm4);     // at the end, over U, D
  const int mc = blockIdx.x / (h + 1), d = blockIdx.x - mc * (h + 1);
  const int s = blockIdx.y, b = blockIdx.z;
  const int m0 = mc * TDW_M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, kh = warp >> 2;
  const int nt = (cout + 7) >> 3;
  const int live_end = min(used[b], n_exp);
  const int p_begin = s * rps;
  const int p_end = min(min(p_begin + rps, n_exp), live_end + h);
  const TP* src = zp + (size_t)b * n_exp * cin;
  const bool dbb = mc == 0 && d == 0;
  float acc[NT][4];
  zero_acc<NT>(acc);
  float dbacc[3] = {0.f, 0.f, 0.f};  // 8 cout <= 3 CV_THREADS
  for (int p0 = p_begin; p0 < p_end; p0 += TDW_ROWS) {
    for (int i = threadIdx.x; i < (TDW_ROWS + 2 * h) * TDW_M;
         i += CV_THREADS) {
      const int r = i / TDW_M, c = i - r * TDW_M;
      U[r * LDU + c] =
          m0 + c < cin ? bf16_bits(u_at_t(src, bnp, p0 - h + r, m0 + c, cin,
                                          n_exp, live_end))
                       : (unsigned short)0;
    }
    for (int i = threadIdx.x; i < TDW_ROWS * cout; i += CV_THREADS) {
      const int r = i / cout, c = i - r * cout, p = p0 + r;
      D[r * ldd + c] = p < n_exp ? bf16_bits(dzbuf[((size_t)b * n_exp + p) *
                                                   cout + c])
                                 : (unsigned short)0;
    }
    if (dbb)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i = threadIdx.x + CV_THREADS * j;
        if (i < 8 * cout) {
          const int k = i / cout, co = i - k * cout;
          for (int r = k; r < TDW_ROWS && p0 + r < n_exp; r += 8)
            dbacc[j] += dzbuf[((size_t)b * n_exp + p0 + r) * cout + co];
        }
      }
    __syncthreads();
    if (m0 + mt * 16 < cin) {
      uint32_t a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // channel m, slots k, k + 1
        const int m = mt * 16 + g + (e & 1) * 8;
        const int k = kh * 16 + 2 * t + (e >> 1) * 8;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = k + q + h;  // U row of slot p0 + k + q
          const auto u = [&](int row) {
            return __uint_as_float((uint32_t)U[row * LDU + m] << 16);
          };
          v[q] = d == 0 ? u(r) : u(r - d) + u(r + d);
        }
        a[e] = pack_bf16(v[0], v[1]);
      }
      const int k = kh * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) break;
        const int n = 8 * j + g;
        const unsigned short* dn = D + k * ldd + n;
        const uint32_t b0 = pack_bf16_bits(dn[0], dn[ldd]);
        const uint32_t b1 = pack_bf16_bits(dn[8 * ldd], dn[9 * ldd]);
        mma_bf16(acc[j], a, b0, b1);
      }
    }
    __syncthreads();
  }
  // the second slot half's sums (red: 64 x (8 NT + 4)), then db's lanes
  constexpr int LDR = 8 * NT + 4;
  float* dbl = red + TDW_M * LDR;
  if (kh == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(mt * 16 + g + 8 * (e >> 1)) * LDR + 8 * j + 2 * t + (e & 1)] =
            acc[j][e];
  }
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
        if (m0 + m < cin && n < cout)
          part[((size_t)d * cin + m0 + m) * cout + n] =
              acc[j][e] + red[m * LDR + n];
      }
  }
  if (dbb)
    for (int co = threadIdx.x; co < cout; co += CV_THREADS) {
      float v = 0.f;
      for (int k = 0; k < 8; ++k) v += dbl[k * cout + co];
      part[(size_t)(h + 1) * cin * cout + co] = v;
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

template <int NT, class TP>
static int launch_fwd_bf16(const TP* zp, const Vecs& bnp, const float* w,
                           const float* bias, const int* used, float* z,
                           float* parts, int B, int n_exp, int cin, int cout,
                           int h, int tile, cudaStream_t s) {
  const int a_words = std::max(CV_ROWS * (KCH + 8) / 2, tile * cout);
  const int w_words = std::max((h + 1) * (KCH / 2) * (8 * NT + 8), 16 * cout);
  const size_t smem = (size_t)(a_words + w_words) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_fwd_bf16_kernel<NT, TP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_exp + tile - 1) / tile, B);
  conv1d_train_fwd_bf16_kernel<NT, TP><<<grid, CV_THREADS, smem, s>>>(
      zp, bnp, w, bias, used, z, parts, n_exp, cin, cout, h, a_words);
  return (int)cudaGetLastError();
}

template <class TP>
static int fwd_bf16(const TP* zp, const Vecs& bnp, const float* w,
                    const float* bias, const int* used, float* z, float* parts,
                    int B, int n_exp, int cin, int cout, int h, int tile,
                    cudaStream_t s) {
  const int nt = nt_of(cout);
  return nt == 4 ? launch_fwd_bf16<4>(zp, bnp, w, bias, used, z, parts, B,
                                      n_exp, cin, cout, h, tile, s)
       : nt == 8 ? launch_fwd_bf16<8>(zp, bnp, w, bias, used, z, parts, B,
                                      n_exp, cin, cout, h, tile, s)
                 : launch_fwd_bf16<12>(zp, bnp, w, bias, used, z, parts, B,
                                       n_exp, cin, cout, h, tile, s);
}

// ccn_conv1d_train_fwd under the bfloat16 contract: z_prev (B, n_exp, cin)
// bfloat16 when zbf (xe, layer 1, no previous BN) else f32; w f32 (rounded
// to bfloat16 as it is staged); cout <= 96; the rest as there.
extern "C" int ccn_conv1d_train_fwd_bf16(
    const void* zp, int zbf, const float* pm, const float* pi,
    const float* pg, const float* pb, const float* w, const float* bias,
    const int* used, float* z, float* parts, float* mean, float* var, int B,
    int n_exp, int cin, int cout, int h, int tile, void* stream) {
  if (B < 1 || n_exp < 1 || cin < 1 || cout < 1 || h < 0 ||
      tile != CV_ROWS - 2 * h || tile < 1 || nt_of(cout) == 0 ||
      (zbf && pm != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Vecs bnp = {{pm, pi, pg, pb, nullptr, nullptr}};
  const int rc =
      zbf ? fwd_bf16(static_cast<const __nv_bfloat16*>(zp), bnp, w, bias,
                     used, z, parts, B, n_exp, cin, cout, h, tile, s)
          : fwd_bf16(static_cast<const float*>(zp), bnp, w, bias, used, z,
                     parts, B, n_exp, cin, cout, h, tile, s);
  if (rc != 0) return rc;
  conv1d_train_moments_kernel<<<cout, CT_THREADS, 0, s>>>(
      parts, B * ((n_exp + tile - 1) / tile), cout, mean, var);
  return (int)cudaGetLastError();
}

template <int NT>
static int launch_tdup_bf16(const float* du, const float* z, const Vecs& coef,
                            const float* wt, const int* used, float* dup,
                            float* dzbuf, int B, int n_exp, int cin, int cout,
                            int h, cudaStream_t s) {
  const int kp = ((cout + 15) & ~15) / 2;
  const size_t smem = (size_t)CV_ROWS * bf_ld(cout) * 2 + 6 * cout * 4 +
                      (size_t)(h + 1) * kp * (8 * NT + 8) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_tdup_bf16_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tile = CV_ROWS - 2 * h;
  dim3 grid((n_exp + tile - 1) / tile, B);
  conv1d_train_tdup_bf16_kernel<NT><<<grid, CV_THREADS, smem, s>>>(
      du, z, coef, wt, used, dup, dzbuf, n_exp, cin, cout, h);
  return (int)cudaGetLastError();
}

template <int NT, class TP>
static int launch_tdw_bf16(const float* dzbuf, const TP* zp, const Vecs& bnp,
                           const int* used, float* parts, int B, int n_exp,
                           int cin, int cout, int h, int splits, int rps,
                           cudaStream_t s) {
  const size_t stage = (size_t)(TDW_ROWS + 2 * h) * (TDW_M + 8) * 2 +
                       (size_t)TDW_ROWS * (((cout + 7) & ~7) + 8) * 2;
  const size_t tail = ((size_t)TDW_M * (8 * NT + 4) + 8 * cout) * 4;
  const size_t smem = std::max(stage, tail);
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_tdw_bf16_kernel<NT, TP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(((cin + TDW_M - 1) / TDW_M) * (h + 1), splits, B);
  conv1d_train_tdw_bf16_kernel<NT, TP><<<grid, CV_THREADS, smem, s>>>(
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
// (xe, layer 1) else f32; wt f32 (h+1, cout, cin) rounded to bfloat16 as it
// is staged; dzbuf scratch of B n_exp cout floats (dz, f32); parts scratch
// of B * splits rows of (h+1) cin cout + cout floats (splits, rps: the
// row splits of ops/conv1d_train.py dw_splits); with prev_sums (a previous
// BN) rparts is scratch of B * ceil(n_exp / CV_ROWS) rows of 4 cin floats
// and sums also holds, after db, the previous layer's reduce sums over
// d_u_prev, as ccn_conv1d_train_t gives them; cout <= 96.
extern "C" int ccn_conv1d_train_t_bf16(
    const float* du, const float* z, const void* zp, int zbf, const float* m,
    const float* i, const float* g, const float* b, const float* c1,
    const float* c2, const float* pm, const float* pi, const float* pg,
    const float* pb, const float* wt, const int* used, float* dup,
    float* dzbuf, float* parts, float* rparts, float* sums, int B, int n_exp,
    int cin, int cout, int h, int splits, int rps, int prev_sums,
    void* stream) {
  if (B < 1 || n_exp < 1 || cin < 1 || cout < 1 || h < 0 ||
      nt_of(cout) == 0 || CV_ROWS - 2 * h < 1 || splits < 1 || rps < 1 ||
      rps % TDW_ROWS != 0 || (long long)splits * rps < n_exp ||
      (zbf && pm != nullptr) ||
      (prev_sums && (pm == nullptr || zbf || rparts == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Vecs coef = {{m, i, g, b, c1, c2}};
  const Vecs bnp = {{pm, pi, pg, pb, nullptr, nullptr}};
  int rc = cin <= 32 ? launch_tdup_bf16<4>(du, z, coef, wt, used, dup, dzbuf,
                                           B, n_exp, cin, cout, h, s)
                     : launch_tdup_bf16<8>(du, z, coef, wt, used, dup, dzbuf,
                                           B, n_exp, cin, cout, h, s);
  if (rc != 0) return rc;
  rc = zbf ? tdw_bf16(dzbuf, static_cast<const __nv_bfloat16*>(zp), bnp, used,
                      parts, B, n_exp, cin, cout, h, splits, rps, s)
           : tdw_bf16(dzbuf, static_cast<const float*>(zp), bnp, used, parts,
                      B, n_exp, cin, cout, h, splits, rps, s);
  if (rc != 0) return rc;
  const int n_dw = (h + 1) * cin * cout + cout;
  rc = colsum(parts, B * splits, n_dw, sums, s);
  if (rc != 0 || !prev_sums) return rc;
  return reduce(dup, static_cast<const float*>(zp), bnp, used, rparts,
                sums + n_dw, B, n_exp, cin, CV_ROWS, s);
}
