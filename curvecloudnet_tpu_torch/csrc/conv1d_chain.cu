// K1: the whole conv1d-fast-v2 eval chain over gap-expanded rows.
//
// Replaces curvecloudnet_tpu/ops/pallas_conv1d.py conv1d_chain_eval (the
// Pallas kernel _chain_kernel).  Per layer l, for every slot i of the
// zero-stuffed sequence:
//     y[i] = a[i] W0 + sum_{d=1..h} (a[i-d] + a[i+d]) Wd + b
//     a'[i] = leaky_relu(y[i], 0.01)  if 0 <= i < used  else 0
// with BatchNorm already folded into (W, b).
//
// Bound on the H100: the multiply-adds of the window products (the
// flagship's step_31 reads a 262-wide input row and runs 3 layers of width
// 32 over ~49k slots, ~3 GFLOP; the input is read once).  Design: one block
// of 8 warps takes CV_ROWS (128) slots, its tile of CV_ROWS - 2 h L output
// slots plus the halo of h L slots each side, and runs ALL layers there,
// so intermediate activations never leave shared memory.  Each layer is
// one 3xTF32 tensor-core GEMM of the tile's rows against the stacked taps
// [W_0 | ... | W_h] (conv_tc.cuh): the input row is read once as a plain
// A operand, streamed from device memory in 32-deep stages (double-
// buffered through registers) on the first layer and read from shared
// memory on the later ones; the products P go to shared memory and the
// epilogue forms y = P_0(i) + sum_d (P_d(i-d) + P_d(i+d)) + b on the 32-wide
// side, so a layer's valid rows shrink by h each side.  The taps are read
// from the packed weights and split into TF32 (hi, lo) as they are stored.
// ~96 KB of shared memory at (h+1) C_out = 96: two blocks an SM.

#include <algorithm>

#include "conv_tc.cuh"

#define CCN_CONV_MAX_LAYERS 8

struct ChainMeta {
  int n_layers;
  int dims[CCN_CONV_MAX_LAYERS + 1];
  long long woff[CCN_CONV_MAX_LAYERS];
  long long boff[CCN_CONV_MAX_LAYERS];
  int kn;       // inner depth of the later layers' taps (max C, to 8)
  int lda_act;  // row stride of the activations (4 mod 32)
};

// Shared-memory layout in words: the first layer's stream buffers at 0;
// after its product, P (CV_ROWS x LDP) at 0, the next layer's taps (hi, lo;
// kn x LDB each) after P, the activations (CV_ROWS x lda_act) after those.
template <int NT>
__host__ __device__ inline int chain_act_off(int kn) {
  return CV_ROWS * CvDims<NT>::LDP + 2 * kn * CvDims<NT>::LDB;
}

template <int NT>
static size_t chain_smem(const ChainMeta& m) {
  const int words = chain_act_off<NT>(m.kn) + CV_ROWS * m.lda_act;
  return (size_t)std::max(words, stream_words<NT>()) * sizeof(float);
}

// all kn rows of a later layer's stacked taps into (hi, lo), split
template <int NT>
__device__ __forceinline__ void stage_taps(uint32_t* Bn, int kn,
                                           const float* W, int cin, int cout,
                                           int h) {
  constexpr int NP = CvDims<NT>::NP, LDB = CvDims<NT>::LDB;
  for (int i = threadIdx.x; i < kn * NP; i += CV_THREADS) {
    const int k = i / NP, n = i - k * NP;
    float v = 0.f;
    if (k < cin && n < (h + 1) * cout) {
      const int d = n / cout;
      v = W[((size_t)d * cin + k) * cout + (n - d * cout)];
    }
    put_split(Bn, Bn + kn * LDB, k * LDB + n, v);
  }
}

template <int NT>
__global__ void __launch_bounds__(CV_THREADS, 2)
    conv1d_chain_kernel(const float* __restrict__ xe,
                        const float* __restrict__ wp,
                        const int* __restrict__ used, float* __restrict__ out,
                        int n_exp, int h, ChainMeta m) {
  constexpr int LDP = CvDims<NT>::LDP, LDB = CvDims<NT>::LDB;
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int pad = h * m.n_layers;
  const int tile = CV_ROWS - 2 * pad;
  const int t0 = blockIdx.x * tile;
  const int base = t0 - pad;  // slot of tile row 0
  const int r0 = (threadIdx.x >> 5) * 16;
  const int live_end = min(used[b], n_exp);
  float* P = smem;
  uint32_t* Bn = reinterpret_cast<uint32_t*>(smem + CV_ROWS * LDP);
  float* act = smem + chain_act_off<NT>(m.kn);
  const int c0 = m.dims[0];
  const float* xb = xe + (size_t)b * n_exp * c0;

  float acc[NT][4];
  for (int l = 0; l < m.n_layers; ++l) {
    const int cin = m.dims[l], cout = m.dims[l + 1];
    const float* W = wp + m.woff[l];
    const float* bias = wp + m.boff[l];
    zero_acc<NT>(acc);
    if (l == 0) {
      gemm_stream<NT>(
          acc, smem, reinterpret_cast<uint32_t*>(smem + 2 * CV_ROWS * CV_LDA),
          cin,
          [&](int c, float(&ra)[16]) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int idx = threadIdx.x + CV_THREADS * j;
              const int g = base + (idx >> 5), k = c * CV_KC + (idx & 31);
              ra[j] = (g >= 0 && g < n_exp && k < c0)
                          ? __ldg(xb + (size_t)g * c0 + k)
                          : 0.f;
            }
          },
          [&](int c, float(&rb)[NT]) {
#pragma unroll
            for (int j = 0; j < NT; ++j)
              rb[j] = tap_at<NT>(W, cin, cout, h, c * CV_KC, j);
          });
    } else {
      warp_mma<NT, false>(acc, act, m.lda_act, r0, Bn, Bn + m.kn * LDB, LDB,
                          (cin + 7) / 8);
      __syncthreads();
    }
    store_acc<NT>(P, LDP, r0, acc);
    if (l + 1 < m.n_layers)
      stage_taps<NT>(Bn, m.kn, wp + m.woff[l + 1], cout, m.dims[l + 2], h);
    __syncthreads();
    // rows whose whole window lies in the previous layer's valid rows
    const int lo = (l + 1) * h, hi = CV_ROWS - (l + 1) * h;
    const bool last = l + 1 == m.n_layers;
    const int cw = last ? cout : (cout + 7) & ~7;  // zero the padding columns
    for (RowCol it(threadIdx.x, cw); it.r < CV_ROWS; it.next()) {
      const int r = it.r, co = it.c;
      const int g = base + r;
      float a = 0.f;
      if (r >= lo && r < hi && co < cout && g >= 0 && g < live_end) {
        const float y = shift_sum(P, LDP, r, co, cout, h) + bias[co];
        a = y >= 0.f ? y : 0.01f * y;
      }
      if (!last)
        act[r * m.lda_act + co] = a;
      else if (r >= pad && r < pad + tile && g < n_exp)
        out[((size_t)b * n_exp + g) * cout + co] = a;
    }
    __syncthreads();
  }
}

template <int NT>
static int launch_chain(const float* xe, const float* wp, const int* used,
                        float* out, int B, int n_exp, int h, int tile,
                        const ChainMeta& m, cudaStream_t s) {
  const size_t smem = chain_smem<NT>(m);
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_chain_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_exp + tile - 1) / tile, B);
  conv1d_chain_kernel<NT><<<grid, CV_THREADS, smem, s>>>(xe, wp, used, out,
                                                         n_exp, h, m);
  return (int)cudaGetLastError();
}

// xe (B, n_exp, dims[0]) f32; wp packed weights: layer l's W ((h+1)*dims[l],
// dims[l+1]) row-major at woff[l], its bias at boff[l]; used (B,) int32;
// out (B, n_exp, dims[n_layers]) f32.  dims/woff/boff are host arrays;
// tile = CV_ROWS - 2 h n_layers output slots a block (ops/conv1d_chain.py
// tile_rows); (h+1) dims[l+1] <= 96 for every layer.
extern "C" int ccn_conv1d_chain(const float* xe, const float* wp,
                                const int* used, float* out, int B, int n_exp,
                                int h, int n_layers, const int* dims,
                                const long long* woff, const long long* boff,
                                int tile, void* stream) {
  if (n_layers < 1 || n_layers > CCN_CONV_MAX_LAYERS || h < 1 ||
      tile != CV_ROWS - 2 * h * n_layers || tile < 1 || B < 1 || n_exp < 1)
    return (int)cudaErrorInvalidValue;
  ChainMeta m;
  m.n_layers = n_layers;
  int cmax = 1, nmax = 1;
  for (int l = 0; l <= n_layers; ++l) m.dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    m.woff[l] = woff[l];
    m.boff[l] = boff[l];
    if (l >= 1 && dims[l] > cmax) cmax = dims[l];
    if ((h + 1) * dims[l + 1] > nmax) nmax = (h + 1) * dims[l + 1];
  }
  m.kn = (cmax + 7) & ~7;
  m.lda_act = ((cmax + 31) & ~31) + 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (nmax <= 32)
    return launch_chain<4>(xe, wp, used, out, B, n_exp, h, tile, m, s);
  if (nmax <= 64)
    return launch_chain<8>(xe, wp, used, out, B, n_exp, h, tile, m, s);
  if (nmax <= 96)
    return launch_chain<12>(xe, wp, used, out, B, n_exp, h, tile, m, s);
  return (int)cudaErrorInvalidValue;
}
