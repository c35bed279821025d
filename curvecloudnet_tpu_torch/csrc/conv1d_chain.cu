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
//
// The bfloat16 variant (ccn_conv1d_chain_bf16; the Pallas kernel on a
// bfloat16 row, the conv steps past the first of a model computing in
// bfloat16) rounds where that kernel does: the weights are bfloat16, each
// symmetric pair a[i-d] + a[i+d] is summed and rounded to bfloat16 BEFORE
// its product, the (h+1) products are summed in f32 (mma.sync m16n8k16,
// one product a multiply-add), the bias, leaky ReLU and live mask are
// applied in f32 and each layer's output is rounded to bfloat16.  The pair
// sums sit on the input side, so the f32 kernel's products-then-shifts
// form does not carry over: a block of CV_ROWS slots keeps its activations
// in shared memory as bfloat16 (two buffers: a layer reads one and writes
// the other) and runs, a layer at a time, the (h+1) tap products of its
// 8 warps' 16-row tiles, building each pair-sum fragment as it loads; the
// layer's taps are staged as packed bfloat16 pairs.

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

// ---- the bfloat16 variant ----------------------------------------------

#define CB_MAX_OUT 128  // widest layer output (ops/conv1d_chain.py)

struct ChainMetaBf16 {
  int n_layers;
  int dims[CCN_CONV_MAX_LAYERS + 1];
  long long woff[CCN_CONV_MAX_LAYERS];  // bfloat16 elements into wp
  long long boff[CCN_CONV_MAX_LAYERS];  // floats into bp
  int ld0, ld1;  // row strides (halves) of the layer-0 input, of the rest
  int abuf0;     // halves of activation buffer 0 (buffer 1: CV_ROWS ld1)
};

// row stride in halves of a bfloat16 buffer c wide: 8 mod 64 (4 mod 32
// words), so a warp's fragment loads are free of bank conflicts
static inline int cb_ld(int c) { return ((c + 63) & ~63) + 8; }

// Shared memory in bytes: the two activation buffers and one layer's taps,
// (h+1) (cin/2 rounded to 8) rows of (cout rounded to 8) + 8 words, the
// widest layer (ops/conv1d_chain.py _bf16_smem repeats it).
static size_t cb_smem(const ChainMetaBf16& m, int h) {
  size_t taps = 0;
  for (int l = 0; l < m.n_layers; ++l) {
    const int kp = ((m.dims[l] + 15) & ~15) / 2;
    const int ldn = ((m.dims[l + 1] + 7) & ~7) + 8;
    taps = std::max(taps, (size_t)(h + 1) * kp * ldn);
  }
  return (size_t)(m.abuf0 + CV_ROWS * m.ld1) * 2 + taps * 4;
}

template <int NT>
__global__ void __launch_bounds__(CV_THREADS, 1)
    conv1d_chain_bf16_kernel(const unsigned short* __restrict__ xe,
                             const unsigned short* __restrict__ wp,
                             const float* __restrict__ bp,
                             const int* __restrict__ used,
                             unsigned short* __restrict__ out, int n_exp,
                             int h, ChainMetaBf16 m) {
  extern __shared__ float4 cb_sm4[];
  unsigned short* A0 = reinterpret_cast<unsigned short*>(cb_sm4);
  unsigned short* A1 = A0 + m.abuf0;
  uint32_t* Wt = reinterpret_cast<uint32_t*>(A1 + CV_ROWS * m.ld1);
  const int b = blockIdx.y;
  const int pad = h * m.n_layers;
  const int tile = CV_ROWS - 2 * pad;
  const int base = blockIdx.x * tile - pad;  // slot of tile row 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int live_end = min(used[b], n_exp);
  const int c0 = m.dims[0];

  // the tile's input rows, 0 outside the row and from c0 to c0 rounded to
  // 16
  const int c016 = (c0 + 15) & ~15;
  const unsigned short* xb = xe + (size_t)b * n_exp * c0;
  for (RowCol it(threadIdx.x, c016); it.r < CV_ROWS; it.next()) {
    const int gs = base + it.r;
    A0[it.r * m.ld0 + it.c] = (gs >= 0 && gs < n_exp && it.c < c0)
                                  ? xb[(size_t)gs * c0 + it.c]
                                  : (unsigned short)0;
  }
  for (int l = 0; l < m.n_layers; ++l) {
    const int cin = m.dims[l], cout = m.dims[l + 1];
    const int kp = ((cin + 15) & ~15) / 2, cout8 = (cout + 7) & ~7;
    const int ldn = cout8 + 8, nt = cout8 / 8;
    const unsigned short* W = wp + m.woff[l];
    // the taps as bfloat16 pairs: word (d kp + k/2) ldn + n holds rows k,
    // k + 1 of tap d, column n (0 past cin and cout)
    for (int i = threadIdx.x; i < (h + 1) * kp * cout8; i += CV_THREADS) {
      const int n = i % cout8, row = i / cout8;
      const int d = row / kp, k = 2 * (row - d * kp);
      unsigned short lo = 0, hi = 0;
      if (n < cout) {
        const unsigned short* wc = W + ((size_t)d * cin + k) * cout + n;
        if (k < cin) lo = wc[0];
        if (k + 1 < cin) hi = wc[cout];
      }
      Wt[(size_t)row * ldn + n] = pack_bf16_bits(lo, hi);
    }
    __syncthreads();
    const unsigned short* in = (l & 1) ? A1 : A0;
    unsigned short* dst = (l & 1) ? A0 : A1;
    const int ldin = l == 0 ? m.ld0 : m.ld1;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    cb_taps<NT>(acc, in, ldin, r0, Wt, kp, ldn, cin, h, nt);
    // y = acc + b, leaky, 0 outside the rows whose window lies in the
    // previous layer's valid rows and outside the live slots; rounded to
    // bfloat16
    const int lo = (l + 1) * h, hi = CV_ROWS - (l + 1) * h;
    const bool last = l + 1 == m.n_layers;
    const float* bias = bp + m.boff[l];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) continue;
      const int n = 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half, gs = base + r;
        const bool keep = r >= lo && r < hi && gs >= 0 && gs < live_end;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = acc[j][2 * half + e] + (n + e < cout ? bias[n + e]
                                                              : 0.f);
          v[e] = keep && n + e < cout ? (y >= 0.f ? y : 0.01f * y) : 0.f;
        }
        const uint32_t pair = pack_bf16(v[0], v[1]);
        if (!last) {
          *reinterpret_cast<uint32_t*>(dst + r * m.ld1 + n) = pair;
        } else if (r >= pad && r < pad + tile && gs < n_exp) {
          unsigned short* o = out + ((size_t)b * n_exp + gs) * cout + n;
          if (n < cout) o[0] = (unsigned short)(pair & 0xffffu);
          if (n + 1 < cout) o[1] = (unsigned short)(pair >> 16);
        }
      }
    }
    if (!last) {  // the next layer reads 0 from cout8 to cout rounded to 16
      const int cout16 = (cout + 15) & ~15;
      for (int i = threadIdx.x; i < CV_ROWS * (cout16 - cout8);
           i += CV_THREADS) {
        const int r = i / (cout16 - cout8);
        dst[r * m.ld1 + cout8 + i - r * (cout16 - cout8)] = 0;
      }
    }
    __syncthreads();
  }
}

template <int NT>
static int cb_launch(const unsigned short* xe, const unsigned short* wp,
                     const float* bp, const int* used, unsigned short* out,
                     int n_exp, int h, const ChainMetaBf16& m, dim3 grid,
                     size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_chain_bf16_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  conv1d_chain_bf16_kernel<NT><<<grid, CV_THREADS, smem, s>>>(
      xe, wp, bp, used, out, n_exp, h, m);
  return (int)cudaGetLastError();
}

// xe (B, n_exp, dims[0]) bfloat16; wp the layers' W ((h+1)*dims[l],
// dims[l+1]) bfloat16, row-major at element woff[l]; bp their biases f32
// at boff[l]; used (B,) int32; out (B, n_exp, dims[n_layers]) bfloat16.
// dims/woff/boff are host arrays; tile as ccn_conv1d_chain; every layer
// output at most CB_MAX_OUT wide.
extern "C" int ccn_conv1d_chain_bf16(const unsigned short* xe,
                                     const unsigned short* wp,
                                     const float* bp, const int* used,
                                     unsigned short* out, int B, int n_exp,
                                     int h, int n_layers, const int* dims,
                                     const long long* woff,
                                     const long long* boff, int tile,
                                     void* stream) {
  if (n_layers < 1 || n_layers > CCN_CONV_MAX_LAYERS || h < 1 ||
      tile != CV_ROWS - 2 * h * n_layers || tile < 1 || B < 1 || n_exp < 1)
    return (int)cudaErrorInvalidValue;
  ChainMetaBf16 m;
  m.n_layers = n_layers;
  int later = 1;
  for (int l = 0; l <= n_layers; ++l) m.dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    m.woff[l] = woff[l];
    m.boff[l] = boff[l];
    if (dims[l + 1] > CB_MAX_OUT || dims[l + 1] < 1)
      return (int)cudaErrorInvalidValue;
    later = std::max(later, dims[l + 1]);
  }
  m.ld0 = cb_ld(dims[0]);
  m.ld1 = cb_ld(later);
  m.abuf0 = CV_ROWS * std::max(m.ld0, m.ld1);
  const size_t smem = cb_smem(m, h);
  const int nt = ((later + 7) & ~7) / 8;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((n_exp + tile - 1) / tile, B);
  if (nt <= 4) return cb_launch<4>(xe, wp, bp, used, out, n_exp, h, m, grid,
                                   smem, s);
  if (nt <= 8) return cb_launch<8>(xe, wp, bp, used, out, n_exp, h, m, grid,
                                   smem, s);
  return cb_launch<16>(xe, wp, bp, used, out, n_exp, h, m, grid, smem, s);
}
