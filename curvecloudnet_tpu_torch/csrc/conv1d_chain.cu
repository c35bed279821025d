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
// form does not carry over.  Bound on the H100: bytes (step_31 reads a
// 262-wide bfloat16 row of ~49k slots, ~26 MB, and does ~3 GFLOP: 0.0087
// ms), the halo's re-reads on top.  The design:
//  * taps packed once a call: conv1d_chain_bf16_pack_kernel packs every
//    layer's taps, from the float32 weights as they lie, into the
//    shared-memory image cb1_taps reads (bfloat16 pairs), the biases
//    beside it; a block copies the taps in with cp.async and keeps them
//    resident where they fit (else a layer at a time);
//  * the input streamed: layer 0's input passes through a ring of
//    `stages` chunks of CB_KC columns x the tile's rows, copied by
//    cp.async in the widest unit the row stride allows (4 bytes at 262
//    wide, 16 where C0 % 8 == 0; 0 past the row and past C0 by the copy's
//    zero fill); the pair fragments are formed from the staged chunk and
//    the products summed chunk by chunk (chunk, tap, 16-deep step:
//    ops/conv_tc.py chain_eval_model_bf16);
//  * overlap and occupancy: persistent blocks walk the tiles, the next
//    tile's first chunks in flight during this tile's later layers and
//    stores; where no layer is wider than 64, tiles of 256 slots (16 warps
//    an SM beside one copy of the taps: the pair sums and products are
//    issue-bound, and at 8 warps latency-bound); each pair is one
//    add.rn.bf16x2 (the bits of an f32 add rounded to bfloat16);
//  * whole-word stores: the last layer's rows are staged in shared memory
//    and stored as whole 16-byte words (a tile's output rows are one
//    contiguous run).

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
#define CB_MAX_STAGES 6

// The launch's plan (ops/conv1d_chain.py plan_bf16, which packs these
// fields in this order).  Image words: layer l's taps at toff[l] (word
// (d kp + k/2) ldn + n of cb_taps' layout, kp = dims[l] rounded to 16
// halved, ldn = dims[l + 1] rounded to 8 plus 8), then layer l's bias as
// floats at boff[l].
struct CbPlan {
  int n_layers;
  int dims[CCN_CONV_MAX_LAYERS + 1];
  int toff[CCN_CONV_MAX_LAYERS];
  int boff[CCN_CONV_MAX_LAYERS];
  int taps_words;  // shared words of taps: every layer's, or the widest's
  int resident;    // 1: every layer's taps stay in shared memory
  int stages;      // chunks of the input ring (2 .. CB_MAX_STAGES)
  int lda;         // row stride (halves) of the activation buffers
  int rows;        // slots a tile (256 or 128; 2 rows threads a block)
  int total;       // the image's words
  // shared memory in bytes: the taps at 0, then buffers X and Y (Y only
  // past one layer) and the ring; with the taps staged a layer at a time
  // the ring shares Y's room (no chunk loads past layer 0 there)
  int x_off, y_off, ring_off, smem;
};

// the float32 layers' weights and biases as the wrapper holds them
struct CbLayers {
  const float* w[CCN_CONV_MAX_LAYERS];  // ((h+1) dims[l], dims[l+1])
  const float* b[CCN_CONV_MAX_LAYERS];  // (dims[l+1],)
};

__host__ __device__ __forceinline__ int cb_kp(int cin) {
  return ((cin + 15) & ~15) / 2;
}
__host__ __device__ __forceinline__ int cb_ldn(int cout) {
  return ((cout + 7) & ~7) + 8;
}

// the plan's shared memory holds its parts (the wrapper lays them out)
static bool cb_fits(const CbPlan& p) {
  const int x = p.rows * p.lda * 2, ring = p.stages * p.rows * CB_LDK * 2;
  const int y = p.n_layers > 1 ? x : 0;
  if (p.x_off < p.taps_words * 4 || p.y_off < p.x_off + x ||
      p.smem > 232448 || p.x_off % 16 || p.y_off % 16 || p.ring_off % 16)
    return false;
  if (p.resident)
    return p.ring_off >= p.y_off + y && p.smem >= p.ring_off + ring;
  return p.ring_off >= p.y_off && p.smem >= p.ring_off + std::max(ring, y);
}

// The image: every word of the taps (bfloat16 pairs rounded to nearest
// even, 0 past cin and cout) and of the biases (float bits, 0 past cout).
__global__ void conv1d_chain_bf16_pack_kernel(CbLayers src, CbPlan p, int h,
                                              uint32_t* __restrict__ img) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.total;
       i += gridDim.x * blockDim.x) {
    uint32_t v = 0u;
    if (i < p.boff[0]) {
      int l = 0;
      while (l + 1 < p.n_layers && p.toff[l + 1] <= i) ++l;
      const int cin = p.dims[l], cout = p.dims[l + 1];
      const int kp = cb_kp(cin), ldn = cb_ldn(cout);
      const int r = i - p.toff[l], row = r / ldn, n = r - row * ldn;
      const int d = row / kp, k = 2 * (row - d * kp);
      float lo = 0.f, hi = 0.f;
      if (n < cout) {
        const float* w = src.w[l] + ((size_t)d * cin + k) * cout + n;
        if (k < cin) lo = __ldg(w);
        if (k + 1 < cin) hi = __ldg(w + cout);
      }
      v = pack_bf16(lo, hi);
    } else {
      int l = 0;
      while (l + 1 < p.n_layers && p.boff[l + 1] <= i) ++l;
      const int c = i - p.boff[l];
      if (c < p.dims[l + 1]) v = __float_as_uint(__ldg(src.b[l] + c));
    }
    img[i] = v;
  }
}

// y = acc + b, leaky, 0 outside the rows lo .. hi - 1 whose window lies in
// the previous layer's valid rows and outside the live slots, rounded to
// bfloat16 into dst (stride lda): columns up to cout rounded to 16 (0 past
// cout, which the next layer's last 16-deep step reads)
template <int NT>
__device__ __forceinline__ void cb_epilogue(unsigned short* dst, int lda,
                                            const float (&acc)[NT][4],
                                            const float* __restrict__ bias,
                                            int cout, int lo, int hi,
                                            int base, int live_end) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16, nt16 = ((cout + 15) & ~15) / 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt16) continue;
    const int n = 8 * j + 2 * t;
    float bb[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) bb[e] = n + e < cout ? __ldg(bias + n + e) : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half, gs = base + r;
      const bool keep = r >= lo && r < hi && gs >= 0 && gs < live_end;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = acc[j][2 * half + e] + bb[e];
        v[e] = keep && n + e < cout ? (y >= 0.f ? y : 0.01f * y) : 0.f;
      }
      *reinterpret_cast<uint32_t*>(dst + r * lda + n) = pack_bf16(v[0], v[1]);
    }
  }
}

// Persistent blocks (2 ROWS threads) over the B x ceil(n_exp / tile)
// tiles of ROWS slots.  Shared memory: the taps (every layer, or one at a
// time), the ring, activation buffers X (layers 0, 2, ..) and Y (layers 1,
// 3, ..); the last layer's buffer is the store stage.
template <int NT, int ROWS>
__global__ void __launch_bounds__(2 * ROWS, 1)
    conv1d_chain_bf16_kernel(const unsigned short* __restrict__ xe,
                             const uint32_t* __restrict__ img,
                             const int* __restrict__ used,
                             unsigned short* __restrict__ out, int B,
                             int n_exp, int h, int unit, int ovec,
                             CbPlan p) {
  extern __shared__ float4 cb_sm4[];
  char* sm = reinterpret_cast<char*>(cb_sm4);
  uint32_t* Wsm = reinterpret_cast<uint32_t*>(sm);
  unsigned short* ring = reinterpret_cast<unsigned short*>(sm + p.ring_off);
  unsigned short* X = reinterpret_cast<unsigned short*>(sm + p.x_off);
  unsigned short* Y = reinterpret_cast<unsigned short*>(sm + p.y_off);
  const int stage = ROWS * CB_LDK;
  const float* fimg = reinterpret_cast<const float*>(img);
  const int L = p.n_layers, pad = h * L, tile = ROWS - 2 * pad;
  const int tps = (n_exp + tile - 1) / tile, n_tiles = B * tps;
  const int c0 = p.dims[0], nch = (((c0 + 15) & ~15) + CB_KC - 1) / CB_KC;
  const int r0 = (threadIdx.x >> 5) * 16, cl = p.dims[L];

  auto prologue = [&](int ti) {  // chunks 0 .. stages - 2 of tile ti
    const int b = ti / tps, base = (ti - b * tps) * tile - pad;
    for (int c = 0; c < p.stages - 1; ++c) {
      if (c < nch)
        cb_issue<ROWS>(ring + c * stage, xe + (size_t)b * n_exp * c0, base,
                       n_exp, c0, c * CB_KC, unit);
      cp_async_commit();
    }
  };
  if (p.resident) cb_copy(Wsm, img, p.taps_words / 4);
  bool prefetched = false;
  for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const int b = ti / tps, t0 = (ti - b * tps) * tile, base = t0 - pad;
    const int live_end = min(__ldg(used + b), n_exp);
    const unsigned short* xb = xe + (size_t)b * n_exp * c0;
    if (!p.resident) {  // layer 0's taps, once the last tile is done
      __syncthreads();
      cb_copy(Wsm, img + p.toff[0], p.taps_words / 4);
    }
    if (!prefetched) prologue(ti);
    float acc[NT][4];
    zero_acc<NT>(acc);
    const int kp0 = cb_kp(c0), ldn0 = cb_ldn(p.dims[1]);
    const int nt0 = ((p.dims[1] + 7) & ~7) / 8;
    for (int c = 0; c < nch; ++c) {
      cb_wait_ring(p.stages);
      __syncthreads();  // chunk c landed; every warp is done with c - 1
      const int cn = c + p.stages - 1;
      if (cn < nch)
        cb_issue<ROWS>(ring + (cn % p.stages) * stage, xb, base, n_exp, c0,
                       cn * CB_KC, unit);
      cp_async_commit();
      const int k0 = c * CB_KC;
      cb1_taps<NT, ROWS>(acc, ring + (c % p.stages) * stage, CB_LDK, r0,
                         Wsm + (k0 / 2) * ldn0, kp0, ldn0,
                         min(CB_KC, c0 - k0), h, nt0);
    }
    __syncthreads();  // the ring is free
    prefetched = p.resident && ti + (int)gridDim.x < n_tiles;
    if (prefetched) prologue(ti + gridDim.x);
    cb_epilogue<NT>(X, p.lda, acc, fimg + p.boff[0], p.dims[1], h, ROWS - h,
                    base, live_end);
    __syncthreads();
    for (int l = 1; l < L; ++l) {
      const int cin = p.dims[l], cout = p.dims[l + 1];
      const uint32_t* W = Wsm + p.toff[l];
      if (!p.resident) {
        cb_copy(Wsm, img + p.toff[l], p.taps_words / 4);
        cp_async_wait<0>();
        __syncthreads();
        W = Wsm;
      }
      zero_acc<NT>(acc);
      cb1_taps<NT, ROWS>(acc, (l & 1) ? X : Y, p.lda, r0, W, cb_kp(cin),
                         cb_ldn(cout), cin, h, ((cout + 7) & ~7) / 8);
      cb_epilogue<NT>((l & 1) ? Y : X, p.lda, acc, fimg + p.boff[l], cout,
                      (l + 1) * h, ROWS - (l + 1) * h, base, live_end);
      __syncthreads();
    }
    // the tile's output rows (pad .. pad + rows - 1) are one contiguous
    // run of out: whole 16-byte words where the width allows
    const unsigned short* st = ((L - 1) & 1) ? Y : X;
    const int rows = min(tile, n_exp - t0);
    unsigned short* o = out + ((size_t)b * n_exp + t0) * cl;
    if (ovec) {
      const int w8 = cl / 8;
      for (int i = threadIdx.x; i < rows * w8; i += 2 * ROWS) {
        const int r = i / w8;
        *reinterpret_cast<uint4*>(o + (size_t)i * 8) =
            *reinterpret_cast<const uint4*>(st + (pad + r) * p.lda +
                                            (i - r * w8) * 8);
      }
    } else {
      for (int i = threadIdx.x; i < rows * cl; i += 2 * ROWS) {
        const int r = i / cl;
        o[i] = st[(pad + r) * p.lda + i - r * cl];
      }
    }
  }
  cp_async_wait<0>();
}

template <int NT, int ROWS>
static int cb_launch(const unsigned short* xe, const uint32_t* img,
                     const int* used, unsigned short* out, int B, int n_exp,
                     int h, int unit, int ovec, const CbPlan& p,
                     cudaStream_t s) {
  auto* kernel = conv1d_chain_bf16_kernel<NT, ROWS>;
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
  const int tile = ROWS - 2 * h * p.n_layers;
  const long long tiles = (long long)B * ((n_exp + tile - 1) / tile);
  const int grid = (int)std::min<long long>(tiles, (long long)per_sm * sms);
  kernel<<<grid, 2 * ROWS, p.smem, s>>>(xe, img, used, out, B, n_exp, h,
                                        unit, ovec, p);
  return (int)cudaGetLastError();
}

// xe (B, n_exp, dims[0]) bfloat16; w / b host arrays of the layers'
// float32 W ((h+1) dims[l], dims[l+1]) and bias device pointers; used (B,)
// int32; img the image's scratch (plan total words, 16-byte aligned); out
// (B, n_exp, dims[n_layers]) bfloat16; plan host ints in CbPlan's order
// (ops/conv1d_chain.py plan_bf16, plan_ints); tile = rows - 2 h n_layers
// output slots a tile.  Two launches: the image's pack, the chain.
extern "C" int ccn_conv1d_chain_bf16(const unsigned short* xe,
                                     const long long* w, const long long* b,
                                     const int* used, uint32_t* img,
                                     unsigned short* out, int B, int n_exp,
                                     int h, int tile, const int* plan,
                                     void* stream) {
  CbPlan p;
  p.n_layers = plan[0];
  const int L = p.n_layers;
  if (L < 1 || L > CCN_CONV_MAX_LAYERS || h < 1 || B < 1 || n_exp < 1)
    return (int)cudaErrorInvalidValue;
  const int* q = plan + 1;
  for (int l = 0; l <= CCN_CONV_MAX_LAYERS; ++l) p.dims[l] = *q++;
  for (int l = 0; l < CCN_CONV_MAX_LAYERS; ++l) p.toff[l] = *q++;
  for (int l = 0; l < CCN_CONV_MAX_LAYERS; ++l) p.boff[l] = *q++;
  p.taps_words = *q++;
  p.resident = *q++;
  p.stages = *q++;
  p.lda = *q++;
  p.rows = *q++;
  p.total = *q++;
  p.x_off = *q++;
  p.y_off = *q++;
  p.ring_off = *q++;
  p.smem = *q++;
  int later = 1;
  for (int l = 0; l < L; ++l) {
    if (p.dims[l + 1] > CB_MAX_OUT || p.dims[l + 1] < 1 || p.dims[l] < 1 ||
        p.toff[l] % 4)
      return (int)cudaErrorInvalidValue;
    later = std::max(later, p.dims[l + 1]);
  }
  const int nt = ((later + 15) & ~15) / 8;
  if ((p.rows != 128 && p.rows != 256) || (p.rows == 256 && nt > 8) ||
      tile != p.rows - 2 * h * L || tile < 1 || p.stages < 2 ||
      p.stages > CB_MAX_STAGES || p.taps_words % 4 || p.lda < ((later + 15) & ~15) + 8 || p.lda % 8 ||
      !cb_fits(p))
    return (int)cudaErrorInvalidValue;
  CbLayers src;
  for (int l = 0; l < CCN_CONV_MAX_LAYERS; ++l) {
    src.w[l] = l < L ? reinterpret_cast<const float*>(w[l]) : nullptr;
    src.b[l] = l < L ? reinterpret_cast<const float*>(b[l]) : nullptr;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int c0 = p.dims[0];
  int unit = 1;  // elements a copy of the input: what C0 and xe allow
  if (c0 % 2 == 0 && (size_t)xe % 4 == 0) unit = 2;
  if (c0 % 4 == 0 && (size_t)xe % 8 == 0) unit = 4;
  if (c0 % 8 == 0 && (size_t)xe % 16 == 0) unit = 8;
  const int ovec = p.dims[L] % 8 == 0 && (size_t)out % 16 == 0;
  const int pack_blocks = std::min((p.total + 255) / 256, 132 * 4);
  conv1d_chain_bf16_pack_kernel<<<pack_blocks, 256, 0, s>>>(src, p, h, img);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (p.rows == 256)
    return nt <= 4 ? cb_launch<4, 256>(xe, img, used, out, B, n_exp, h, unit,
                                       ovec, p, s)
                   : cb_launch<8, 256>(xe, img, used, out, B, n_exp, h, unit,
                                       ovec, p, s);
  if (nt <= 4)
    return cb_launch<4, 128>(xe, img, used, out, B, n_exp, h, unit, ovec, p,
                             s);
  if (nt <= 8)
    return cb_launch<8, 128>(xe, img, used, out, B, n_exp, h, unit, ovec, p,
                             s);
  return cb_launch<16, 128>(xe, img, used, out, B, n_exp, h, unit, ovec, p, s);
}
