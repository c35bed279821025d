// K9: the sgcnn edge MLP fused with its masked max over the neighbor slots,
// eval.
//
// Replaces curvecloudnet_tpu/ops/pallas_edge.py fused_edge_mlp_max_single
// (the Pallas kernel _edge_kernel, pallas_call at :85).  Per query i and
// slot k with j = nbr[i, k]:
//     h_0 = [x_j, x_i - x_j];  h_{l+1} = relu(h_l W_l + b_l) (hidden layers,
//     eval BN folded);  msg = h_{L-1} W_{L-1} + b_{L-1}
//     out_i = max_k (msg if j >= 0 else -100)
// in float32 whatever x's dtype (a bfloat16 x is widened; the Pallas kernel
// casts x and W to f32), every product f32-accurate (3xTF32).
//
// Bound on the H100: the multiply-adds, with layer 0 once a point (below)
// and the later layers on the live edges only, at the 3xTF32 tensor-core
// floor (three TF32 products a multiply-add at 495 TFLOP/s), or the bytes
// of x, the indices, the gathered [U | V] rows and the output where those
// take longer (chip_smoke.py's bound).  Design:
//  * Weights packed once a call on the device (edge_pack_kernel), from the
//    f32 tensors as the caller holds them: layer 0's projection weights
//    [Wt - Wb | Wb] split into tf32 (hi, lo) images in tiles of EP_COLS
//    columns, its bias [0 | b_0], and every later layer's W and bias in the
//    layout K2's chain reads (group_chain.cuh run_chain).  No host copy or
//    cast of the weights; the plan (ops/edge_mlp.py plan) is cached by
//    shape.
//  * Layer 0 once a point: with W_0 = [Wt; Wb], h_0 W_0 = x_j (Wt - Wb) +
//    x_i Wb, so edge_project_kernel computes [U | V] = x [Wt - Wb | Wb] +
//    [0 | b_0] a tile of EP_ROWS rows x EP_COLS columns at a time (mma.sync
//    3xTF32); the tile's rows of x are one contiguous run, read by 16-byte
//    loads; the weight stages (hi, lo) come in by 16-byte cp.async,
//    double-buffered.  A bfloat16 x is exact in tf32: its lo part is 0, so
//    its product is left out (LO = false) and K9-bf16 equals f32 K9 on the
//    widened rows bit for bit.  Layer 0 of edge (i, j) is then U[j] + V[i]:
//    one add, not 2C multiply-adds an edge.
//  * The rest on K2's live-row chain (group_chain.cuh, shared with K2): a
//    block compacts its queries' live (query, slot) rows (padding queries
//    have none: they get -100 and never gather), builds each chunk's rows
//    as relu(U[j] + V[i]) from the gathered U rows and the query's V row
//    (EdgeSrc; the identity for a one-layer MLP), runs the later layers
//    through 3xTF32 mma.sync with W staged by cp.async, and takes the
//    masked max, carried across a query's chunks (a query with a dead slot
//    starts at -100).
// Neither h_0 nor the (N, K, H) planes reach device memory: what is read
// is x, the indices, the weights and [U | V] (scratch the wrapper
// allocates), and the (N, O) output is written.

#include <algorithm>

#include <cuda_bf16.h>

#include "group_chain.cuh"

#define EP_ROWS 64    // rows of a projection tile
#define EP_COLS 128   // its output columns: 16 a warp
#define EP_LDW 136    // a weight stage's row stride in words (8 mod 32)
#define EP_BLOCKS 2   // projection blocks an SM (ops/edge_mlp.py sizes kc)
#define EM_MAX_LAYERS 8

// The launch's plan (ops/edge_mlp.py plan, which packs these fields in
// this order).  Image words: layer 0's projection weights, hi at 0 and lo
// at p_lo (ntile tiles of c8 rows x EP_COLS, c8 = C rounded to 8), its bias
// at p_b (ntile EP_COLS floats); from w_first, later layer l's (1 .. L-1,
// from dims[l] to dims[l + 1] columns) f32 W row-major at woff[l] (16-byte
// aligned), then the biases, b_l at boff[l].  The chain's launch shape
// (ops/edge_mlp.py _chain_shape): rows a chunk, queries a block, weight
// rows a stage, blocks an SM.
struct EmPlan {
  int L;                          // layers
  int dims[EM_MAX_LAYERS + 1];    // 2C, H_0, ... (dims[0] unused)
  int c8, ntile, p_lo, p_b;       // the projection's image
  int kc, p_smem;                 // its weight rows a stage, shared memory
  int woff[EM_MAX_LAYERS], boff[EM_MAX_LAYERS];
  int w_first, total;             // the later layers' first word; the image's
  int rows, tq, ck, per_sm;       // the chain's launch shape
};

// ---- the weight pack --------------------------------------------------

// the pointers of the layers' f32 weights and biases as the caller holds
// them: w[l] (dims[l], dims[l + 1]), b[l] (dims[l + 1]); layer 0's w is
// (2C, H_0)
struct EmLayers {
  const float* w[EM_MAX_LAYERS];
  const float* b[EM_MAX_LAYERS];
};

// Every word of the image (0 past the weights' rows and columns).
__global__ void edge_pack_kernel(EmLayers src, EmPlan p, int C,
                                 uint32_t* __restrict__ img) {
  const int H0 = p.dims[1], H2 = 2 * H0;
  const int tile_words = p.c8 * EP_COLS;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.total;
       i += gridDim.x * blockDim.x) {
    uint32_t v = 0u;
    if (i < p.p_b) {  // projection weights, hi or lo
      const bool lo = i >= p.p_lo;
      const int r = i - (lo ? p.p_lo : 0);
      const int t = r / tile_words, rr = r - t * tile_words;
      const int k = rr / EP_COLS, n = t * EP_COLS + rr - k * EP_COLS;
      if (k < C && n < H2) {
        const float* w0 = src.w[0];
        const float wb = __ldg(w0 + (size_t)(C + k) * H0 + (n % H0));
        const float w = n < H0 ? __fsub_rn(__ldg(w0 + (size_t)k * H0 + n), wb)
                               : wb;
        const uint32_t h = tf32_rna(w);
        v = lo ? tf32_lo(w, h) : h;
      }
    } else if (i < p.w_first) {  // projection bias [0 | b_0]
      const int n = i - p.p_b;
      if (n >= H0 && n < H2) v = __float_as_uint(__ldg(src.b[0] + n - H0));
    } else {  // later layers: f32 W, then the biases
      for (int l = 1; l < p.L; ++l) {
        const int cin = p.dims[l], cout = p.dims[l + 1];
        if (i >= p.woff[l] && i < p.woff[l] + cin * cout)
          v = __float_as_uint(__ldg(src.w[l] + i - p.woff[l]));
        else if (i >= p.boff[l] && i < p.boff[l] + cout)
          v = __float_as_uint(__ldg(src.b[l] + i - p.boff[l]));
      }
    }
    img[i] = v;
  }
}

// ---- layer 0's projection ---------------------------------------------

// a 16-byte word of x as floats: 4 f32 or 8 bfloat16 elements
template <class TIn>
struct XWord;
template <>
struct XWord<float> {
  static constexpr int N = 4;
  __device__ static void get(const float* p, float (&v)[8]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
};
template <>
struct XWord<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void get(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
};

// [U | V] (rows, H2) = x (rows, C) W + bias, 3xTF32 (LO: the x_lo product
// too; a bfloat16 x is exact in tf32, so its lo part is 0 and its product
// is left out); a block the tile of EP_ROWS rows and EP_COLS columns
// (blockIdx.y), warp w its columns 16 w .. 16 w + 15, EP_BLOCKS blocks an
// SM.  Shared memory: x's tile as f32 at row stride ldx (4 mod 32; split
// into (hi, lo) as its fragments load when LO), then two weight stages of
// kc rows, hi then lo, row stride EP_LDW.
template <class TIn, bool LO>
__global__ void __launch_bounds__(256, EP_BLOCKS)
    edge_project_kernel(const TIn* __restrict__ x,
                        const uint32_t* __restrict__ img,
                        float* __restrict__ P, int rows, int C, EmPlan p) {
  extern __shared__ float4 ep_sm4[];
  uint32_t* Ah = reinterpret_cast<uint32_t*>(ep_sm4);
  const int c8 = p.c8, ldx = ((c8 + 31) & ~31) + 4;
  uint32_t* Ws = Ah + EP_ROWS * ldx;
  const int kc = p.kc, stage = 2 * kc * EP_LDW;
  const int H2 = 2 * p.dims[1];
  const int r0 = blockIdx.x * EP_ROWS, nrow = min(EP_ROWS, rows - r0);
  const int tile = blockIdx.y, c0 = tile * EP_COLS;
  const uint32_t* Wh = img + (size_t)tile * c8 * EP_COLS;
  const uint32_t* Wl = Wh + p.p_lo;
  const int nst = (c8 + kc - 1) / kc;
  auto issue = [&](int s) {  // stage s: kc rows of hi and lo
    uint32_t* d = Ws + (s & 1) * stage;
    const int k0 = s * kc, nk = min(kc, c8 - k0);
    for (int i = threadIdx.x; i < 2 * nk * (EP_COLS / 4); i += blockDim.x) {
      const int half = i / (nk * (EP_COLS / 4));
      const int j = i - half * nk * (EP_COLS / 4);
      const int k = j / (EP_COLS / 4), c = (j - k * (EP_COLS / 4)) * 4;
      cp_async16(d + half * kc * EP_LDW + k * EP_LDW + c,
                 (half ? Wl : Wh) + (size_t)(k0 + k) * EP_COLS + c);
    }
    cp_async_commit();
  };
  issue(0);
  // the tile's rows are one contiguous run of x (r0 C elements in, a
  // multiple of 16 bytes): 16-byte words, then any tail element by element
  constexpr int EW = XWord<TIn>::N;
  const long long e0 = (long long)r0 * C;
  const int E = nrow * C, nw = E / EW;
  for (int i = threadIdx.x; i < nw + (E - nw * EW); i += blockDim.x) {
    float v[8];
    int n = EW, idx = i * EW;
    if (i < nw) {
      XWord<TIn>::get(x + e0 + idx, v);
    } else {
      idx = nw * EW + (i - nw);
      v[0] = load_f32(x + e0 + idx);
      n = 1;
    }
    int r = idx / C, c = idx - r * C;
    for (int e = 0; e < n; ++e) {
      Ah[r * ldx + c] = __float_as_uint(v[e]);
      if (++c == C) c = 0, ++r;
    }
  }
  for (int i = threadIdx.x; i < EP_ROWS * (c8 - C); i += blockDim.x) {
    const int r = i / (c8 - C);
    Ah[r * ldx + C + i - r * (c8 - C)] = 0u;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* bh = Ws + (s & 1) * stage;
    const uint32_t* bl = bh + kc * EP_LDW;
    const int nk = min(kc, c8 - s * kc);
    for (int kk = 0; kk < nk; kk += 8) {
      const int k = s * kc + kk;
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = (16 * i + g) * ldx + k + t;
        const uint32_t a[4] = {Ah[o], Ah[o + 8 * ldx], Ah[o + 4],
                               Ah[o + 8 * ldx + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (LO) {
            const float f = __uint_as_float(a[e]);
            ah[i][e] = tf32_rna(f);
            al[i][e] = tf32_lo(f, ah[i][e]);
          } else {
            ah[i][e] = a[e];  // a bfloat16 value: tf32 as it is
          }
        }
      }
      uint32_t h[2][2], l[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = (kk + t) * EP_LDW + 16 * warp + 8 * j + g;
        h[j][0] = bh[o];
        h[j][1] = bh[o + 4 * EP_LDW];
        l[j][0] = bl[o];
        l[j][1] = bl[o + 4 * EP_LDW];
      }
      // each accumulator takes (x_lo * W_hi,) x_hi * W_lo, x_hi * W_hi in
      // turn; the eight accumulators' products interleave
      if (LO) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_tf32(acc[i][j], al[i], h[j][0], h[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_tf32(acc[i][j], ah[i], l[j][0], l[j][1]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_tf32(acc[i][j], ah[i], h[j][0], h[j][1]);
    }
    __syncthreads();
  }
  const float* bias = reinterpret_cast<const float*>(img) + p.p_b;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = c0 + 16 * warp + 8 * j + 2 * t;
    if (n >= H2) continue;  // H2 and n are even: n + 1 < H2 too
    const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * i + g + 8 * hh;
        if (r < nrow)
          *reinterpret_cast<float2*>(P + (size_t)(r0 + r) * H2 + n) =
              make_float2(acc[i][j][2 * hh] + b0, acc[i][j][2 * hh + 1] + b1);
      }
  }
}

// ---- the chain's rows --------------------------------------------------

// K9's rows: layer 0 of edge (i = query m, j = nbr[m, k]) is U[j] + V[i]
// from P (B, M, 2 c1) = [U | V], then the activation (relu; the identity
// when layer 0 is the last).
struct EdgeSrc {
  const float* P;
  const int* nbr;  // (B, M, K), -1 padding
  int c1, K, M, act;

  __device__ __forceinline__ int nb(int b, int m, int k) const {
    return __ldg(nbr + ((size_t)b * M + m) * K + k);
  }

  __device__ __forceinline__ bool live(int b, int m, int k) const {
    return nb(b, m, k) >= 0;
  }

  __device__ bool same_planes(int, int, int, int) const { return false; }

  __device__ void load(float* dst, int ld, const unsigned short* list,
                       int r0, int nrow, int rows, int b, int m0,
                       int ms) const {
    const int tid = threadIdx.x, nt = blockDim.x;
    const float* Pb = P + (size_t)b * M * 2 * c1;
    if ((c1 & 3) == 0) {
      const int c4 = c1 >> 2;
      for (int i = tid; i < rows * c4; i += nt) {
        const int j = i / c4, c = (i - j * c4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < nrow) {
          const int e = list[r0 + j];
          const int q = e >> GR_QBITS, k = e & ((1 << GR_QBITS) - 1);
          const int m = m0 + q * ms;
          const float4 u = __ldg(reinterpret_cast<const float4*>(
              Pb + (size_t)nb(b, m, k) * 2 * c1 + c));
          const float4 w = __ldg(reinterpret_cast<const float4*>(
              Pb + (size_t)m * 2 * c1 + c1 + c));
          v = make_float4(act_fn(u.x + w.x, act), act_fn(u.y + w.y, act),
                          act_fn(u.z + w.z, act), act_fn(u.w + w.w, act));
        }
        *reinterpret_cast<float4*>(dst + j * ld + c) = v;
      }
    } else {
      for (int i = tid; i < rows * c1; i += nt) {
        const int j = i / c1, c = i - j * c1;
        float v = 0.f;
        if (j < nrow) {
          const int e = list[r0 + j];
          const int q = e >> GR_QBITS, k = e & ((1 << GR_QBITS) - 1);
          const int m = m0 + q * ms;
          v = act_fn(__ldg(Pb + (size_t)nb(b, m, k) * 2 * c1 + c) +
                         __ldg(Pb + (size_t)m * 2 * c1 + c1 + c),
                     act);
        }
        dst[j * ld + c] = v;
      }
    }
  }
};

// ---- the entries --------------------------------------------------------

static bool em_plan_ok(const EmPlan& p, int C) {
  if (p.L < 1 || p.L > EM_MAX_LAYERS || p.c8 != ((C + 7) & ~7) ||
      p.dims[0] != 2 * C || p.kc < 8 || p.kc % 8 ||
      EP_BLOCKS * (p.p_smem + 1024) > 233472 ||
      p.p_smem < 4 * (EP_ROWS * ((((C + 7) & ~7) + 31) / 32 * 32 + 4) +
                      4 * p.kc * EP_LDW) ||
      p.total % 4 || p.w_first % 4)
    return false;
  for (int l = 1; l < p.L; ++l)
    if (p.woff[l] % 4 || p.woff[l] < p.w_first ||
        p.boff[l] + p.dims[l + 1] > p.total)
      return false;
  return true;
}

// Reads the plan and packs the image, then projects [U | V] into P: the
// first two launches of a call.
template <class TIn>
static int edge_project(const TIn* x, const long long* w, const long long* b,
                        uint32_t* img, float* P, int B, int N, int C,
                        const int* plan, EmPlan& p, cudaStream_t st) {
  int* f = reinterpret_cast<int*>(&p);
  for (int i = 0; i < (int)(sizeof(EmPlan) / sizeof(int)); ++i) f[i] = plan[i];
  if (B < 1 || N < 1 || C < 1 || !em_plan_ok(p, C) ||
      reinterpret_cast<size_t>(x) % 16 != 0 ||
      reinterpret_cast<size_t>(img) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  EmLayers src;
  for (int l = 0; l < EM_MAX_LAYERS; ++l) {
    src.w[l] = l < p.L ? reinterpret_cast<const float*>(w[l]) : nullptr;
    src.b[l] = l < p.L ? reinterpret_cast<const float*>(b[l]) : nullptr;
  }
  const int pack_blocks = std::min((p.total + 255) / 256, 132 * 4);
  edge_pack_kernel<<<pack_blocks, 256, 0, st>>>(src, p, C, img);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr bool LO = sizeof(TIn) == 4;
  auto* proj = edge_project_kernel<TIn, LO>;
  e = cudaFuncSetAttribute(proj, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           p.p_smem);
  if (e != cudaSuccess) return (int)e;
  const int H2 = 2 * p.dims[1];
  const dim3 pgrid((B * N + EP_ROWS - 1) / EP_ROWS,
                   (H2 + EP_COLS - 1) / EP_COLS);
  proj<<<pgrid, 256, p.p_smem, st>>>(x, img, P, B * N, C, p);
  return (int)cudaGetLastError();
}

// The pack, the projection, then the chain over [U | V].
template <class TIn>
static int edge_mlp(const TIn* x, const int* nbr, const long long* w,
                    const long long* b, uint32_t* img, float* P, float* out,
                    int B, int N, int K, int C, const int* plan,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  EmPlan p;
  int rc = edge_project(x, w, b, img, P, B, N, C, plan, p, st);
  if (rc != 0) return rc;
  const int n_rest = p.L - 1;
  long long woff[EM_MAX_LAYERS], boff[EM_MAX_LAYERS];
  for (int l = 0; l < EM_MAX_LAYERS; ++l) {
    woff[l] = l < n_rest ? p.woff[l + 1] : 0;
    boff[l] = l < n_rest ? p.boff[l + 1] : 0;
  }
  const EdgeSrc esrc = {P, nbr, p.dims[1], K, N, n_rest > 0 ? 0 : 2};
  return run_chain(esrc, reinterpret_cast<const float*>(img), n_rest, 0,
                   p.dims + 1, woff, boff, 0, 0, 0, B, K, N, p.rows, p.tq,
                   p.ck, p.per_sm, out, st);
}

// x (B, N, C) f32, 16-byte aligned; nbr (B, N, K) int32 with -1 padding;
// w / b host arrays of the layers' f32 weight and bias device pointers as
// the caller holds them (layer 0's W (2C, H_0), then (dims[l], dims[l+1]));
// img scratch of the plan's total words (16-byte aligned), packed by the
// first launch; P (B, N, 2 H_0) f32 scratch for [U | V]; out (B, N,
// dims[L]) f32; plan host ints in EmPlan's order (ops/edge_mlp.py plan).
// Three launches: the pack, the projection, the chain.
extern "C" int ccn_edge_mlp(const float* x, const int* nbr,
                            const long long* w, const long long* b,
                            uint32_t* img, float* P, float* out, int B, int N,
                            int K, int C, const int* plan, void* stream) {
  return edge_mlp(x, nbr, w, b, img, P, out, B, N, K, C, plan, stream);
}

// The same with x (B, N, C) bfloat16 (its lo product left out).
extern "C" int ccn_edge_mlp_bf16(const __nv_bfloat16* x, const int* nbr,
                                 const long long* w, const long long* b,
                                 uint32_t* img, float* P, float* out, int B,
                                 int N, int K, int C, const int* plan,
                                 void* stream) {
  return edge_mlp(x, nbr, w, b, img, P, out, B, N, K, C, plan, stream);
}

// Layer 0's projection alone (the pack and the projection of a call, as
// ccn_edge_mlp runs them): [U | V] into P, x f32 or bfloat16.
extern "C" int ccn_edge_project(const float* x, const long long* w,
                                const long long* b, uint32_t* img, float* P,
                                int B, int N, int C, const int* plan,
                                void* stream) {
  EmPlan p;
  return edge_project(x, w, b, img, P, B, N, C, plan, p,
                      (cudaStream_t)stream);
}

extern "C" int ccn_edge_project_bf16(const __nv_bfloat16* x,
                                     const long long* w, const long long* b,
                                     uint32_t* img, float* P, int B, int N,
                                     int C, const int* plan, void* stream) {
  EmPlan p;
  return edge_project(x, w, b, img, P, B, N, C, plan, p,
                      (cudaStream_t)stream);
}
