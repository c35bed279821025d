// K9: the sgcnn edge MLP fused with its masked max over the neighbor slots,
// eval.
//
// Replaces curvecloudnet_tpu/ops/pallas_edge.py fused_edge_mlp_max_single
// (the Pallas kernel _edge_kernel, pallas_call at :85).  Per query i and
// slot k with j = nbr[i, k]:
//     h_0 = [x_j, x_i - x_j];  h_{l+1} = relu(h_l W_l + b_l) (hidden layers,
//     eval BN folded);  msg = h_{L-1} W_{L-1} + b_{L-1}
//     out_i = max_k (msg if j >= 0 else -100)
//
// Design: the JAX wrapper gathers the (N, K, C) neighbor planes in device
// memory before its kernel; here a block takes a tile of tq queries, reads
// their index rows and gathers the rows x_j itself into shared memory, so
// only x, the indices and the weights are read and only the (N, O) output is
// written.  The tq * K message rows of every layer stay in two shared
// buffers (ping-pong, tq * K rows of the widest activation each); layer 0
// builds [x_j, x_i - x_j] on the fly from the gathered rows and x_i.  The
// weights stream through the read-only cache.  Each thread computes a
// 4-row x OT-channel micro-tile (8 row lanes x 32 channel lanes, channels
// fastest, so weight reads coalesce and activation reads broadcast).  A tile
// whose slots are all masked (padding queries) writes -100 and stops.
//
// Bound on the H100: FP32 FMAs (every live and masked slot runs the whole
// MLP: the flagship's admitted steps do 16-48 GFLOP each).  No tensor cores
// yet (FP32 FMA, so results stay within f32 rounding of the plain version).

#include <cuda_runtime.h>

#define EM_MAXL 8
#define EM_THREADS 256
#define EM_RT 4
#define EM_MAX_FILL -100.0f

struct EdgeMeta {
  int n_layers;
  int dims[EM_MAXL + 1];  // dims[0] = 2C
  long long woff[EM_MAXL];
  long long boff[EM_MAXL];
};

// one dense over the block's rows: in (stride ld) -> out (stride ld).
// FIRST: the input is [x_j, x_i - x_j] from in (x_j, cin = C wide) and xi
// (one C-wide row per query, k rows per query); W is then (2C, cout).
template <int OT, bool FIRST>
__device__ void dense(const float* in, const float* xi, int k, int ld,
                      int rows, int cin, int cout,
                      const float* __restrict__ W,
                      const float* __restrict__ bias, bool relu, float* out) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r0 = 0; r0 < rows; r0 += 8 * EM_RT) {
    int rr[EM_RT];
    for (int i = 0; i < EM_RT; ++i) {
      const int r = r0 + ty + 8 * i;
      rr[i] = r < rows ? r : rows - 1;
    }
    for (int o0 = 0; o0 < cout; o0 += 32 * OT) {
      float acc[EM_RT][OT];
      for (int i = 0; i < EM_RT; ++i)
        for (int j = 0; j < OT; ++j) acc[i][j] = 0.f;
      for (int c = 0; c < cin; ++c) {
        float w0[OT], w1[OT];
        for (int j = 0; j < OT; ++j) {
          const int o = o0 + tx + 32 * j;
          w0[j] = o < cout ? __ldg(W + (size_t)c * cout + o) : 0.f;
          if (FIRST)
            w1[j] = o < cout ? __ldg(W + (size_t)(cin + c) * cout + o) : 0.f;
        }
        for (int i = 0; i < EM_RT; ++i) {
          const float a = in[(size_t)rr[i] * ld + c];
          if (FIRST) {
            const float d = xi[(size_t)(rr[i] / k) * cin + c] - a;
            for (int j = 0; j < OT; ++j)
              acc[i][j] = fmaf(d, w1[j], fmaf(a, w0[j], acc[i][j]));
          } else {
            for (int j = 0; j < OT; ++j) acc[i][j] = fmaf(a, w0[j], acc[i][j]);
          }
        }
      }
      for (int i = 0; i < EM_RT; ++i) {
        if (r0 + ty + 8 * i >= rows) continue;
        for (int j = 0; j < OT; ++j) {
          const int o = o0 + tx + 32 * j;
          if (o >= cout) continue;
          const float v = acc[i][j] + bias[o];
          out[(size_t)rr[i] * ld + o] = relu ? fmaxf(v, 0.f) : v;
        }
      }
    }
  }
}

template <bool FIRST>
__device__ void dense_any(const float* in, const float* xi, int k, int ld,
                          int rows, int cin, int cout, const float* W,
                          const float* bias, bool relu, float* out) {
  if (cout <= 64)
    dense<2, FIRST>(in, xi, k, ld, rows, cin, cout, W, bias, relu, out);
  else
    dense<4, FIRST>(in, xi, k, ld, rows, cin, cout, W, bias, relu, out);
}

__global__ void __launch_bounds__(EM_THREADS)
    edge_mlp_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                    const float* __restrict__ wp, float* __restrict__ out,
                    int n, int k, int c, int tq, int wmax, EdgeMeta m) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, q0 = blockIdx.x * tq;
  const int nq = min(tq, n - q0), rows = nq * k;
  float* bufa = smem;
  float* bufb = bufa + (size_t)tq * k * wmax;
  float* xi = bufb + (size_t)tq * k * wmax;
  int* idx = (int*)(xi + (size_t)tq * c);
  const float* xb = x + (size_t)b * n * c;
  const int o_w = m.dims[m.n_layers];
  float* ob = out + ((size_t)b * n + q0) * o_w;

  int live = 0;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int j = nbr[((size_t)b * n + q0) * k + i];
    idx[i] = j;
    live |= j >= 0;
  }
  if (!__syncthreads_or(live)) {
    for (int i = threadIdx.x; i < nq * o_w; i += blockDim.x)
      ob[i] = EM_MAX_FILL;
    return;
  }
  for (int i = threadIdx.x; i < rows * c; i += blockDim.x) {
    const int r = i / c, cc = i - r * c;
    const int j = idx[r];
    bufa[(size_t)r * wmax + cc] = j >= 0 ? xb[(size_t)j * c + cc] : 0.f;
  }
  for (int i = threadIdx.x; i < nq * c; i += blockDim.x)
    xi[i] = xb[(size_t)q0 * c + i];
  __syncthreads();

  float* in = bufa;
  float* nxt = bufb;
  for (int l = 0; l < m.n_layers; ++l) {
    const int cout = m.dims[l + 1];
    const float* W = wp + m.woff[l];
    const float* bias = wp + m.boff[l];
    const bool relu = l < m.n_layers - 1;
    if (l == 0)
      dense_any<true>(in, xi, k, wmax, rows, c, cout, W, bias, relu, nxt);
    else
      dense_any<false>(in, xi, k, wmax, rows, m.dims[l], cout, W, bias, relu,
                       nxt);
    __syncthreads();
    float* t = in;
    in = nxt;
    nxt = t;
  }
  for (int i = threadIdx.x; i < nq * o_w; i += blockDim.x) {
    const int q = i / o_w, o = i - q * o_w;
    float mx = -__int_as_float(0x7f800000);  // -inf
    for (int s = 0; s < k; ++s) {
      const int r = q * k + s;
      mx = fmaxf(mx, idx[r] >= 0 ? in[(size_t)r * wmax + o] : EM_MAX_FILL);
    }
    ob[i] = mx;
  }
}

// x (B, N, C) f32; nbr (B, N, K) int32 with -1 padding; wp packed weights:
// layer l's W (dims[l], dims[l+1]) row-major at woff[l], its bias at
// boff[l], dims[0] = 2C; out (B, N, dims[n_layers]) f32.  dims/woff/boff
// are host arrays; tq queries per block.
extern "C" int ccn_edge_mlp(const float* x, const int* nbr, const float* wp,
                            float* out, int B, int N, int K, int C,
                            int n_layers, const int* dims,
                            const long long* woff, const long long* boff,
                            int tq, void* stream) {
  if (n_layers < 1 || n_layers > EM_MAXL || B < 1 || N < 1 || K < 1 ||
      C < 1 || tq < 1 || dims[0] != 2 * C)
    return (int)cudaErrorInvalidValue;
  EdgeMeta m;
  m.n_layers = n_layers;
  int wmax = C;
  for (int l = 0; l <= n_layers; ++l) {
    m.dims[l] = dims[l];
    if (l >= 1 && dims[l] > wmax) wmax = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    m.woff[l] = woff[l];
    m.boff[l] = boff[l];
  }
  const size_t smem = (2 * (size_t)tq * K * wmax + (size_t)tq * C) *
                          sizeof(float) +
                      (size_t)tq * K * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      edge_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + tq - 1) / tq, B);
  edge_mlp_kernel<<<grid, EM_THREADS, smem, (cudaStream_t)stream>>>(
      x, nbr, wp, out, N, K, C, tq, wmax, m);
  return (int)cudaGetLastError();
}
