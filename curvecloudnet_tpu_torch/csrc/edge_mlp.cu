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
// Bound on the H100: the multiply-adds, with layer 0 once a point (below)
// and the later layers on the live edges only: 0.49 ms at the FP32 rate
// for the flagship's five admitted steps; the 3xTF32 tensor-core floor
// (three TF32 products a multiply-add at 495 TFLOP/s) is ~0.2 ms.
//
// Design.
//  * Layer 0 once a point.  With W_0 = [Wt; Wb] (the x_j and x_i - x_j
//    halves), h_0 W_0 = x_j (Wt - Wb) + x_i Wb, so a projection kernel
//    computes [U | V] = x [Wt - Wb | Wb] + [0 | b_0] for every point, one
//    (rows, C) x (C, 2 H_0) 3xTF32 product (dense_mma of group_chain.cuh
//    over tiles of 64 rows x 128 columns, two blocks an SM; C padded to 8
//    with zeros in shared memory),
//    and layer 0 of edge (i, j) is U[j] + V[i]: one add, not 2C
//    multiply-adds an edge.
//  * The rest on K2's live-row chain (group_chain.cuh): a block compacts
//    its queries' live (query, slot) rows (padding queries have none: they
//    get -100 and never gather), builds each chunk's rows as
//    relu(U[j] + V[i]) from the gathered U rows and the query's V row (the
//    identity for a one-layer MLP), runs the later layers through 3xTF32
//    mma.sync with W staged by cp.async, and takes the masked max, carried
//    across a query's chunks (a query with a dead slot starts at -100).
//    Neither h_0 nor the (N, K, H) planes ever reach device memory: what
//    is read is x, the indices, the weights and [U | V] (scratch the
//    wrapper allocates), and the (N, O) output is written.
//  * bfloat16 rows (ccn_edge_mlp_bf16; a model computing in bfloat16): the
//    projection reads x as bfloat16 and widens it as it loads the tile;
//    everything after is the f32 kernel's (f32 math and output), as the
//    Pallas kernel computes in f32 on bfloat16-valued rows.

#include "group_chain.cuh"

#define EP_ROWS 64   // rows of a projection tile
#define EP_COLS 128  // its output columns: two 8-column tiles a warp
#define EP_BLOCKS 2  // projection blocks an SM (ops/edge_mlp.py sizes p_kc)

// [U | V] (rows, H2) = x (rows, C) W (C, H2) + bias, 3xTF32; a block the
// tile of EP_ROWS rows and EP_COLS columns (blockIdx.y), two blocks an SM.
// X holds the tile's input (zero from C up to a multiple of 8) and then
// its output, row stride ldx.  x is float or __nv_bfloat16 (TIn).
template <class TIn>
__global__ void __launch_bounds__(GR_THREADS, EP_BLOCKS)
    edge_project_kernel(const TIn* __restrict__ x,
                        const float* __restrict__ W,
                        const float* __restrict__ bias, float* __restrict__ P,
                        int rows, int C, int H2, int ldx, int ldw, int kc) {
  extern __shared__ float4 sm4[];
  float* Ws = reinterpret_cast<float*>(sm4);
  float* X = Ws + 2 * kc * ldw;
  const int r0 = blockIdx.x * EP_ROWS, nrow = min(EP_ROWS, rows - r0);
  const int c0 = blockIdx.y * EP_COLS, nc = min(EP_COLS, H2 - c0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const WLayer L = {W + c0, C, nc, H2,
                    (H2 & 3) == 0 &&
                        (reinterpret_cast<size_t>(W + c0) & 15) == 0};
  stage_w(Ws, ldw, L, 0, kc);
  cp_async_commit();
  const int c8 = (C + 7) & ~7;
  for (int i = tid; i < EP_ROWS * c8; i += nt) {
    const int j = i / c8, c = i - j * c8;
    X[j * ldx + c] =
        j < nrow && c < C ? load_f32(x + (size_t)(r0 + j) * C + c) : 0.f;
  }
  __syncthreads();
  int buf = 0;
  dense_mma<EP_ROWS, EP_COLS / 64>(X, ldx, X, ldx, L, bias + c0, 2,
                                          false, Ws, ldw, kc, buf, nullptr);
  float* Pt = P + (size_t)r0 * H2 + c0;
  if ((nc & 3) == 0 && (H2 & 3) == 0) {
    const int n4 = nc >> 2;
    for (int i = tid; i < nrow * n4; i += nt) {
      const int j = i / n4, c = (i - j * n4) * 4;
      *reinterpret_cast<float4*>(Pt + (size_t)j * H2 + c) =
          *reinterpret_cast<const float4*>(X + j * ldx + c);
    }
  } else {
    for (int i = tid; i < nrow * nc; i += nt) {
      const int j = i / nc, c = i - j * nc;
      Pt[(size_t)j * H2 + c] = X[j * ldx + c];
    }
  }
}

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

// The two launches of K9 on x of type TIn (ccn_edge_mlp below).
template <class TIn>
static int edge_mlp(const TIn* x, const int* nbr, const float* wproj,
                    const float* bproj, const float* wp, float* P, float* out,
                    int B, int N, int K, int C, int n_rest, const int* dims,
                    const long long* woff, const long long* boff, int rows,
                    int tq, int kc, int per_sm, int p_kc, void* stream) {
  const int H0 = dims[0], H2 = 2 * H0;
  if (B < 1 || N < 1 || C < 1 || H0 < 1 || p_kc < 8 || p_kc % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ldx = row_stride(C > EP_COLS ? C : EP_COLS);
  const int ldw = EP_COLS + 8;
  const size_t smem = (2 * (size_t)p_kc * ldw + (size_t)EP_ROWS * ldx) * 4;
  int dev, sm_smem, reserved;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return (int)e;
  if (EP_BLOCKS * (smem + reserved) > (size_t)sm_smem)
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(
      edge_project_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B * N + EP_ROWS - 1) / EP_ROWS,
                  (H2 + EP_COLS - 1) / EP_COLS);
  edge_project_kernel<TIn><<<grid, GR_THREADS, smem, st>>>(
      x, wproj, bproj, P, B * N, C, H2, ldx, ldw, p_kc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const EdgeSrc src = {P, nbr, H0, K, N, n_rest > 0 ? 0 : 2};
  return run_chain(src, wp, n_rest, 0, dims, woff, boff, 0, 0, 0, B, K,
                   N, rows, tq, kc, per_sm, out, st);
}

// x (B, N, C) f32; nbr (B, N, K) int32 with -1 padding; wproj (C, 2 H0) =
// [Wt - Wb | Wb] and bproj (2 H0,) = [0 | b_0], layer 0's projection; P
// (B, N, 2 H0) f32 scratch for [U | V]; the later layers as run_chain
// (group_chain.cuh) takes them: n_rest of them, dims[0] = H0, packed in wp
// at woff / boff (host arrays); out (B, N, dims[n_rest]) f32.  rows / tq /
// kc / per_sm: the chain's launch shape; p_kc: the projection's weight
// rows a stage, refused unless EP_BLOCKS blocks of its buffers fit an SM.
extern "C" int ccn_edge_mlp(const float* x, const int* nbr, const float* wproj,
                            const float* bproj, const float* wp, float* P,
                            float* out, int B, int N, int K, int C,
                            int n_rest, const int* dims,
                            const long long* woff, const long long* boff,
                            int rows, int tq, int kc, int per_sm, int p_kc,
                            void* stream) {
  return edge_mlp(x, nbr, wproj, bproj, wp, P, out, B, N, K, C, n_rest, dims,
                  woff, boff, rows, tq, kc, per_sm, p_kc, stream);
}

// The same with x (B, N, C) bfloat16.
extern "C" int ccn_edge_mlp_bf16(const __nv_bfloat16* x, const int* nbr,
                                 const float* wproj, const float* bproj,
                                 const float* wp, float* P, float* out, int B,
                                 int N, int K, int C, int n_rest,
                                 const int* dims, const long long* woff,
                                 const long long* boff, int rows, int tq,
                                 int kc, int per_sm, int p_kc, void* stream) {
  return edge_mlp(x, nbr, wproj, bproj, wp, P, out, B, N, K, C, n_rest, dims,
                  woff, boff, rows, tq, kc, per_sm, p_kc, stream);
}
