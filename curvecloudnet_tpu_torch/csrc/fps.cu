// K6: farthest point sampling, the serial pick loop.
//
// Replaces curvecloudnet_tpu/ops/pallas_fps.py _fps_pallas_batched (the
// Pallas kernel _fps_kernel).  For each batch row, `budget` picks: pick i
// is `last`; every point's running min squared distance to the picks is
// updated with its distance to `last`, and the next `last` is the argmax of
// that field over valid points (invalid points hold -1e30 and are never
// chosen), ties to the lowest index as jnp.argmax.  The output is the pick
// order; the ascending sort and slot validity stay in PyTorch.
//
// Bound on the H100: latency.  The picks are serial, so the cost is
// budget x (one sweep of N points + one block-wide argmax).  Design: one
// block of 1024 threads per row; positions live in shared memory (12 B a
// point: 216 KB at the KITTI 18432-point row) and each thread keeps the
// min-distance field of its PER points (j = tid + t * 1024) in registers,
// so each pick touches no device memory; the argmax is a warp-shuffle
// reduction then one across the 32 warps.  Distances use round-to-nearest
// intrinsics in the order (dx*dx + dy*dy) + dz*dz, with no FMA contraction,
// so they equal the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

__device__ __forceinline__ void argmax_merge(float& bv, int& bi, float ov,
                                             int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    argmax_merge(bv, bi, ov, oi);
  }
}

#define FPS_THREADS 1024

template <int PER>
__global__ void __launch_bounds__(FPS_THREADS)
    fps_kernel(const float* __restrict__ pos,
               const unsigned char* __restrict__ valid,
               const int* __restrict__ start, int* __restrict__ out, int N,
               int budget) {
  extern __shared__ float sm[];
  float* px = sm;
  float* py = px + N;
  float* pz = py + N;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* pb = pos + (size_t)b * N * 3;
  const unsigned char* vb = valid + (size_t)b * N;
  float mind[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int j = tid + t * FPS_THREADS;
    mind[t] = -1e30f;
    if (j < N) {
      px[j] = pb[3 * j];
      py[j] = pb[3 * j + 1];
      pz[j] = pb[3 * j + 2];
      if (vb[j]) mind[t] = 1e30f;
    }
  }
  __syncthreads();

  int last = start[b];
  for (int i = 0; i < budget; ++i) {
    if (tid == 0) out[(size_t)b * budget + i] = last;
    const float lx = px[last], ly = py[last], lz = pz[last];
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int j = tid + t * FPS_THREADS;
      if (j < N) {
        const float dx = __fsub_rn(px[j], lx);
        const float dy = __fsub_rn(py[j], ly);
        const float dz = __fsub_rn(pz[j], lz);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const float mv = fminf(mind[t], d2);
        mind[t] = mv;
        if (mv > bv) {
          bv = mv;
          bi = j;
        }
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) s_last = bi;
    }
    __syncthreads();
    last = s_last;
  }
}

template <int PER>
static int launch(const float* pos, const unsigned char* valid,
                  const int* start, int* out, int B, int N, int budget,
                  cudaStream_t st) {
  const size_t smem = (size_t)N * 3 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fps_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fps_kernel<PER><<<B, FPS_THREADS, smem, st>>>(pos, valid, start, out, N,
                                                budget);
  return (int)cudaGetLastError();
}

// pos (B, N, 3) f32; valid (B, N) bool; start (B,) int32; out (B, budget)
// int32 pick order.  N <= 20 * 1024, within shared memory at 12 B a point.
extern "C" int ccn_fps(const float* pos, const unsigned char* valid,
                       const int* start, int* out, int B, int N, int budget,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || budget < 1 || N > 20 * FPS_THREADS)
    return (int)cudaErrorInvalidValue;
  if (N <= 8 * FPS_THREADS)
    return launch<8>(pos, valid, start, out, B, N, budget, st);
  return launch<20>(pos, valid, start, out, B, N, budget, st);
}
