// K4: the k-major row gather, and K4b: its scatter-add (the gather's VJP).
//
// Replaces curvecloudnet_tpu/ops/pallas_gather.py: K4 the _expand kernel
// (pl.pallas_call in _expand), K4b the _collapse kernel (pl.pallas_call in
// _collapse) and the unique-row scatter of _gather_bwd.  The TPU version
// routes each query tile's unique rows through the MXU because HBM charges
// per row there, under a static per-tile budget that drops rows past it;
// on Hopper a warp reads a row with 16-byte loads at the memory rate, so
// the port gathers every slot directly and exactly.
//
// K4: src (B, N, C) f32, idx (B, R) int32 with R = K * Q slots (-1 fill)
// -> out (B, R, C) = src[max(idx, 0)], zeros where idx < 0 when `fill`.
// One warp per slot row, float4 loads when C % 4 == 0 and both tensors are
// 16-byte aligned.
//
// K4b: d_out (B, R, C) -> d_src (B, N, C) += d_out at row max(idx, 0),
// skipping idx < 0 when `fill`.  The simple design: one warp per slot row,
// f32 atomicAdd per element into the zeroed output.  A row that many slots
// name takes as many atomics (a kNN table names each row ~K times); the
// deterministic alternative (an inverse index sorted once per table, one
// warp summing each source row) is a later optimisation.  Atomics make the
// summation order vary from run to run, within f32 rounding.
//
// Bound on the H100: bytes (K4 reads and writes R * C floats; K4b reads
// them and adds into B * N * C).

#include <cuda_runtime.h>

__global__ void gather_km_kernel(const float* __restrict__ src,
                                 const int* __restrict__ idx,
                                 float* __restrict__ out, int N, long long R,
                                 int C, int fill, int vec) {
  const long long slot = (long long)blockIdx.x * (blockDim.x / 32) +
                         threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (slot >= R) return;
  const int j = idx[(size_t)b * R + slot];
  const bool zero = fill && j < 0;
  const float* row = src + ((size_t)b * N + (j < 0 ? 0 : j)) * C;
  float* dst = out + ((size_t)b * R + slot) * C;
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < C / 4; c += 32)
      d4[c] = zero ? make_float4(0.f, 0.f, 0.f, 0.f) : r4[c];
  } else {
    for (int c = lane; c < C; c += 32) dst[c] = zero ? 0.f : row[c];
  }
}

__global__ void scatter_km_kernel(const float* __restrict__ d_out,
                                  const int* __restrict__ idx,
                                  float* __restrict__ d_src, int N,
                                  long long R, int C, int fill) {
  const long long slot = (long long)blockIdx.x * (blockDim.x / 32) +
                         threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (slot >= R) return;
  const int j = idx[(size_t)b * R + slot];
  if (fill && j < 0) return;
  const float* g = d_out + ((size_t)b * R + slot) * C;
  float* row = d_src + ((size_t)b * N + (j < 0 ? 0 : j)) * C;
  for (int c = lane; c < C; c += 32) atomicAdd(row + c, g[c]);
}

static dim3 slot_grid(int B, long long R) {
  return dim3((unsigned)((R + 7) / 8), (unsigned)B);  // 8 warps per block
}

extern "C" int ccn_gather_km(const float* src, const int* idx, float* out,
                             int B, int N, long long R, int C, int fill,
                             void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int vec = (C % 4 == 0) && ((size_t)src % 16 == 0) &&
                  ((size_t)out % 16 == 0);
  gather_km_kernel<<<slot_grid(B, R), 256, 0, (cudaStream_t)stream>>>(
      src, idx, out, N, R, C, fill, vec);
  return (int)cudaGetLastError();
}

// d_src must be zeroed by the caller
extern "C" int ccn_scatter_km(const float* d_out, const int* idx,
                              float* d_src, int B, int N, long long R, int C,
                              int fill, void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  scatter_km_kernel<<<slot_grid(B, R), 256, 0, (cudaStream_t)stream>>>(
      d_out, idx, d_src, N, R, C, fill);
  return (int)cudaGetLastError();
}
