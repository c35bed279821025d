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
// K4's bfloat16 variant (ccn_gather_km_bf16, a model computing in
// bfloat16): the same gather of rows of 2-byte elements, 16-byte loads (8
// elements) when C % 8 == 0 and both tensors are 16-byte aligned, else one
// element a lane; the values are copied bit for bit.
//
// K4b's bfloat16 variant (ccn_scatter_km_bf16, a model training in
// bfloat16; replaces _collapse and the scatter of _gather_bwd on bfloat16
// cotangents): reads the 2-byte cotangent rows an element a lane, so a
// warp's 32 atomics fall on neighbouring addresses and coalesce as K4b's
// do (8 elements a lane from 16-byte loads made the adds 4x slower), adds
// them as f32 atomics into a zeroed f32 scratch, then one pass rounds the
// scratch to bfloat16 to nearest even (__float2bfloat16_rn): the sums are
// f32 and each result is rounded once, as the JAX package's f32 sums cast
// to the source dtype; nothing accumulates in bfloat16.
//
// Bound on the H100: bytes (K4 reads and writes R * C floats, or R * C
// bfloat16 values; K4b reads them and adds into B * N * C; its bfloat16
// variant reads R * C bfloat16 values and writes B * N * C).

#include <cuda_bf16.h>
#include <algorithm>
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

// rows of `units` copy units V (uint4: 8 bfloat16; unsigned short: one)
template <class V>
__global__ void gather_km_bf16_kernel(const V* __restrict__ src,
                                    const int* __restrict__ idx,
                                    V* __restrict__ out, int N, long long R,
                                    int units, int fill) {
  const long long slot = (long long)blockIdx.x * (blockDim.x / 32) +
                         threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (slot >= R) return;
  const int j = idx[(size_t)b * R + slot];
  const bool zero = fill && j < 0;
  const V* row = src + ((size_t)b * N + (j < 0 ? 0 : j)) * units;
  V* dst = out + ((size_t)b * R + slot) * units;
  for (int c = lane; c < units; c += 32) dst[c] = zero ? V{} : row[c];
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

// bfloat16 rows of C elements (raw bits) added as f32 into d_src (B, N, C)
__global__ void scatter_km_bf16_kernel(
    const unsigned short* __restrict__ d_out, const int* __restrict__ idx,
    float* __restrict__ d_src, int N, long long R, int C, int fill) {
  const long long slot = (long long)blockIdx.x * (blockDim.x / 32) +
                         threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (slot >= R) return;
  const int j = idx[(size_t)b * R + slot];
  if (fill && j < 0) return;
  const unsigned short* g = d_out + ((size_t)b * R + slot) * C;
  float* row = d_src + ((size_t)b * N + (j < 0 ? 0 : j)) * C;
  for (int c = lane; c < C; c += 32)
    atomicAdd(row + c, __uint_as_float((unsigned)g[c] << 16));
}

// out[i] = bfloat16(acc[i]), to nearest even
__global__ void scatter_km_round_kernel(const float* __restrict__ acc,
                                  __nv_bfloat16* __restrict__ out,
                                  long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(acc[i]);
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

// src (B, N, C) and out (B, R, C) bfloat16 (2-byte elements); the rest as
// ccn_gather_km
extern "C" int ccn_gather_km_bf16(const unsigned short* src, const int* idx,
                                  unsigned short* out, int B, int N,
                                  long long R, int C, int fill,
                                  void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid = slot_grid(B, R);
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 8 == 0 && (size_t)src % 16 == 0 && (size_t)out % 16 == 0)
    gather_km_bf16_kernel<<<grid, 256, 0, st>>>(
        reinterpret_cast<const uint4*>(src), idx,
        reinterpret_cast<uint4*>(out), N, R, C / 8, fill);
  else
    gather_km_bf16_kernel<<<grid, 256, 0, st>>>(src, idx, out, N, R, C, fill);
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

// d_out (B, R, C) bfloat16 -> d_src (B, N, C) bfloat16 through acc, f32
// scratch of B * N * C zeroed by the caller
extern "C" int ccn_scatter_km_bf16(const unsigned short* d_out,
                                   const int* idx, float* acc,
                                   __nv_bfloat16* d_src, int B, int N,
                                   long long R, int C, int fill,
                                   void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  scatter_km_bf16_kernel<<<slot_grid(B, R), 256, 0, st>>>(d_out, idx, acc, N,
                                                         R, C, fill);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)B * N * C;
  const long long blocks = std::min<long long>((n + 255) / 256, 132 * 16);
  scatter_km_round_kernel<<<(unsigned)blocks, 256, 0, st>>>(acc, d_src, n);
  return (int)cudaGetLastError();
}
