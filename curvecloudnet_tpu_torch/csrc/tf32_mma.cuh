// Device helpers of the tensor-core kernels K2 (group_reduce.cu) and K7
// (group_train.cu): 3xTF32 operand splits, mma.sync m16n8k8 in TF32, the
// bfloat16 operands of mma.sync m16n8k16 (K1's and K8's bfloat16
// variants; K2-bf16 and K7-bf16 round with pack_bf16), the
// activations, and cp.async staging of a weight (or row) tile into shared
// memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float act_fn(float v, int kind) {
  if (kind == 0) return fmaxf(v, 0.f);            // relu
  if (kind == 1) return v > 0.f ? v : 0.01f * v;  // leaky_relu
  return v;                                       // identity
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; equal for every finite x and infinity) in two integer
// operations: type conversions run at 1/8 of the FP32 rate on Hopper.
// ops/group_reduce.py tf32_round is the same formula.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the low part of x's 3xTF32 split, rna(x - hi)
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bfloat16 (to nearest, ties to even: torch's
// .to(torch.bfloat16)) in one register, lo in the low half: an mma.sync
// bfloat16 operand holding two consecutive k
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two bfloat16 values (raw bits) in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16_bits(unsigned short lo,
                                                   unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// d += a (16 x 16, row) b (16 x 8, col), bfloat16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an element of a float or bfloat16 tensor as float; four at p (16- or
// 8-byte aligned) as a float4
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float4 load4_f32(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4_f32(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A row-major matrix W (cin rows, cout columns, row stride ld) in device
// memory; vec when ld and W's offset are multiples of 4 floats (16-byte
// copies).
struct WLayer {
  const float* W;
  int cin, cout, ld;
  bool vec;
};

// Rows k0 .. k0 + kc - 1 of L.W, columns up to cout rounded to 8, into a
// stage of kc rows with row stride ldw (floats), by cp.async; 0 past cin
// and cout.
static __device__ inline void stage_w(float* dst, int ldw, const WLayer& L,
                                      int k0, int kc) {
  const int cout8 = (L.cout + 7) & ~7;
  const int per = L.vec ? cout8 / 4 : cout8;  // copies a row
  const int sh = (per & (per - 1)) == 0 ? __ffs(per) - 1 : -1;
  for (int i = threadIdx.x; i < kc * per; i += blockDim.x) {
    const int kr = sh >= 0 ? i >> sh : i / per;
    const int c = (i - kr * per) * (L.vec ? 4 : 1), k = k0 + kr;
    float* d = dst + kr * ldw + c;
    if (L.vec) {
      if (k < L.cin && c < L.cout)
        cp_async16(d, L.W + (size_t)k * L.ld + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (k < L.cin && c < L.cout) {
      cp_async4(d, L.W + (size_t)k * L.ld + c);
    } else {
      *d = 0.f;
    }
  }
}
