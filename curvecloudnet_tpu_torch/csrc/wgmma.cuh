// The Hopper primitives of the bfloat16 wgmma kernels, K2-bf16
// (group_wgmma.cuh) and K7-bf16 (group_train_wgmma.cuh): shared-memory
// addresses, mbarriers, bulk copies (cp.async.bulk) completing on them,
// the async-proxy fence, named barriers, wgmma matrix descriptors and
// wgmma.mma_async m64n(32 NS)k16 on bfloat16 operands from shared memory
// with f32 accumulators, and the 128-byte swizzle of a 64 x 64 bfloat16
// tile.  The wgmma, mbarrier and bulk-copy PTX is inline.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t gw_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void gw_mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void gw_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void gw_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// the arrival of this thread where pred is set (the branch inside the
// instruction, so that the compiler sees no divergent path near wgmma)
__device__ __forceinline__ void gw_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// wait until the barrier's phase of the given parity has completed, the
// loop inside the instruction (as above)
__device__ __forceinline__ void gw_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "GW_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra GW_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the producers' wait: after 2^26 unsuccessful tries (a second or more;
// every real wait is microseconds) the kernel ends with an error rather
// than hang the card.  A consumer stuck on a barrier leaves a producer
// stuck on the next, so this one bound covers both.
__device__ __forceinline__ void gw_wait_bounded(uint32_t bar,
                                                uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "GW_WAITB:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra GW_DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n"
      "@p bra GW_WAITB;\n"
      "trap;\n"
      "GW_DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// an arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void gw_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, completing on bar
__device__ __forceinline__ void gw_bulk(uint32_t dst, const void* src,
                                        uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// this thread's shared-memory writes, visible to wgmma (the async proxy)
__device__ __forceinline__ void gw_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void gw_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void gw_st32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// wgmma matrix descriptors of K-major operands: the 128-byte swizzle (an
// activation tile: 8-row groups 1024 bytes apart) and the 32-byte one (a
// weight slab: rows of 16 k, 8-row groups 256 bytes apart)
__device__ __forceinline__ uint64_t gw_desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t gw_desc32(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void gw_wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void gw_wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void gw_wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// acc[0 .. NS - 1] (64 x 32 NS, f32; a warpgroup's fragments, subtile j's
// columns 32 j ..) (+)= A (64 x 16) B (16 x 32 NS), both bfloat16 in shared
// memory, K-major, as one wgmma.mma_async m64n(32 NS)k16; scale_d 0
// overwrites acc
template <int NS>
__device__ __forceinline__ void gw_mma(float (&acc)[NS][16], uint64_t da,
                                       uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void gw_mma<1>(float (&acc)[1][16],
                                          uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gw_mma<2>(float (&acc)[2][16],
                                          uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gw_mma<3>(float (&acc)[3][16],
                                          uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15]),
        "+f"(acc[2][0]), "+f"(acc[2][1]), "+f"(acc[2][2]), "+f"(acc[2][3]),
        "+f"(acc[2][4]), "+f"(acc[2][5]), "+f"(acc[2][6]), "+f"(acc[2][7]),
        "+f"(acc[2][8]), "+f"(acc[2][9]), "+f"(acc[2][10]), "+f"(acc[2][11]),
        "+f"(acc[2][12]), "+f"(acc[2][13]), "+f"(acc[2][14]), "+f"(acc[2][15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gw_mma<4>(float (&acc)[4][16],
                                          uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15]),
        "+f"(acc[2][0]), "+f"(acc[2][1]), "+f"(acc[2][2]), "+f"(acc[2][3]),
        "+f"(acc[2][4]), "+f"(acc[2][5]), "+f"(acc[2][6]), "+f"(acc[2][7]),
        "+f"(acc[2][8]), "+f"(acc[2][9]), "+f"(acc[2][10]), "+f"(acc[2][11]),
        "+f"(acc[2][12]), "+f"(acc[2][13]), "+f"(acc[2][14]), "+f"(acc[2][15]),
        "+f"(acc[3][0]), "+f"(acc[3][1]), "+f"(acc[3][2]), "+f"(acc[3][3]),
        "+f"(acc[3][4]), "+f"(acc[3][5]), "+f"(acc[3][6]), "+f"(acc[3][7]),
        "+f"(acc[3][8]), "+f"(acc[3][9]), "+f"(acc[3][10]), "+f"(acc[3][11]),
        "+f"(acc[3][12]), "+f"(acc[3][13]), "+f"(acc[3][14]), "+f"(acc[3][15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gw_mma<5>(float (&acc)[5][16],
                                          uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15]),
        "+f"(acc[2][0]), "+f"(acc[2][1]), "+f"(acc[2][2]), "+f"(acc[2][3]),
        "+f"(acc[2][4]), "+f"(acc[2][5]), "+f"(acc[2][6]), "+f"(acc[2][7]),
        "+f"(acc[2][8]), "+f"(acc[2][9]), "+f"(acc[2][10]), "+f"(acc[2][11]),
        "+f"(acc[2][12]), "+f"(acc[2][13]), "+f"(acc[2][14]), "+f"(acc[2][15]),
        "+f"(acc[3][0]), "+f"(acc[3][1]), "+f"(acc[3][2]), "+f"(acc[3][3]),
        "+f"(acc[3][4]), "+f"(acc[3][5]), "+f"(acc[3][6]), "+f"(acc[3][7]),
        "+f"(acc[3][8]), "+f"(acc[3][9]), "+f"(acc[3][10]), "+f"(acc[3][11]),
        "+f"(acc[3][12]), "+f"(acc[3][13]), "+f"(acc[3][14]), "+f"(acc[3][15]),
        "+f"(acc[4][0]), "+f"(acc[4][1]), "+f"(acc[4][2]), "+f"(acc[4][3]),
        "+f"(acc[4][4]), "+f"(acc[4][5]), "+f"(acc[4][6]), "+f"(acc[4][7]),
        "+f"(acc[4][8]), "+f"(acc[4][9]), "+f"(acc[4][10]), "+f"(acc[4][11]),
        "+f"(acc[4][12]), "+f"(acc[4][13]), "+f"(acc[4][14]), "+f"(acc[4][15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gw_mma<6>(float (&acc)[6][16],
                                          uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15]),
        "+f"(acc[2][0]), "+f"(acc[2][1]), "+f"(acc[2][2]), "+f"(acc[2][3]),
        "+f"(acc[2][4]), "+f"(acc[2][5]), "+f"(acc[2][6]), "+f"(acc[2][7]),
        "+f"(acc[2][8]), "+f"(acc[2][9]), "+f"(acc[2][10]), "+f"(acc[2][11]),
        "+f"(acc[2][12]), "+f"(acc[2][13]), "+f"(acc[2][14]), "+f"(acc[2][15]),
        "+f"(acc[3][0]), "+f"(acc[3][1]), "+f"(acc[3][2]), "+f"(acc[3][3]),
        "+f"(acc[3][4]), "+f"(acc[3][5]), "+f"(acc[3][6]), "+f"(acc[3][7]),
        "+f"(acc[3][8]), "+f"(acc[3][9]), "+f"(acc[3][10]), "+f"(acc[3][11]),
        "+f"(acc[3][12]), "+f"(acc[3][13]), "+f"(acc[3][14]), "+f"(acc[3][15]),
        "+f"(acc[4][0]), "+f"(acc[4][1]), "+f"(acc[4][2]), "+f"(acc[4][3]),
        "+f"(acc[4][4]), "+f"(acc[4][5]), "+f"(acc[4][6]), "+f"(acc[4][7]),
        "+f"(acc[4][8]), "+f"(acc[4][9]), "+f"(acc[4][10]), "+f"(acc[4][11]),
        "+f"(acc[4][12]), "+f"(acc[4][13]), "+f"(acc[4][14]), "+f"(acc[4][15]),
        "+f"(acc[5][0]), "+f"(acc[5][1]), "+f"(acc[5][2]), "+f"(acc[5][3]),
        "+f"(acc[5][4]), "+f"(acc[5][5]), "+f"(acc[5][6]), "+f"(acc[5][7]),
        "+f"(acc[5][8]), "+f"(acc[5][9]), "+f"(acc[5][10]), "+f"(acc[5][11]),
        "+f"(acc[5][12]), "+f"(acc[5][13]), "+f"(acc[5][14]), "+f"(acc[5][15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gw_mma<7>(float (&acc)[7][16],
                                          uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15]),
        "+f"(acc[2][0]), "+f"(acc[2][1]), "+f"(acc[2][2]), "+f"(acc[2][3]),
        "+f"(acc[2][4]), "+f"(acc[2][5]), "+f"(acc[2][6]), "+f"(acc[2][7]),
        "+f"(acc[2][8]), "+f"(acc[2][9]), "+f"(acc[2][10]), "+f"(acc[2][11]),
        "+f"(acc[2][12]), "+f"(acc[2][13]), "+f"(acc[2][14]), "+f"(acc[2][15]),
        "+f"(acc[3][0]), "+f"(acc[3][1]), "+f"(acc[3][2]), "+f"(acc[3][3]),
        "+f"(acc[3][4]), "+f"(acc[3][5]), "+f"(acc[3][6]), "+f"(acc[3][7]),
        "+f"(acc[3][8]), "+f"(acc[3][9]), "+f"(acc[3][10]), "+f"(acc[3][11]),
        "+f"(acc[3][12]), "+f"(acc[3][13]), "+f"(acc[3][14]), "+f"(acc[3][15]),
        "+f"(acc[4][0]), "+f"(acc[4][1]), "+f"(acc[4][2]), "+f"(acc[4][3]),
        "+f"(acc[4][4]), "+f"(acc[4][5]), "+f"(acc[4][6]), "+f"(acc[4][7]),
        "+f"(acc[4][8]), "+f"(acc[4][9]), "+f"(acc[4][10]), "+f"(acc[4][11]),
        "+f"(acc[4][12]), "+f"(acc[4][13]), "+f"(acc[4][14]), "+f"(acc[4][15]),
        "+f"(acc[5][0]), "+f"(acc[5][1]), "+f"(acc[5][2]), "+f"(acc[5][3]),
        "+f"(acc[5][4]), "+f"(acc[5][5]), "+f"(acc[5][6]), "+f"(acc[5][7]),
        "+f"(acc[5][8]), "+f"(acc[5][9]), "+f"(acc[5][10]), "+f"(acc[5][11]),
        "+f"(acc[5][12]), "+f"(acc[5][13]), "+f"(acc[5][14]), "+f"(acc[5][15]),
        "+f"(acc[6][0]), "+f"(acc[6][1]), "+f"(acc[6][2]), "+f"(acc[6][3]),
        "+f"(acc[6][4]), "+f"(acc[6][5]), "+f"(acc[6][6]), "+f"(acc[6][7]),
        "+f"(acc[6][8]), "+f"(acc[6][9]), "+f"(acc[6][10]), "+f"(acc[6][11]),
        "+f"(acc[6][12]), "+f"(acc[6][13]), "+f"(acc[6][14]), "+f"(acc[6][15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void gw_mma<8>(float (&acc)[8][16],
                                          uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]),
        "+f"(acc[0][4]), "+f"(acc[0][5]), "+f"(acc[0][6]), "+f"(acc[0][7]),
        "+f"(acc[0][8]), "+f"(acc[0][9]), "+f"(acc[0][10]), "+f"(acc[0][11]),
        "+f"(acc[0][12]), "+f"(acc[0][13]), "+f"(acc[0][14]), "+f"(acc[0][15]),
        "+f"(acc[1][0]), "+f"(acc[1][1]), "+f"(acc[1][2]), "+f"(acc[1][3]),
        "+f"(acc[1][4]), "+f"(acc[1][5]), "+f"(acc[1][6]), "+f"(acc[1][7]),
        "+f"(acc[1][8]), "+f"(acc[1][9]), "+f"(acc[1][10]), "+f"(acc[1][11]),
        "+f"(acc[1][12]), "+f"(acc[1][13]), "+f"(acc[1][14]), "+f"(acc[1][15]),
        "+f"(acc[2][0]), "+f"(acc[2][1]), "+f"(acc[2][2]), "+f"(acc[2][3]),
        "+f"(acc[2][4]), "+f"(acc[2][5]), "+f"(acc[2][6]), "+f"(acc[2][7]),
        "+f"(acc[2][8]), "+f"(acc[2][9]), "+f"(acc[2][10]), "+f"(acc[2][11]),
        "+f"(acc[2][12]), "+f"(acc[2][13]), "+f"(acc[2][14]), "+f"(acc[2][15]),
        "+f"(acc[3][0]), "+f"(acc[3][1]), "+f"(acc[3][2]), "+f"(acc[3][3]),
        "+f"(acc[3][4]), "+f"(acc[3][5]), "+f"(acc[3][6]), "+f"(acc[3][7]),
        "+f"(acc[3][8]), "+f"(acc[3][9]), "+f"(acc[3][10]), "+f"(acc[3][11]),
        "+f"(acc[3][12]), "+f"(acc[3][13]), "+f"(acc[3][14]), "+f"(acc[3][15]),
        "+f"(acc[4][0]), "+f"(acc[4][1]), "+f"(acc[4][2]), "+f"(acc[4][3]),
        "+f"(acc[4][4]), "+f"(acc[4][5]), "+f"(acc[4][6]), "+f"(acc[4][7]),
        "+f"(acc[4][8]), "+f"(acc[4][9]), "+f"(acc[4][10]), "+f"(acc[4][11]),
        "+f"(acc[4][12]), "+f"(acc[4][13]), "+f"(acc[4][14]), "+f"(acc[4][15]),
        "+f"(acc[5][0]), "+f"(acc[5][1]), "+f"(acc[5][2]), "+f"(acc[5][3]),
        "+f"(acc[5][4]), "+f"(acc[5][5]), "+f"(acc[5][6]), "+f"(acc[5][7]),
        "+f"(acc[5][8]), "+f"(acc[5][9]), "+f"(acc[5][10]), "+f"(acc[5][11]),
        "+f"(acc[5][12]), "+f"(acc[5][13]), "+f"(acc[5][14]), "+f"(acc[5][15]),
        "+f"(acc[6][0]), "+f"(acc[6][1]), "+f"(acc[6][2]), "+f"(acc[6][3]),
        "+f"(acc[6][4]), "+f"(acc[6][5]), "+f"(acc[6][6]), "+f"(acc[6][7]),
        "+f"(acc[6][8]), "+f"(acc[6][9]), "+f"(acc[6][10]), "+f"(acc[6][11]),
        "+f"(acc[6][12]), "+f"(acc[6][13]), "+f"(acc[6][14]), "+f"(acc[6][15]),
        "+f"(acc[7][0]), "+f"(acc[7][1]), "+f"(acc[7][2]), "+f"(acc[7][3]),
        "+f"(acc[7][4]), "+f"(acc[7][5]), "+f"(acc[7][6]), "+f"(acc[7][7]),
        "+f"(acc[7][8]), "+f"(acc[7][9]), "+f"(acc[7][10]), "+f"(acc[7][11]),
        "+f"(acc[7][12]), "+f"(acc[7][13]), "+f"(acc[7][14]), "+f"(acc[7][15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the accumulators as operands of an empty instruction: the compiler may
// move no access to them across it (around a run of wgmma, as CUTLASS's
// warpgroup_fence_operand)
template <int NS>
__device__ __forceinline__ void gw_fence_acc(float (&acc)[NS][16]) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 16; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");
}

// byte offset of (row r, column c) in a 64 x 64 bfloat16 tile, 128-byte
// swizzle: the 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ uint32_t gw_tile_at(int r, int c) {
  return r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}
