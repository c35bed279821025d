// K7-bf16 on Hopper: every bfloat16 product of K7's train forward and
// backward (ops/group_train.py on a bfloat16 h1) on wgmma.
//
// Replaces curvecloudnet_tpu/ops/pallas_group_train.py _dot, _dot_t and
// _dot_wgrad with cdt = bfloat16 (:137-155, reached through _call :589 ->
// pallas_call :591).  The contract: each product takes both operands
// rounded to bfloat16 (to nearest even) and sums in f32; the transforms,
// epilogues, statistics, finalize and aggregation stay f32, as in the
// rest of group_train.cu (GJob, transform, the epilogue modes).
//
// Bound on the H100: the bytes the function must move (h1's live rows in
// bfloat16, the parameters, the outputs and statistics; the backward's
// cotangents and gradients, and the forward's chain read back or
// recomputed, whichever is sooner) against its bfloat16 products at 989
// TFLOP/s: the flagship's sites are bound by bytes (chip_smoke.py work).
// What the design does about it:
//  * A once per row tile.  A block takes 64 live rows and every output
//    column of the product, on wgmma.mma_async m64n(32 NS)k16 with f32
//    accumulators.  It reads its rows once (through the row index for h1;
//    16-byte loads, four groups in flight a thread), applies the A
//    transform (BN + activation, the BN backward, the max or softmax
//    backward; the mode chosen once a group, its per-column operands read
//    8 at a time) in f32 once, writes the saved transform (asave) from
//    there, and stores the result rounded to bfloat16 in the 128-byte-
//    swizzled K-major tiles wgmma reads (a 64-row tile at K = 1024 is
//    128 KB).  Up to 256 columns (gtw_rows1) one warpgroup takes a whole
//    pass and several blocks share an SM, so that one block's loads and
//    epilogue overlap another's; wider (gtw_rows) two warpgroups split
//    each pass of 512 columns (zero-padded past N).  No loop with a data-dependent trip count shares the
//    wgmma warps' path (ptxas would serialize every wgmma, warning C7520).
//  * Weights by bulk copy.  The wrapper packs every layer's W (forward) or
//    W^T (the data gradient) once a call into a bfloat16 image in the
//    exact shared-memory layout of a stage (ops/group_reduce.py pack_bf16's
//    layout: K-major slabs of 16 k, 32-byte swizzle, zero-padded); the
//    stages stream by cp.async.bulk into a ring, each completing on its
//    mbarrier, starting while the A tile is built; an image that fits is
//    loaded whole.
//  * The epilogue staged through shared memory: a subtile's accumulators go
//    to a swizzled f32 tile, and each warp takes 16 rows of it a column a
//    lane: the bias, act'(y) or the softmax term, stored a row at a time (a
//    warp writes whole lines), and the column sums of the tile (statistics,
//    or the BN backward's sum T and sum T x-hat) in a fixed order into a
//    partial a tile, with no shuffles.
//  * The weight gradient on wgmma (gtw_wgrad): dW = T(x)^T d over a split
//    of the rows, tiles of 128 channels x 32 NS columns a block.  Both
//    operands have the rows as their inner dimension, so a 64-row chunk of
//    T(x) (transformed once, bfloat16) and of d (rounded) go into shared
//    memory as they lie, row-major in the same swizzled tiles, and wgmma
//    reads them MN-major (transposed); the next chunk is loaded while the
//    current one's products run.  The bias gradient (the f32 column sums of
//    d) comes beside, in the blocks of the first channel tile.
//  * No atomics: every sum across blocks is a partial summed in a fixed
//    order by gt_finalize, so the gradients repeat bit for bit.
#pragma once

#include <string.h>

#include "wgmma.cuh"

#define GTW_ROWS 64        // rows of a tile, or of a weight-gradient chunk
#define GTW_TILE 8192      // 64 rows x 64 bfloat16 columns, swizzled
#define GTW_THREADS 384    // gtw_rows: two consumer warpgroups, warps 8-11
#define GTW_WG_THREADS 256 // gtw_wgrad: two warpgroups
#define GTW_MAXST 16       // weight ring slots
#define GTW_MAX_K 1024     // the widest A operand a tile holds
enum { GTW_ROWS2 = 0, GTW_WGRAD = 1, GTW_ROWS1 = 2 };

// The launch, filled by ops/group_train.py plan_rows / plan_wgrad
// (GTW_FIELDS there names these ints in order).  kind: GTW_ROWS2
// (gtw_rows, two warpgroups), GTW_WGRAD (gtw_wgrad) or GTW_ROWS1
// (gtw_rows1, one warpgroup).  The products over the rows: passes of
// 64 ns columns over nslab slabs of 16 k, per slabs a stage, a ring of
// nst stages of sb bytes (resident: the whole image); shared memory from
// a 1024-aligned base: the A tile (atiles 8 KB tiles), the ring at w_off,
// each consumer warpgroup's column sums (8 x 32 ns or 16 ns floats) and
// two 8 KB staging tiles at red_off, the barriers at bar_off.  gtw_wgrad: ns
// subtiles of 32 columns a block, splits of rps rows.  xbf: x (A, or the
// weight gradient's x) is bfloat16; exbf: the epilogue's ex is; ybf: y is
// stored as bfloat16.
struct GtwPlan {
  int kind, ns, npass, nslab, per, nst, resident, sb, atiles;
  int w_off, red_off, bar_off, smem, splits, rps;
  int xbf, exbf, ybf;
};

// f32 of x's element i (x bfloat16 when bf)
__device__ __forceinline__ float elem(const float* x, size_t i, int bf) {
  return bf ? load_f32(reinterpret_cast<const __nv_bfloat16*>(x) + i)
            : __ldg(x + i);
}

__device__ __forceinline__ bool gtw_al16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// x's elements at .. at + 7 (n of them real, 0 past), f32 or bfloat16;
// vec: at and x allow 16-byte loads
__device__ __forceinline__ void gtw_load8(const float* x, size_t at, int n,
                                          int bf, bool vec, float (&v)[8]) {
  if (vec && n >= 8) {
    if (bf) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          reinterpret_cast<const __nv_bfloat16*>(x) + at));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
      const float4 a = __ldg(reinterpret_cast<const float4*>(x + at));
      const float4 b = __ldg(reinterpret_cast<const float4*>(x + at + 4));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < n ? elem(x, at + e, bf) : 0.f;
}

// 8 values rounded to bfloat16 into a swizzled tile's 16-byte chunk
__device__ __forceinline__ void gtw_st8(unsigned char* at,
                                        const float (&v)[8]) {
  *reinterpret_cast<uint4*>(at) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// wgmma descriptor of an MN-major operand in the 128-byte swizzle: rows of
// one k (64 MN elements, 128 bytes), 8-k groups 1024 bytes apart, 64-wide
// MN blocks (tiles) 8192 bytes apart
__device__ __forceinline__ uint64_t gtw_desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// acc (64 x 32 NS, f32) (+)= A (64 x 16) B (16 x 32 NS), both bfloat16 in
// shared memory and MN-major (A: 64 M contiguous a k, B: 32 NS N a k), as
// one wgmma.mma_async m64n(32 NS)k16 with both operands transposed
template <int NS>
__device__ __forceinline__ void gtw_mma_mn(float (&acc)[NS][16], uint64_t da,
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void gtw_mma_mn<2>(float (&acc)[2][16],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void gtw_mma_mn<4>(float (&acc)[4][16],
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
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void gtw_mma_mn<8>(float (&acc)[8][16],
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
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
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

// Whether the transform's per-column and per-query operands allow 16-byte
// loads of 8 columns (K and the per-query stride multiples of 4, every
// operand 16-byte aligned)
__device__ __forceinline__ bool gtw_params_vec(const GJob& j) {
  const size_t al = reinterpret_cast<size_t>(j.mu) |
                    reinterpret_cast<size_t>(j.inv) |
                    reinterpret_cast<size_t>(j.gam) |
                    reinterpret_cast<size_t>(j.bet) |
                    reinterpret_cast<size_t>(j.c0) |
                    reinterpret_cast<size_t>(j.c1) |
                    reinterpret_cast<size_t>(j.c2) |
                    reinterpret_cast<size_t>(j.qmx) |
                    reinterpret_cast<size_t>(j.qd) |
                    reinterpret_cast<size_t>(j.qaux) |
                    reinterpret_cast<size_t>(j.qout);
  return (j.K & 3) == 0 && (j.ldx & 3) == 0 && (al & 15) == 0;
}

// The A transform (group_train.cu transform, j.tr) of 8 columns cc .. of
// row r, the mode chosen once a group and each per-column (or per-query)
// operand read 8 at a time (pv: 16-byte loads allowed); 0 past K
__device__ __forceinline__ void gtw_transform8(const GJob& j,
                                               const float (&x)[8],
                                               const float (&x2)[8], int r,
                                               int cc, bool pv,
                                               float (&o)[8]) {
  const int n = j.K - cc;
  float a[8], b[8], c[8], d[8];
  switch (j.tr) {
    case TR_NONE:
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = x[e];
      break;
    case TR_BN_ACT:
      gtw_load8(j.mu, cc, n, 0, pv, a);
      gtw_load8(j.inv, cc, n, 0, pv, b);
      gtw_load8(j.gam, cc, n, 0, pv, c);
      gtw_load8(j.bet, cc, n, 0, pv, d);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = act_fn(bn_y(bn_xhat(x[e], a[e], b[e]), c[e], d[e]), j.act);
      break;
    case TR_BNB: {  // gamma inv (t - (sum t / n + x-hat sum t x-hat / n))
      float f[8];
      gtw_load8(j.mu, cc, n, 0, pv, a);
      gtw_load8(j.inv, cc, n, 0, pv, b);
      gtw_load8(j.c0, cc, n, 0, pv, c);
      gtw_load8(j.c1, cc, n, 0, pv, d);
      gtw_load8(j.c2, cc, n, 0, pv, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = bn_xhat(x2[e], a[e], b[e]);
        o[e] = __fmul_rn(c[e], __fsub_rn(x[e], __fadd_rn(d[e],
                                                         __fmul_rn(xh, f[e]))));
      }
      break;
    }
    case TR_MAXB: {  // dout at the query's argmax, shared among its ties
      const size_t q = (size_t)__ldg(j.qry + r) * j.ldx + cc;
      gtw_load8(j.qmx, q, n, 0, pv, a);
      gtw_load8(j.qd, q, n, 0, pv, b);
      gtw_load8(j.qaux, q, n, 0, pv, c);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = x[e] == a[e] ? __fdiv_rn(b[e], fmaxf(c[e], 1.f)) : 0.f;
      break;
    }
    default: {  // TR_DLOGIT: softmax weight w (msg - out) dout
      const size_t q = (size_t)__ldg(j.qry + r) * j.ldx + cc;
      gtw_load8(j.qmx, q, n, 0, pv, a);
      gtw_load8(j.qaux, q, n, 0, pv, b);
      gtw_load8(j.qout, q, n, 0, pv, c);
      gtw_load8(j.qd, q, n, 0, pv, d);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float w = __fdiv_rn(expf(x[e] - a[e]), b[e]);
        o[e] = __fmul_rn(__fmul_rn(w, __fsub_rn(x2[e], c[e])), d[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e >= n) o[e] = 0.f;
}

// The A tile of rows m0 .. m0 + 63: each (row, 8-column group) loaded once
// (x through the row index, and x2 where the transform reads it),
// transformed in f32, saved to asave where asked, rounded into its tile;
// rows past R and columns past K zero.  Thread t of nt takes groups t,
// t + nt, ..., four in flight (their loads issued before any is used).
__device__ __forceinline__ void gtw_a_in(const GJob& j, const GtwPlan& p,
                                         unsigned char* at, int m0, int t,
                                         int nt) {
  const int ngrp = ((j.K + 15) >> 4) << 1;  // 8-column groups, to 16 k
  const int total = GTW_ROWS * ngrp;
  const bool two = j.tr == TR_BNB || j.tr == TR_DLOGIT;
  const bool vx = (j.ldx & (p.xbf ? 7 : 3)) == 0 && gtw_al16(j.x);
  const bool v2 = two && (j.ldx & 3) == 0 && gtw_al16(j.x2);
  const bool vs = (j.K & 3) == 0 && gtw_al16(j.asave);
  const bool pv = gtw_params_vec(j);
  for (int i0 = t; i0 < total; i0 += 4 * nt) {
    float x[4][8], x2[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nt, rr = i / ngrp, cc = (i - rr * ngrp) * 8;
      const int r = m0 + rr;
#pragma unroll
      for (int e = 0; e < 8; ++e) x[u][e] = x2[u][e] = 0.f;
      if (i < total && r < j.R) {
        const int src = j.xidx ? __ldg(j.xidx + r) : r;
        gtw_load8(j.x, (size_t)src * j.ldx + cc, j.K - cc, p.xbf, vx, x[u]);
        if (two)
          gtw_load8(j.x2, (size_t)r * j.ldx + cc, j.K - cc, 0, v2, x2[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nt, rr = i / ngrp, cc = (i - rr * ngrp) * 8;
      const int r = m0 + rr;
      if (i >= total) break;
      const bool live = r < j.R;
      float o[8];
      if (live && cc < j.K)
        gtw_transform8(j, x[u], x2[u], r, cc, pv, o);
      else
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = 0.f;
      if (j.asave && live) {
        float* d = j.asave + (size_t)r * j.K + cc;
        if (vs && cc + 8 <= j.K) {
          *reinterpret_cast<float4*>(d) =
              make_float4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<float4*>(d + 4) =
              make_float4(o[4], o[5], o[6], o[7]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (cc + e < j.K) d[e] = o[e];
        }
      }
      gtw_st8(at + (cc >> 6) * GTW_TILE + gw_tile_at(rr, cc), o);
    }
  }
}

// A pass's products on NS subtiles of 32 columns: its stages in turn from
// the ring (slabs of the pass's pw rows; this warpgroup's from row0), the
// previous stage released once its products are done (the wgmma straight
// in a row)
template <int NS>
__device__ __forceinline__ void gtw_products(float (&acc)[NS][16],
                                             const GtwPlan& p, uint32_t abase,
                                             uint32_t ring, uint32_t wfull0,
                                             uint32_t wempty0, int pw,
                                             int row0, bool signal, int& gs) {
  int prev = -1;
  for (int k0 = 0; k0 < p.nslab; k0 += p.per) {
    const int ns = min(p.per, p.nslab - k0);
    const int slot = gs % p.nst;
    gw_wait(wfull0 + 8 * slot, (gs / p.nst) & 1);
    const uint32_t stage = ring + slot * p.sb + row0 * 32;
    gw_fence_acc(acc);
    gw_wg_fence();
    for (int sl = 0; sl < ns; ++sl) {
      const int k = k0 + sl;
      const uint64_t da =
          gw_desc128(abase + (k >> 2) * GTW_TILE + (k & 3) * 32);
      const uint64_t db = gw_desc32(stage + sl * pw * 32);
      gw_mma<NS>(acc, da, db, k > 0);
    }
    gw_wg_commit();
    gw_fence_acc(acc);
    if (!p.resident) {
      if (prev >= 0) {
        gw_wg_wait<1>();
        gw_arrive_if(wempty0 + 8 * prev, signal);
      }
      prev = slot;
    }
    ++gs;
  }
  gw_wg_wait<0>();
  gw_fence_acc(acc);
  if (prev >= 0) gw_arrive_if(wempty0 + 8 * prev, signal);
}

// f32 staging tile (64 rows x 32 columns) of a warpgroup: column c of row
// r at gtw_stg(r, c), columns swizzled by the row so that the fragment
// stores and the column reads are free of bank conflicts
__device__ __forceinline__ int gtw_stg(int r, int c) {
  return r * 32 + (c ^ ((r & 3) << 3));
}

// One pass's epilogue for a consumer warpgroup, its 32 NS columns from
// col0: subtile by subtile (32 columns; su counts them, two staging tiles
// in turn), the accumulators go to a staging tile, then warp w takes rows
// 16 w .. 16 w + 15 of it a column a lane: the value of j.ep (bias;
// act'(y) of the output's level; the softmax term), stored a row at a
// time (a warp writes 32 consecutive values: whole lines), f32 or
// bfloat16 where p.ybf; with j.stats the column sums of the tile's rows
// in a fixed order (a lane's 16 rows, then the 4 warps in order) into
// its row of part (tiles, 2N).  red: this warpgroup's 2 x 4 x 32 NS
// floats; stg: its two staging tiles.
template <int NS>
__device__ __forceinline__ void gtw_epilogue(const GJob& j, const GtwPlan& p,
                                             const float (&acc)[NS][16],
                                             float* stg, float* red, int tile,
                                             int col0, int wgb, int warp,
                                             int lane, int t, int& su) {
  const int m0 = tile * GTW_ROWS, rw = warp * 16;
#pragma unroll
  for (int jj = 0; jj < NS; ++jj, ++su) {
    float* st = stg + (su & 1) * GTW_ROWS * 32;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw + (lane >> 2) + 8 * h, c = q * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(st + gtw_stg(r, c)) =
            make_float2(acc[jj][q * 4 + h * 2], acc[jj][q * 4 + h * 2 + 1]);
      }
    gw_bar(wgb, 128);
    const int n = col0 + jj * 32 + lane, c = min(n, j.N - 1);
    const bool col = n < j.N;
    float b0 = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f, e3 = 0.f;
    if (j.ep == EP_FWD) {
      b0 = __ldg(j.bias + c);
    } else if (j.ep == EP_DGRAD) {
      e0 = __ldg(j.emu + c);
      e1 = __ldg(j.einv + c);
      e2 = __ldg(j.egam + c);
      e3 = __ldg(j.ebet + c);
    }
    float s = 0.f, s2 = 0.f;
    // row r's value v stored (f32, or bfloat16 where p.ybf) and summed
    const auto put = [&](int r, float v, float u) {
      const size_t at = (size_t)r * j.N + n;
      if (p.ybf)
        reinterpret_cast<__nv_bfloat16*>(j.y)[at] = __float2bfloat16_rn(v);
      else
        j.y[at] = v;
      s += v;
      s2 += u;
    };
    const int rows = col ? min(16, j.R - m0 - rw) : 0;
    if (j.ep == EP_FWD) {
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        if (i >= rows) continue;
        const float v = __fadd_rn(st[gtw_stg(rw + i, lane)], b0);
        put(m0 + rw + i, v, __fmul_rn(v, v));
      }
    } else if (j.ep == EP_DGRAD) {
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        if (i >= rows) continue;
        const int r = m0 + rw + i;
        const size_t er =
            (size_t)(j.exidx ? __ldg(j.exidx + r) : r) * j.ldex;
        const float xh = bn_xhat(elem(j.ex, er + n, p.exbf), e0, e1);
        const float v = __fmul_rn(st[gtw_stg(rw + i, lane)],
                                  dact_fn(bn_y(xh, e2, e3), j.eact));
        put(r, v, __fmul_rn(v, xh));
      }
    } else {  // EP_ATT: msg's cotangent w dout + dg1 @ Wa0^T
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        if (i >= rows) continue;
        const int r = m0 + rw + i;
        const size_t o = (size_t)__ldg(j.qry + r) * j.N + n;
        const float w = __fdiv_rn(
            expf(__ldg(j.elg + (size_t)r * j.N + n) - __ldg(j.qmx + o)),
            __ldg(j.qaux + o));
        put(r, __fadd_rn(__fmul_rn(w, __ldg(j.qd + o)),
                         st[gtw_stg(rw + i, lane)]),
            0.f);
      }
    }
    if (j.stats) {
      red[warp * 32 * NS + jj * 32 + lane] = s;
      red[(4 + warp) * 32 * NS + jj * 32 + lane] = s2;
    }
  }
  if (!j.stats) return;
  gw_bar(wgb, 128);
  float* pr = j.part + (size_t)tile * 2 * j.N;
  for (int c = t; c < 32 * NS; c += 128) {
    const int n = col0 + c;
    if (n >= j.N) continue;
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s += red[w * 32 * NS + c];
      s2 += red[(4 + w) * 32 * NS + c];
    }
    pr[n] = s;
    pr[j.N + n] = s2;
  }
}

// Kernel K7-bf16, a product over the rows with N past 256 columns (NS 8:
// passes of 512): y (R, N) = T(A) (R, K) @ B (K, N), B from the packed
// image j.w, epilogue j.ep, the column sums of the block's 64-row tile
// into its row of part (tiles, 2N) when j.stats.  Warps 0-7 two consumer
// warpgroups (the A tile, then the products of each pass, split between
// them, and its epilogue), warp 8 the weight stream, which starts while
// the consumers build the A tile.
// Registers move from warps 8-11 to the consumers within the block's
// allocation (168 a thread at launch): 2 x 216 + 72 = 3 x 168 a
// sub-partition.
template <int NS>
__global__ void __launch_bounds__(GTW_THREADS, 1)
    gtw_rows(const __grid_constant__ GJob j,
             const __grid_constant__ GtwPlan p) {
  extern __shared__ __align__(1024) unsigned char gtw_raw[];
  const uint32_t raw = gw_smem(gtw_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* sm = gtw_raw + pad;
  const uint32_t sbase = raw + pad;
  const uint32_t wfull0 = sbase + p.bar_off, wempty0 = wfull0 + 8 * p.nst;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < p.nst; ++i) {
      gw_mbar_init(wfull0 + 8 * i, 1);
      gw_mbar_init(wempty0 + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the warpgroup, uniform in the compiler's eyes (a shuffle of lane 0's)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const uint32_t ring = sbase + p.w_off;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    if (tid != 2 * 128) return;
    // the weight stream: every pass's stages in the consumers' order
    const char* img = reinterpret_cast<const char*>(j.w);
    const int pw = 64 * NS;
    size_t off = 0;
    int gs = 0;
    for (int pass = 0; pass < p.npass; ++pass)
      for (int k0 = 0; k0 < p.nslab; k0 += p.per) {
        const uint32_t bytes = (uint32_t)min(p.per, p.nslab - k0) * pw * 32;
        const int slot = gs % p.nst, use = gs / p.nst;
        if (!p.resident) gw_wait_bounded(wempty0 + 8 * slot, (use & 1) ^ 1);
        gw_expect_tx(wfull0 + 8 * slot, bytes);
        gw_bulk(ring + slot * p.sb, img + off, bytes, wfull0 + 8 * slot);
        off += bytes;
        ++gs;
      }
    // hold the block until the resident stages have landed
    if (p.resident)
      for (int i = 0; i < gs; ++i) gw_wait_bounded(wfull0 + 8 * i, 0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  gtw_a_in(j, p, sm, blockIdx.x * GTW_ROWS, tid, 256);
  gw_fence_async();
  gw_bar(1, 256);
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  // this warpgroup's column sums, then its two staging tiles
  float* red = reinterpret_cast<float*>(sm + p.red_off) +
               wg * (8 * 32 * NS + 2 * GTW_ROWS * 32);
  float* stg = red + 8 * 32 * NS;
  int gs = 0, su = 0;
  for (int pass = 0; pass < p.npass; ++pass) {
    float acc[NS][16];
    gtw_products<NS>(acc, p, sbase, ring, wfull0, wempty0, 64 * NS,
                     wg * NS * 32, lane == 0, gs);
    gtw_epilogue<NS>(j, p, acc, stg, red, blockIdx.x,
                     pass * 64 * NS + wg * 32 * NS, 2 + wg, warp, lane, t,
                     su);
  }
}

// Stage q of a product's image (the passes in turn, per slabs a stage,
// the last of a pass shorter) into ring slot q % nst, completing on its
// barrier: issued where pred (the branch inside the instructions, so that
// the compiler sees no divergent path near wgmma)
__device__ __forceinline__ void gtw_stage_if(const GtwPlan& p,
                                             const char* img, uint32_t ring,
                                             uint32_t wfull0, int q, int pw,
                                             bool pred) {
  const int spp = (p.nslab + p.per - 1) / p.per;
  const int pass = q / spp, k0 = (q - pass * spp) * p.per;
  const uint32_t bytes = (uint32_t)min(p.per, p.nslab - k0) * pw * 32;
  const char* src = img + ((size_t)pass * p.nslab + k0) * pw * 32;
  const int slot = q % p.nst;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n}\n" ::"r"(ring + slot * p.sb),
      "l"(src), "r"(bytes), "r"(wfull0 + 8 * slot), "r"((int)pred)
      : "memory");
}

// Kernel K7-bf16, a product over the rows with N up to 256 columns (as
// gtw_rows): one warpgroup a block, so that several blocks share an SM
// and one block's loads and epilogue overlap another's.  The warpgroup
// builds its 64-row A tile, then takes each pass of 32 NSW columns (the
// image's pass) on wgmma m64n(32 NSW)k16; thread 0 issues the weight
// stages, the ring's first nst at the start (they land while the A tile
// is built) and each later one into the slot the stage nst before it has
// left (all four warps past its products).
template <int NSW>
__global__ void __launch_bounds__(128, NSW <= 4 ? 4 : 2)
    gtw_rows1(const __grid_constant__ GJob j,
              const __grid_constant__ GtwPlan p) {
  extern __shared__ __align__(1024) unsigned char gtw_raw[];
  const uint32_t raw = gw_smem(gtw_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* sm = gtw_raw + pad;
  const uint32_t sbase = raw + pad;
  const uint32_t wfull0 = sbase + p.bar_off, ring = sbase + p.w_off;
  const char* img = reinterpret_cast<const char*>(j.w);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int pw = 32 * NSW;
  const int total = p.npass * ((p.nslab + p.per - 1) / p.per);
  if (tid == 0) {
    for (int i = 0; i < p.nst; ++i) gw_mbar_init(wfull0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int q = 0; q < min(p.nst, total); ++q)
    gtw_stage_if(p, img, ring, wfull0, q, pw, tid == 0);
  gtw_a_in(j, p, sm, blockIdx.x * GTW_ROWS, tid, 128);
  gw_fence_async();
  __syncthreads();
  float* red = reinterpret_cast<float*>(sm + p.red_off);
  float* stg = red + 8 * 32 * NSW;  // two staging tiles
  int gs = 0, su = 0;
  for (int pass = 0; pass < p.npass; ++pass) {
    float acc[NSW][16];
    for (int k0 = 0; k0 < p.nslab; k0 += p.per, ++gs) {
      const int ns = min(p.per, p.nslab - k0), slot = gs % p.nst;
      gw_wait(wfull0 + 8 * slot, (gs / p.nst) & 1);
      const uint32_t stage = ring + slot * p.sb;
      gw_fence_acc(acc);
      gw_wg_fence();
      for (int sl = 0; sl < ns; ++sl) {
        const int k = k0 + sl;
        const uint64_t da =
            gw_desc128(sbase + (k >> 2) * GTW_TILE + (k & 3) * 32);
        gw_mma<NSW>(acc, da, gw_desc32(stage + sl * pw * 32), k > 0);
      }
      gw_wg_commit();
      gw_fence_acc(acc);
      if (gs >= 1 && gs - 1 + p.nst < total) {
        // the stage before this one read: its slot takes stage gs - 1 + nst
        gw_wg_wait<1>();
        gw_fence_acc(acc);
        gw_bar(1, 128);
        gtw_stage_if(p, img, ring, wfull0, gs - 1 + p.nst, pw, tid == 0);
      }
    }
    gw_wg_wait<0>();
    gw_fence_acc(acc);
    gtw_epilogue<NSW>(j, p, acc, stg, red, blockIdx.x, pass * pw, 2, warp,
                      lane, tid, su);
  }
}

// One 64-row chunk (rows r0 .. min(r0 + 64, kend) - 1) of the weight
// gradient into buffer buf: T(x) of channels c0 .. c0 + 127 (x through the
// row index, the transform in f32, rounded) into two tiles, d's columns
// n0 .. n0 + 32 NS - 1 (rounded) into NS / 2 tiles after them, each
// row-major in the swizzled tiles; 0 past the rows, K and N.  ds: this
// thread's f32 sums of its d columns, where dbsum.  A thread's x rows (4)
// and first 4 d rows are loaded together, before any is used.
template <int NS>
__device__ __forceinline__ void gtw_wg_in(const GJob& j, const GtwPlan& p,
                                          unsigned char* buf, int r0,
                                          int kend, int c0, int n0, int t,
                                          bool dbsum, float (&ds)[8]) {
  // x: channels c of group gi, rows rl + 16 u
  const int gi = t & 15, rl = t >> 4, c = c0 + gi * 8;
  const bool vx = (j.ldx & (p.xbf ? 7 : 3)) == 0 && gtw_al16(j.x);
  const bool pv = gtw_params_vec(j);
  // d: columns n of group gd, rows rd + nrl u
  constexpr int ng = 4 * NS, nrl = 256 / ng, nd = GTW_ROWS / nrl;
  constexpr int nb = nd < 4 ? nd : 4;  // d rows a batch
  const int gd = t % ng, rd = t / ng, n = n0 + gd * 8;
  const bool vd = (j.N & 3) == 0 && gtw_al16(j.w);
  unsigned char* dt = buf + 2 * GTW_TILE;
  int src[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + rl + 16 * u;
    src[u] = r < kend && c < j.K ? (j.xidx ? __ldg(j.xidx + r) : r) : -1;
  }
  float x[4][8], d[nb][8];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[u][e] = 0.f;
    if (src[u] >= 0)
      gtw_load8(j.x, (size_t)src[u] * j.ldx + c, j.K - c, p.xbf, vx, x[u]);
  }
#pragma unroll
  for (int b = 0; b < nd; b += nb) {
#pragma unroll
    for (int u = 0; u < nb; ++u) {
      const int r = r0 + rd + nrl * (b + u);
#pragma unroll
      for (int e = 0; e < 8; ++e) d[u][e] = 0.f;
      if (r < kend) gtw_load8(j.w, (size_t)r * j.N + n, j.N - n, 0, vd, d[u]);
    }
    if (b == 0) {
      const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = 0.f;
        if (src[u] >= 0) gtw_transform8(j, x[u], zero, r0 + rl + 16 * u, c,
                                        pv, o);
        gtw_st8(buf + (gi >> 3) * GTW_TILE + gw_tile_at(rl + 16 * u, gi * 8),
                o);
      }
    }
#pragma unroll
    for (int u = 0; u < nb; ++u) {
      if (dbsum)
#pragma unroll
        for (int e = 0; e < 8; ++e) ds[e] += d[u][e];
      gtw_st8(dt + (gd >> 3) * GTW_TILE +
                  gw_tile_at(rd + nrl * (b + u), (gd & 7) * 8),
              d[u]);
    }
  }
}

// Kernel K7-bf16, the weight gradient: part (gridDim.z, K + 1, N) = per
// row split, T(x)^T (K, rows) @ d (rows, N) and, in blocks of the first
// channel tile, row K: the column sums of d.  A block 128 channels (64 a
// warpgroup) x 32 NS columns over its split's rows in 64-row chunks, two
// buffers: the next chunk loads while the current one's products run.
template <int NS>
__global__ void __launch_bounds__(GTW_WG_THREADS, 1)
    gtw_wgrad(const __grid_constant__ GJob j, const __grid_constant__ GtwPlan p) {
  extern __shared__ __align__(1024) unsigned char gtw_raw[];
  const uint32_t raw = gw_smem(gtw_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* sm = gtw_raw + pad;
  const uint32_t sbase = raw + pad;
  constexpr int buf_bytes = (2 + NS / 2) * GTW_TILE;
  constexpr int ng = 4 * NS, nrl = 256 / ng;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  const int c0 = blockIdx.x * 128, n0 = blockIdx.y * 32 * NS;
  const int kbeg = blockIdx.z * p.rps, kend = min(j.R, kbeg + p.rps);
  const int nch = max(0, (kend - kbeg + GTW_ROWS - 1) / GTW_ROWS);
  const bool dbsum = blockIdx.x == 0;
  float acc[NS][16];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[s][e] = 0.f;
  float ds[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) ds[e] = 0.f;
  if (nch > 0) {
    gtw_wg_in<NS>(j, p, sm, kbeg, kend, c0, n0, tid, dbsum, ds);
    gw_fence_async();
    gw_bar(1, 256);
  }
  for (int ch = 0; ch < nch; ++ch) {
    const uint32_t b = sbase + (ch & 1) * buf_bytes;
    gw_fence_acc(acc);
    gw_wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      gtw_mma_mn<NS>(acc, gtw_desc_mn(b + wg * GTW_TILE + kk * 2048),
                     gtw_desc_mn(b + 2 * GTW_TILE + kk * 2048), 1);
    gw_wg_commit();
    gw_fence_acc(acc);
    if (ch + 1 < nch) {
      gtw_wg_in<NS>(j, p, sm + ((ch + 1) & 1) * buf_bytes,
                    kbeg + (ch + 1) * GTW_ROWS, kend, c0, n0, tid, dbsum, ds);
      gw_fence_async();
    }
    gw_wg_wait<0>();
    gw_fence_acc(acc);
    gw_bar(1, 256);
  }
  const size_t zb = (size_t)blockIdx.z * (j.K + 1) * j.N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = c0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    if (m >= j.K) continue;
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int n = n0 + s * 32 + q * 8 + 2 * (lane & 3) + b;
          if (n < j.N) j.part[zb + (size_t)m * j.N + n] = acc[s][q * 4 + h * 2 + b];
        }
  }
  if (!dbsum) return;
  float* dred = reinterpret_cast<float*>(sm + 2 * buf_bytes);  // [nrl][32 NS]
  const int gi = tid % ng, rl = tid / ng;
#pragma unroll
  for (int e = 0; e < 8; ++e) dred[rl * 32 * NS + gi * 8 + e] = ds[e];
  __syncthreads();
  for (int c = tid; c < 32 * NS; c += GTW_WG_THREADS) {
    const int n = n0 + c;
    if (n >= j.N) continue;
    float s = 0.f;
    for (int l = 0; l < nrl; ++l) s += dred[l * 32 * NS + c];
    j.part[zb + (size_t)j.K * j.N + n] = s;
  }
}

// K7-bf16's launch: the product of j (ops/group_train.py _GEMM_PTRS,
// _GEMM_INTS) with the plan p; the weight image (gtw_rows) or d (gtw_wgrad)
// at j.w.
static int run_gtw(const GJob& j, const GtwPlan& p, cudaStream_t st) {
  const bool rows = p.kind != GTW_WGRAD;
  if (j.K > GTW_MAX_K || p.smem > 232448 || p.smem < 1024 ||
      p.kind < 0 || p.kind > GTW_ROWS1 ||
      (!rows && (p.splits < 1 || p.rps < GTW_ROWS || p.rps % GTW_ROWS ||
                 (p.ns != 2 && p.ns != 4 && p.ns != 8))) ||
      (rows && (p.ns < 1 || p.ns > 8 || p.nst < 1 || p.nst > GTW_MAXST ||
                p.per < 1 || p.sb % 1024 || p.npass * 64 * p.ns < j.N ||
                p.nslab * 16 < j.K || p.atiles * 64 < j.K)) ||
      (p.kind == GTW_ROWS1 && (p.ns > 4 || (p.nst < 2 && !p.resident))) ||
      (p.kind == GTW_ROWS2 && p.ns != 8))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaErrorInvalidValue;
#define GTW_LAUNCH(KERNEL, NS, GRID, THREADS)                                \
  case NS:                                                                   \
    e = cudaFuncSetAttribute(KERNEL<NS>,                                     \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                             p.smem);                                        \
    if (e != cudaSuccess) return (int)e;                                     \
    KERNEL<NS><<<GRID, THREADS, p.smem, st>>>(j, p);                         \
    break;
  const int tiles = j.R > 0 ? (j.R + GTW_ROWS - 1) / GTW_ROWS : 1;
  if (p.kind == GTW_WGRAD) {
    const dim3 grid((j.K + 127) / 128, (j.N + 32 * p.ns - 1) / (32 * p.ns),
                    p.splits);
    switch (p.ns) {
      GTW_LAUNCH(gtw_wgrad, 2, grid, GTW_WG_THREADS)
      GTW_LAUNCH(gtw_wgrad, 4, grid, GTW_WG_THREADS)
      GTW_LAUNCH(gtw_wgrad, 8, grid, GTW_WG_THREADS)
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (p.kind == GTW_ROWS1) {
    switch (2 * p.ns) {  // one warpgroup takes the image's whole pass
      GTW_LAUNCH(gtw_rows1, 2, tiles, 128)
      GTW_LAUNCH(gtw_rows1, 4, tiles, 128)
      GTW_LAUNCH(gtw_rows1, 6, tiles, 128)
      GTW_LAUNCH(gtw_rows1, 8, tiles, 128)
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (p.ns) {  // passes of 512 columns, zero-padded past N
      GTW_LAUNCH(gtw_rows, 8, tiles, GTW_THREADS)
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef GTW_LAUNCH
  return (int)cudaGetLastError();
}
