// The warp-distributed sorted list of K3 (knn.cu), K5 and K10
// (grid_topk.cu): the k <= 32 best (d, i) pairs of a query (or row) spread
// over a warp, lane s holding the s-th, in the order of `before` (d, then
// i: K3's i is the point index, K5's the candidate's position in its
// stencil rows, K10's the column).  One
// candidate goes in by a ballot and a shift (insert_one), 32 at once by a
// bitonic sort and merge across the lanes (merge_all).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

// (d, i) before (bd, bi) in the list's order
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// the warp's list: lane s < k holds the s-th entry (d, i), (+inf, -1) when
// empty; lanes >= k hold (+inf, -1)
struct List {
  float d;
  int i;
};

// insert (cd, ci) (the same on every lane) if it is among the k first
__device__ __forceinline__ void insert_one(List& l, float cd, int ci, int lane,
                                           int k) {
  const unsigned after =
      __ballot_sync(0xffffffffu, lane < k && before(cd, ci, l.d, l.i));
  const float ud = __shfl_up_sync(0xffffffffu, l.d, 1);
  const int ui = __shfl_up_sync(0xffffffffu, l.i, 1);
  if (!after) return;
  const int pos = __ffs(after) - 1;
  if (lane == pos) {
    l.d = cd;
    l.i = ci;
  } else if (lane > pos && lane < k) {
    l.d = ud;
    l.i = ui;
  }
}

// one compare-exchange of a bitonic network across lanes: the lane keeps
// the first of the pair if `first`, else the second
__device__ __forceinline__ void exchange(float& d, int& i, int stride,
                                         bool first) {
  const float od = __shfl_xor_sync(0xffffffffu, d, stride);
  const int oi = __shfl_xor_sync(0xffffffffu, i, stride);
  if (before(od, oi, d, i) == first) {
    d = od;
    i = oi;
  }
}

// merge 32 candidates (one a lane, (+inf, -1) where none) into the list:
// bitonic sort of the candidates, the elementwise first of the list and
// the reversed candidates (the 32 first of both, bitonic), bitonic merge
__device__ __forceinline__ void merge_all(List& l, float cd, int ci, int lane,
                                          int k) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(cd, ci, stride,
               ((lane & stride) == 0) == ((lane & size) == 0 || size == 32));
  }
  const float rd = __shfl_sync(0xffffffffu, cd, 31 - lane);
  const int ri = __shfl_sync(0xffffffffu, ci, 31 - lane);
  if (before(rd, ri, l.d, l.i)) {
    l.d = rd;
    l.i = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange(l.d, l.i, stride, (lane & stride) == 0);
  if (lane >= k) {
    l.d = CUDART_INF_F;
    l.i = -1;
  }
}
