// The warp-distributed sorted list of K3 (knn.cu), K5 and K10
// (grid_topk.cu): the k <= 32 best (d, i) pairs of a query (or row) spread
// over a warp, lane s holding the s-th, in the order of `before` (d, then
// i: K3's i is the point index, K5's the candidate's position in its
// stencil rows, K10's the column).  One
// candidate goes in by a ballot and a shift (insert_one), 32 at once by a
// bitonic sort and merge across the lanes (merge_all).
//
// ListR<R> is the same list for k <= 32 R (K3's ball queries, k <= 128):
// slot s = 32 r + lane in register r, sorted across all 32 R slots.  One
// candidate takes a ballot a register and a shift that carries lane 31 of
// each register into lane 0 of the next; 32 take a bitonic sort and, a
// register at a time, a merge whose upper half goes on into the next.
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

template <int R>
struct ListR {
  float d[R];
  int i[R];
};

template <int R>
__device__ __forceinline__ void list_init(ListR<R>& l) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l.d[r] = CUDART_INF_F;
    l.i[r] = -1;
  }
}

// entry s (warp-uniform) of the list, on every lane
template <int R>
__device__ __forceinline__ void entry_at(const ListR<R>& l, int s, float& d,
                                         int& i) {
  float dv = l.d[0];
  int iv = l.i[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (r == (s >> 5)) {
      dv = l.d[r];
      iv = l.i[r];
    }
  d = __shfl_sync(0xffffffffu, dv, s & 31);
  i = __shfl_sync(0xffffffffu, iv, s & 31);
}

// insert (cd, ci) (the same on every lane) if it is among the k first
template <int R>
__device__ __forceinline__ void insert_one(ListR<R>& l, float cd, int ci,
                                           int lane, int k) {
  int pos = -1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned after = __ballot_sync(
        0xffffffffu, r * 32 + lane < k && before(cd, ci, l.d[r], l.i[r]));
    if (after) {
      pos = r * 32 + __ffs(after) - 1;
      break;
    }
  }
  if (pos < 0) return;
  // lane 31 of the register before, carried into lane 0
  float cd_prev = CUDART_INF_F;
  int ci_prev = -1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r * 32 + 31 < pos) continue;
    if (r * 32 >= k) break;
    float ud = __shfl_up_sync(0xffffffffu, l.d[r], 1);
    int ui = __shfl_up_sync(0xffffffffu, l.i[r], 1);
    const float td = __shfl_sync(0xffffffffu, l.d[r], 31);
    const int ti = __shfl_sync(0xffffffffu, l.i[r], 31);
    if (lane == 0) {
      ud = cd_prev;
      ui = ci_prev;
    }
    const int s = r * 32 + lane;
    if (s == pos) {
      l.d[r] = cd;
      l.i[r] = ci;
    } else if (s > pos && s < k) {
      l.d[r] = ud;
      l.i[r] = ui;
    }
    cd_prev = td;
    ci_prev = ti;
  }
}

// merge 32 candidates (one a lane, (+inf, -1) where none) into the list:
// the candidates sorted, then for each register in turn the elementwise
// first of it and the reversed candidates (its new 32 entries, bitonic)
// and the elementwise second (the 32 that go on to the next register,
// bitonic), each sorted by a bitonic merge; stops once no candidate is left
template <int R>
__device__ __forceinline__ void merge_all(ListR<R>& l, float cd, int ci,
                                          int lane, int k) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(cd, ci, stride,
               ((lane & stride) == 0) == ((lane & size) == 0 || size == 32));
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r * 32 >= k || !__any_sync(0xffffffffu, ci >= 0)) break;
    const float rd = __shfl_sync(0xffffffffu, cd, 31 - lane);
    const int ri = __shfl_sync(0xffffffffu, ci, 31 - lane);
    const bool take = before(rd, ri, l.d[r], l.i[r]);
    float ld = take ? rd : l.d[r], hd = take ? l.d[r] : rd;
    int li = take ? ri : l.i[r], hi = take ? l.i[r] : ri;
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1)
      exchange(ld, li, stride, (lane & stride) == 0);
    l.d[r] = ld;
    l.i[r] = li;
    if (r + 1 < R && (r + 1) * 32 < k) {
#pragma unroll
      for (int stride = 16; stride > 0; stride >>= 1)
        exchange(hd, hi, stride, (lane & stride) == 0);
    }
    cd = hd;
    ci = hi;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r * 32 + lane >= k) {
      l.d[r] = CUDART_INF_F;
      l.i[r] = -1;
    }
}
