// K3: exact masked kNN, k <= 128, optional radius, that skips the point
// tiles a bounding box proves too far.
//
// Replaces curvecloudnet_tpu/ops/pallas_knn.py knn_pallas_single (the
// Pallas kernel _knn_kernel).  For each valid query, the k nearest valid
// points with squared distance <= r2 (r2 = +inf without a radius), in
// ascending distance, ties to the lower point index; unfilled slots are
// idx -1 / dist 1e30.  Distances are exact f32 (the Pallas kernel drops
// low mantissa bits to pack (d2 | column) words; this kernel does not).
//
// Bound on the H100: the bytes of its inputs and outputs, and 8 FLOP a
// pair of a query and a point in the tiles whose box lies within the
// query's final k-th distance (any exact search must open those): ~2 us
// at the flagship's 23040-point table (chip_smoke.py), where brute force
// is 5.3e8 pairs.  A row is in curve (scan) order, so a query's k <= 32
// neighbours lie in a few 32-point tiles of it and the rest can be proven
// useless; what is left is latency: a query's walk over boxes and its few
// visited tiles, with the list's upkeep.
//
// Design.  A pre-pass writes, for each tile of 32 consecutive points, the
// points packed as float4 (x, y, z, valid) and the f32 bounding box of its
// valid points (an empty tile: lo = +inf, hi = -inf, never visited), and the
// box of each super-tile of 32 tiles.  The search runs one warp a query.
// The list is spread over the warp, lane s holding the s-th entry (d2,
// index) (warp_list.cuh, which K5 shares); for k > 32 (the ball queries of
// the version-1.0 models' sa steps, k = 128) a lane holds R = 2 or 4
// entries, slot 32 r + lane in its register r (ListR<R>), and nothing else
// changes, k <= 32 keeping the one-register list.  Each lane holds the box
// d2 of
// super-tiles lane, lane + 32, ...; the warp visits the nearest super-tile
// left whose box d2 is within min(k-th best, r2), and in it, the nearest
// tile left within the same test, each found by two redux.sync; so the first
// tiles visited are the query's own and the k-th best falls at once.  A
// visited tile is read as one coalesced float4 a lane; the lanes whose point
// beats the k-th entry are inserted one by one (a ballot finds the slot,
// shfl_up shifts the rest), or, past 4 of them, merged at once (bitonic sort
// of the 32 candidates across lanes, then a bitonic merge with the list).
// Lane-per-query warps were tried first: their lanes' insertions serialise
// the warp and the small tables' few warps left most SMs idle.
//
// Rows without scan-order locality.  Their tile boxes each span most of
// the row, so every tile is opened, and a warp a query costs ~2x a thread
// a query sweeping the points through shared memory (4.5 against 2.2 ms
// at the 47924-query, 36864-point fp set, k 3, tools/knn_sweep.py).  For
// calls of k <= 8 with many queries (the wrapper's gate), a second kernel
// is launched: the brute-force route, two queries a thread, each shared
// point compared with both.  The pre-pass measures how much of its
// super-tile's box a tile's box fills; a row where that is large takes
// the brute-force route and the tiled search skips it, the other rows the
// reverse.  Both routes are exact, so the choice moves only time.
//
// Why it is exact.  A box is skipped only when its d2 is strictly greater
// than min(k-th best, r2): a point at an equal d2 could still displace the
// k-th entry by a lower index; the k-th best only falls, so a box skipped
// once stays useless.  Box gaps are max(lo - q, q - hi, 0) per axis with
// the same __fsub_rn / __fmul_rn / __fadd_rn as the point distance;
// rounding to nearest is monotone and symmetric, so a box's d2 never
// exceeds any member's computed d2, nor a super-tile's a tile's.  Tiles
// are visited out of index order, so the list orders (d2, index) pairs:
// it is the plain version's stable sort prefix.  Distances use the order
// (dx*dx + dy*dy) + dz*dz without FMA contraction, and sqrtf is correctly
// rounded, so they equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "warp_list.cuh"

#define KNN_TILE 32
#define KNN_WARPS 8

// The R = 1 list (warp_list.cuh's List, as K5 and K10 use it) and the
// R-register one behind one interface: entry s on every lane, the k-th
// distance alone (the search's threshold), and the lane's own slot of
// register r.
__device__ __forceinline__ void list_init(List& l) {
  l.d = CUDART_INF_F;
  l.i = -1;
}
__device__ __forceinline__ void entry_at(const List& l, int s, float& d,
                                         int& i) {
  d = __shfl_sync(0xffffffffu, l.d, s);
  i = __shfl_sync(0xffffffffu, l.i, s);
}
__device__ __forceinline__ float kth_d(const List& l, int k) {
  return __shfl_sync(0xffffffffu, l.d, k - 1);
}
template <int R>
__device__ __forceinline__ float kth_d(const ListR<R>& l, int k) {
  float d = l.d[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (r == ((k - 1) >> 5)) d = l.d[r];
  return __shfl_sync(0xffffffffu, d, (k - 1) & 31);
}
__device__ __forceinline__ void own_slot(const List& l, int, float& d,
                                         int& i) {
  d = l.d;
  i = l.i;
}
template <int R>
__device__ __forceinline__ void own_slot(const ListR<R>& l, int r, float& d,
                                         int& i) {
  d = l.d[r];
  i = l.i[r];
}
template <class L>
struct ListRegs {
  static constexpr int value = 1;
};
template <int R>
struct ListRegs<ListR<R>> {
  static constexpr int value = R;
};

// warp-wide min of lo and max of hi, every lane gets them
__device__ __forceinline__ void box_reduce(float4& lo, float4& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo.x = fminf(lo.x, __shfl_xor_sync(0xffffffffu, lo.x, off));
    lo.y = fminf(lo.y, __shfl_xor_sync(0xffffffffu, lo.y, off));
    lo.z = fminf(lo.z, __shfl_xor_sync(0xffffffffu, lo.z, off));
    hi.x = fmaxf(hi.x, __shfl_xor_sync(0xffffffffu, hi.x, off));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(0xffffffffu, hi.y, off));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(0xffffffffu, hi.z, off));
  }
}

// the share of [slo, shi] that [tlo, thi] spans (1 for an empty side)
__device__ __forceinline__ float share(float tlo, float thi, float slo,
                                       float shi) {
  return shi > slo ? (thi - tlo) / (shi - slo) : 1.f;
}

// pre-pass, one block of 32 warps a super-tile, one warp a tile: packed
// (B, NT * 32) float4 (x, y, z, valid); boxes (B, NT, 2) and supers (B,
// NS, 2) float4 (lo, hi) over the valid points (empty: +inf / -inf)
__global__ void __launch_bounds__(1024)
    knn_tiles(const float* __restrict__ points,
              const unsigned char* __restrict__ p_valid, int N, int NT,
              int NS, float4* __restrict__ packed, float4* __restrict__ boxes,
              float4* __restrict__ supers) {
  __shared__ float4 tb[32][2];
  const int b = blockIdx.y, s = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int t = s * 32 + w;
  const int j = t * KNN_TILE + lane;
  float x = 0.f, y = 0.f, z = 0.f;
  bool v = false;
  if (j < N) {
    const float* p = points + ((size_t)b * N + j) * 3;
    x = p[0];
    y = p[1];
    z = p[2];
    v = p_valid[(size_t)b * N + j] != 0;
  }
  if (t < NT)
    packed[(size_t)b * NT * KNN_TILE + j] =
        make_float4(x, y, z, v ? 1.f : 0.f);
  float4 lo = make_float4(v ? x : CUDART_INF_F, v ? y : CUDART_INF_F,
                          v ? z : CUDART_INF_F, 0.f);
  float4 hi = make_float4(v ? x : -CUDART_INF_F, v ? y : -CUDART_INF_F,
                          v ? z : -CUDART_INF_F, 0.f);
  box_reduce(lo, hi);
  if (lane == 0) {
    tb[w][0] = lo;
    tb[w][1] = hi;
    if (t < NT) {
      boxes[((size_t)b * NT + t) * 2] = lo;
      boxes[((size_t)b * NT + t) * 2 + 1] = hi;
    }
  }
  __syncthreads();
  if (w == 0) {
    const float4 tlo = tb[lane][0], thi = tb[lane][1];
    lo = tlo;
    hi = thi;
    box_reduce(lo, hi);
    // the share of the super-tile's box that the tile's box fills (-1 for
    // an empty tile), and lo.w: its mean over the non-empty tiles (-1 for
    // an empty super-tile)
    const float vol = tlo.x <= thi.x ? share(tlo.x, thi.x, lo.x, hi.x) *
                                           share(tlo.y, thi.y, lo.y, hi.y) *
                                           share(tlo.z, thi.z, lo.z, hi.z)
                                     : -1.f;
    float sum = fmaxf(vol, 0.f);
    int cnt = vol >= 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    }
    lo.w = cnt == 0 ? -1.f : sum / cnt;
    if (lane == 0) {
      supers[((size_t)b * NS + s) * 2] = lo;
      supers[((size_t)b * NS + s) * 2 + 1] = hi;
    }
  }
}

// Whether batch row b takes the brute-force route: its tile boxes fill on
// average at least KNN_BRUTE_SPREAD of their super-tile's box (over the
// non-empty ones of the first 32 super-tiles), so the boxes cannot cull:
// a row in scan order has tiles along a beam, which fill 0.4-18% of it
// (synthetic sweeps of 32 and 64 beams), a row in random order 25-40%.
// Every warp computes it alike (fixed order).
#define KNN_BRUTE_SPREAD 0.2f
__device__ __forceinline__ bool brute_row(const float4* __restrict__ supers,
                                          int NS, int b, int lane) {
  const float r = lane < NS ? supers[((size_t)b * NS + lane) * 2].w : -1.f;
  float sum = fmaxf(r, 0.f);
  int cnt = r >= 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  return cnt > 0 && sum >= KNN_BRUTE_SPREAD * cnt;
}

// max(lo - q, q - hi, 0) on one axis, rounded as the point distance is
__device__ __forceinline__ float gap(float lo, float hi, float q) {
  return fmaxf(fmaxf(__fsub_rn(lo, q), __fsub_rn(q, hi)), 0.f);
}

__device__ __forceinline__ float norm2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// squared distance from q to a box, a lower bound of every member's d2
// (+inf for an empty box)
__device__ __forceinline__ float box_d2(float4 lo, float4 hi, float qx,
                                        float qy, float qz) {
  return norm2(gap(lo.x, hi.x, qx), gap(lo.y, hi.y, qy),
               gap(lo.z, hi.z, qz));
}

// tile t's 32 points, one a lane, into the list
template <class L>
__device__ __forceinline__ void visit(L& l, const float4* pk, int t,
                                      int lane, int k, float qx, float qy,
                                      float qz, float r2) {
  const float4 c = pk[t * KNN_TILE + lane];
  const float d2 =
      norm2(__fsub_rn(qx, c.x), __fsub_rn(qy, c.y), __fsub_rn(qz, c.z));
  const int ci = t * KNN_TILE + lane;
  float kd;
  int ki;
  entry_at(l, k - 1, kd, ki);
  const bool acc = c.w != 0.f && d2 <= r2 && before(d2, ci, kd, ki);
  unsigned mask = __ballot_sync(0xffffffffu, acc);
  if (__popc(mask) > 4) {
    merge_all(l, acc ? d2 : CUDART_INF_F, acc ? ci : -1, lane, k);
    return;
  }
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    insert_one(l, __shfl_sync(0xffffffffu, d2, src), t * KNN_TILE + src,
               lane, k);
  }
}

// the lowest (key, index) of the warp: every lane gets the index (NONE if
// every key is NONE)
#define NONE 0xffffffffu
__device__ __forceinline__ unsigned argmin(unsigned key, unsigned idx) {
  const unsigned m = __reduce_min_sync(0xffffffffu, key);
  return m == NONE ? NONE
                   : __reduce_min_sync(0xffffffffu, key == m ? idx : NONE);
}

// a box's d2 as a key for argmin, NONE when the box is proven too far
__device__ __forceinline__ unsigned near_key(float d2, float thr) {
  return d2 <= thr && d2 < CUDART_INF_F ? __float_as_uint(d2) : NONE;
}

template <int SR, class L>
__global__ void __launch_bounds__(KNN_WARPS * 32)
    knn_kernel(const float* __restrict__ query,
               const unsigned char* __restrict__ q_valid,
               const float4* __restrict__ packed,
               const float4* __restrict__ boxes,
               const float4* __restrict__ supers, int Q, int NT, int NS,
               int k, float r2, int brute, int* __restrict__ out_idx,
               float* __restrict__ out_dist,
               unsigned long long* __restrict__ visits) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * KNN_WARPS + (threadIdx.x >> 5);
  if (q >= Q || (brute && brute_row(supers, NS, b, lane))) return;
  const bool active = q_valid[(size_t)b * Q + q] != 0;
  L l;
  list_init(l);
  unsigned n_visited = 0;
  if (active) {
    const float* qq = query + ((size_t)b * Q + q) * 3;
    const float qx = qq[0], qy = qq[1], qz = qq[2];
    const float4* pk = packed + (size_t)b * NT * KNN_TILE;
    const float4* bx = boxes + (size_t)b * NT * 2;
    const float4* sp = supers + (size_t)b * NS * 2;
    // each lane holds the d2 of super-tiles lane, lane + 32, ...
    float sd[SR];
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      const int s = r * 32 + lane;
      sd[r] = s < NS ? box_d2(sp[2 * s], sp[2 * s + 1], qx, qy, qz)
                     : CUDART_INF_F;
    }
    for (;;) {
      // the nearest super-tile not yet visited within the threshold
      float thr = fminf(kth_d(l, k), r2);
      unsigned key = NONE, at = NONE;
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        const unsigned kr = near_key(sd[r], thr);
        if (kr < key) {
          key = kr;
          at = r * 32 + lane;
        }
      }
      const unsigned s = argmin(key, at);
      if (s == NONE) break;
#pragma unroll
      for (int r = 0; r < SR; ++r)
        if (r * 32 + lane == (int)s) sd[r] = CUDART_INF_F;
      // its tiles, nearest first, while one is within the threshold
      const int t = (int)s * 32 + lane;
      float td = CUDART_INF_F;
      if (t < NT) td = box_d2(bx[2 * t], bx[2 * t + 1], qx, qy, qz);
      for (;;) {
        thr = fminf(kth_d(l, k), r2);
        const unsigned src = argmin(near_key(td, thr), lane);
        if (src == NONE) break;
        if (lane == (int)src) td = CUDART_INF_F;
        visit(l, pk, (int)s * 32 + (int)src, lane, k, qx, qy, qz, r2);
        ++n_visited;
      }
    }
  }
  if (visits != nullptr && lane == 0 && active) {
    atomicAdd(visits, (unsigned long long)n_visited);
    atomicAdd(visits + 1, (unsigned long long)NT);
  }
#pragma unroll
  for (int r = 0; r < ListRegs<L>::value; ++r) {
    const int s = r * 32 + lane;
    if (s >= k) break;
    float d;
    int i;
    own_slot(l, r, d, i);
    const size_t o = ((size_t)b * Q + q) * k + s;
    const bool good = active && i >= 0;
    out_idx[o] = good ? i : -1;
    out_dist[o] = good ? sqrtf(d) : 1e30f;
  }
}

// The brute-force route, for rows without scan-order locality: a query
// is split over KNN_SPLITS consecutive lanes, each sweeping one
// contiguous part of the row, and a thread holds QT queries (each point
// read from shared memory once for all of them).  Each keeps its k best
// of its part in registers: a sorted list of MAXK slots, the first MAXK -
// k held at -inf so exactly k are live, seeded with the first float above
// r2; an insertion is strict, so ties keep the lower index.  The lanes'
// lists are then merged pairwise over shuffles on (d2, index).  The split
// is for parallelism: a thread a query leaves most of the card idle at
// the fp sets' ~5e4 queries.
#define KNN_BRUTE_THREADS 128
#define KNN_SPLITS 4
#define KNN_CHUNK 256
template <int MAXK, int QT>
__global__ void __launch_bounds__(KNN_BRUTE_THREADS)
    knn_brute(const float* __restrict__ query,
              const unsigned char* __restrict__ q_valid,
              const float4* __restrict__ packed,
              const float4* __restrict__ supers, int Q, int NT, int NS, int k,
              float r2, int* __restrict__ out_idx,
              float* __restrict__ out_dist,
              unsigned long long* __restrict__ visits) {
  // a part's chunk a row, padded so the parts' rows sit in other banks
  __shared__ float4 tile[KNN_SPLITS][KNN_CHUNK + 1];
  const int b = blockIdx.y, tid = threadIdx.x;
  if (!brute_row(supers, NS, b, tid & 31)) return;
  constexpr int PER = KNN_BRUTE_THREADS / KNN_SPLITS;   // queries a slot
  const int part = tid % KNN_SPLITS, slot = tid / KNN_SPLITS;
  const float seed = r2 < CUDART_INF_F ? nextafterf(r2, CUDART_INF_F) : r2;
  float qx[QT], qy[QT], qz[QT], bd[QT][MAXK];
  int bi[QT][MAXK];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    const int q = min((blockIdx.x * QT + r) * PER + slot, Q - 1);
    const float* qq = query + ((size_t)b * Q + q) * 3;
    qx[r] = qq[0];
    qy[r] = qq[1];
    qz[r] = qq[2];
#pragma unroll
    for (int s = 0; s < MAXK; ++s) {
      bd[r][s] = s < MAXK - k ? -CUDART_INF_F : seed;
      bi[r][s] = -1;
    }
  }
  const float4* pk = packed + (size_t)b * NT * KNN_TILE;
  // parts of whole chunks; the last may be short or empty
  const int n = NT * KNN_TILE;
  const int len = (n + KNN_SPLITS * KNN_CHUNK - 1) / (KNN_SPLITS * KNN_CHUNK)
                  * KNN_CHUNK;
  for (int base = 0; base < len; base += KNN_CHUNK) {
    __syncthreads();
    for (int e = tid; e < KNN_SPLITS * KNN_CHUNK; e += KNN_BRUTE_THREADS) {
      const int p = e / KNN_CHUNK, j = e % KNN_CHUNK;
      const int g = p * len + base + j;
      float4 c = g < n ? pk[g] : make_float4(0.f, 0.f, 0.f, 0.f);
      if (c.w == 0.f) c.x = CUDART_INF_F;   // an invalid point: d2 = inf
      tile[p][j] = c;
    }
    __syncthreads();
    const int from = part * len + base;
#pragma unroll 4
    for (int j = 0; j < KNN_CHUNK; ++j) {
      const float4 c = tile[part][j];
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        const float d2 = norm2(__fsub_rn(qx[r], c.x), __fsub_rn(qy[r], c.y),
                               __fsub_rn(qz[r], c.z));
        if (d2 < bd[r][MAXK - 1]) {
          float cd = d2;
          int ci = from + j;
#pragma unroll
          for (int s = 0; s < MAXK; ++s) {
            if (cd < bd[r][s]) {
              const float td = bd[r][s];
              const int ti = bi[r][s];
              bd[r][s] = cd;
              bi[r][s] = ci;
              cd = td;
              ci = ti;
            }
          }
        }
      }
    }
  }
  // merge the parts' lists: with the partner lane at distance 1, then 2
#pragma unroll
  for (int m = 1; m < KNN_SPLITS; m <<= 1) {
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      float od[MAXK];
      int oi[MAXK];
#pragma unroll
      for (int s = 0; s < MAXK; ++s) {
        od[s] = __shfl_xor_sync(0xffffffffu, bd[r][s], m);
        oi[s] = __shfl_xor_sync(0xffffffffu, bi[r][s], m);
      }
#pragma unroll
      for (int t = 0; t < MAXK; ++t) {
        if (oi[t] < 0) continue;
        float cd = od[t];
        int ci = oi[t];
#pragma unroll
        for (int s = 0; s < MAXK; ++s) {
          if (before(cd, ci, bd[r][s], bi[r][s])) {
            const float td = bd[r][s];
            const int ti = bi[r][s];
            bd[r][s] = cd;
            bi[r][s] = ci;
            cd = td;
            ci = ti;
          }
        }
      }
    }
  }
  unsigned n_active = 0;
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    const int q = (blockIdx.x * QT + r) * PER + slot;
    const bool active = q < Q && q_valid[(size_t)b * Q + q] != 0;
    if (part != 0 || q >= Q) continue;
    n_active += active;
    const size_t o = ((size_t)b * Q + q) * k;
#pragma unroll
    for (int s = 0; s < MAXK; ++s) {
      if (s < MAXK - k) continue;
      const bool good = active && bi[r][s] >= 0;
      out_idx[o + s - (MAXK - k)] = good ? bi[r][s] : -1;
      out_dist[o + s - (MAXK - k)] = good ? sqrtf(bd[r][s]) : 1e30f;
    }
  }
  if (visits != nullptr && n_active) {
    atomicAdd(visits, (unsigned long long)n_active * NT);
    atomicAdd(visits + 1, (unsigned long long)n_active * NT);
  }
}

template <int SR, class L>
static void launch(const float* q, const unsigned char* qv,
                   const float4* packed, const float4* boxes,
                   const float4* supers, int B, int Q, int NT, int NS, int k,
                   float r2, int brute, int* idx, float* dist,
                   unsigned long long* visits, cudaStream_t st) {
  dim3 grid((Q + KNN_WARPS - 1) / KNN_WARPS, B);
  knn_kernel<SR, L><<<grid, 32 * KNN_WARPS, 0, st>>>(
      q, qv, packed, boxes, supers, Q, NT, NS, k, r2, brute, idx, dist,
      visits);
}

// the search with the list of k: one register a lane up to k = 32, two up
// to 64, four up to 128
template <int SR>
static void launch_k(const float* q, const unsigned char* qv,
                     const float4* packed, const float4* boxes,
                     const float4* supers, int B, int Q, int NT, int NS,
                     int k, float r2, int brute, int* idx, float* dist,
                     unsigned long long* visits, cudaStream_t st) {
  if (k <= 32)
    launch<SR, List>(q, qv, packed, boxes, supers, B, Q, NT, NS, k, r2,
                     brute, idx, dist, visits, st);
  else if (k <= 64)
    launch<SR, ListR<2>>(q, qv, packed, boxes, supers, B, Q, NT, NS, k, r2,
                         brute, idx, dist, visits, st);
  else
    launch<SR, ListR<4>>(q, qv, packed, boxes, supers, B, Q, NT, NS, k, r2,
                         brute, idx, dist, visits, st);
}

template <int MAXK, int QT>
static void launch_brute(const float* q, const unsigned char* qv,
                         const float4* packed, const float4* supers, int B,
                         int Q, int NT, int NS, int k, float r2, int* idx,
                         float* dist, unsigned long long* visits,
                         cudaStream_t st) {
  const int per = KNN_BRUTE_THREADS / KNN_SPLITS * QT;
  dim3 grid((Q + per - 1) / per, B);
  knn_brute<MAXK, QT><<<grid, KNN_BRUTE_THREADS, 0, st>>>(
      q, qv, packed, supers, Q, NT, NS, k, r2, idx, dist, visits);
}

// query (B, Q, 3), points (B, N, 3) f32; q_valid (B, Q), p_valid (B, N)
// bool; scratch: packed (B, NT * 32) float4, boxes (B, NT, 2) float4 and
// supers (B, NS, 2) float4 (NT = ceil(N / 32), NS = ceil(NT / 32) <= 256);
// out idx (B, Q, k) int32, dist (B, Q, k) f32; visits (2 uint64, zeroed,
// or null): tiles visited, tiles the valid queries could visit.  `brute`
// (k <= 8 only): also launch the brute-force route, which a row takes
// when its tiles are spread (brute_row) and the tiled search then skips.
extern "C" int ccn_knn(const float* query, const float* points,
                       const unsigned char* q_valid,
                       const unsigned char* p_valid, int B, int Q, int N,
                       int k, float r2, int brute, void* packed, void* boxes,
                       void* supers, int* idx, float* dist,
                       unsigned long long* visits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int NT = (N + KNN_TILE - 1) / KNN_TILE;
  const int NS = (NT + 31) / 32;
  if (k < 1 || k > 128 || Q < 1 || N < 1 || B < 1 || NS > 256 ||
      (brute && k > 8))
    return (int)cudaErrorInvalidValue;
  float4* pk = (float4*)packed;
  float4* bx = (float4*)boxes;
  float4* sp = (float4*)supers;
  knn_tiles<<<dim3(NS, B), 1024, 0, st>>>(points, p_valid, N, NT, NS, pk, bx,
                                           sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (NS <= 32)
    launch_k<1>(query, q_valid, pk, bx, sp, B, Q, NT, NS, k, r2, brute,
                idx, dist, visits, st);
  else if (NS <= 64)
    launch_k<2>(query, q_valid, pk, bx, sp, B, Q, NT, NS, k, r2, brute,
                idx, dist, visits, st);
  else if (NS <= 128)
    launch_k<4>(query, q_valid, pk, bx, sp, B, Q, NT, NS, k, r2, brute,
                idx, dist, visits, st);
  else
    launch_k<8>(query, q_valid, pk, bx, sp, B, Q, NT, NS, k, r2, brute,
                idx, dist, visits, st);
  e = cudaGetLastError();
  if (e != cudaSuccess || !brute) return (int)e;
  if (k <= 4)
    launch_brute<4, 2>(query, q_valid, pk, sp, B, Q, NT, NS, k, r2, idx,
                       dist, visits, st);
  else
    launch_brute<8, 2>(query, q_valid, pk, sp, B, Q, NT, NS, k, r2, idx,
                       dist, visits, st);
  return (int)cudaGetLastError();
}
