// K5: grid-hash fixed-radius top-k over bucket-row records, and
// K10: masked k-smallest over the last axis with carried indices.
//
// K5 replaces curvecloudnet_tpu/ops/pallas_topk.py grid_topk_records (the
// Pallas kernel _grid_topk_kernel).  The table (ops/grid_knn.py) holds one
// row of `cap` records per hash bucket, each record a float4 [x, y, z,
// point index as int32 bits] (-1: empty), filled from slot 0; `counts`
// gives each row's live prefix.  For each valid query the kernel reads the
// S table rows that nbr_buckets names (its deduplicated stencil cells,
// then the shared overflow rows) straight from the table -- no per-cell
// planes are materialized -- and keeps the k nearest records with squared
// distance <= r2: ascending, ties to the earlier candidate in (stencil
// column, slot) order; unfilled slots are d2 1e30 / idx -1.  Distances are
// exact f32 (the Pallas kernel clears low mantissa bits to pack its
// extraction words; this kernel does not), computed as K3 computes them:
// round-to-nearest intrinsics in the order (dx*dx + dy*dy) + dz*dz of
// query - point, so kernel and plain version agree bit for bit.
//
// Bound on the H100: the bytes of the live records (each read once),
// ~0.013 ms a KITTI forward.  What a query costs instead: it reads all
// the live records of its S rows (~700 at the 73728-query table, so ~0.8
// GB a call, from L2: the live records take ~1 MB) and keeps its list.
// Design: a warp a query.  The lanes first read the query's S row ids and
// live counts (a lane a column); then, row by row, the lanes read 32
// consecutive records of the row, one coalesced 512-byte read, each lane
// a candidate: d2, the r2 test and the k-th reject (the k-th d2 is re-read
// only when the list changes); a ballot picks the survivors, which enter
// K3's warp-distributed list (warp_list.cuh) one by one, or, past 4 of
// them, by a bitonic merge.  The list orders (d2, candidate position), the
// position being column x cap + slot, so ties go to the earlier candidate
// whatever the order of the merges; the k-th reject is strict on that
// order (a later candidate at the k-th d2 never enters), and the positions
// are mapped back to point indices (one record read an output slot) at
// the end.
//
// K10 replaces curvecloudnet_tpu/ops/pallas_topk.py topk_smallest (the
// Pallas kernel _topk_kernel): per row of d (Q, W), the k smallest
// entries with their idx, ascending, ties to the lower column; entries
// not below 0.98e30 come out as 1e30 / -1.  Values are exact (the Pallas
// kernel quantizes them).  Bound: the bytes of d (each read once), and of
// idx and the outputs at the k chosen columns a row -- the function needs
// no other idx (the KITTI planes: ~1.9 GB of d over the forward's two
// calls, ~0.57 ms at 3.35 TB/s).
// Design: a warp a row, as K5.  Each read is 128 consecutive values of the
// row, a float4 a lane (W % 4 == 0 and d 16-byte aligned; else 32
// values, one a lane), TOPK_BATCH reads in flight a lane, streamed past
// L1 (__ldcs).  Reads go in column order, so every candidate lies after
// every list entry: the strict reject v < k-th value (taken before the
// read) keeps ties on the lower column, and fills (>= 0.98e30) never
// enter.  A ballot per component of the float4 collects the survivors;
// they enter K3's warp list (warp_list.cuh) keyed (value, column), one at
// a time, or, when a read has more than 4, compacted through the warp's
// 128-entry shared-memory buffer and merged 32 at a time by the bitonic
// merge (one merge for up to 32 survivors, not one a component).  idx is
// read only at the k chosen columns, at the end.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "warp_list.cuh"

#define GRID_WARPS 8
#define TOPK_WARPS 8
#define TOPK_BATCH 4  // reads of a row a lane keeps in flight
#define TOPK_LIMIT 0.98e30f

__global__ void __launch_bounds__(GRID_WARPS * 32)
    grid_topk_kernel(const float4* __restrict__ table,
                     const int* __restrict__ counts,
                     const int* __restrict__ nbr,
                     const float* __restrict__ query,
                     const unsigned char* __restrict__ q_valid, int Q, int S,
                     int cap, int k, float r2, float* __restrict__ out_d2,
                     int* __restrict__ out_idx) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * GRID_WARPS + (threadIdx.x >> 5);
  if (qi >= Q) return;
  const int* rows = nbr + (size_t)qi * S;
  List l = {CUDART_INF_F, -1};
  float kd = CUDART_INF_F;  // the list's k-th d2, on every lane
  if (q_valid[qi]) {
    const float qx = query[3 * (size_t)qi];
    const float qy = query[3 * (size_t)qi + 1];
    const float qz = query[3 * (size_t)qi + 2];
    for (int c0 = 0; c0 < S; c0 += 32) {
      // lane c: the row id and live count of column c0 + c
      const bool has = c0 + lane < S;
      const int my_row = has ? __ldg(rows + c0 + lane) : 0;
      const int my_live = has ? __ldg(counts + my_row) : 0;
      for (int cc = 0; cc < min(32, S - c0); ++cc) {
        const int live = __shfl_sync(full, my_live, cc);
        const float4* rec =
            table + (size_t)__shfl_sync(full, my_row, cc) * cap;
        const int base = (c0 + cc) * cap;
        for (int j0 = 0; j0 < live; j0 += 32) {
          const int j = j0 + lane;
          float d2 = CUDART_INF_F;
          bool acc = false;
          if (j < live) {
            const float4 p = __ldg(rec + j);
            const float dx = __fsub_rn(qx, p.x);
            const float dy = __fsub_rn(qy, p.y);
            const float dz = __fsub_rn(qz, p.z);
            d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                           __fmul_rn(dz, dz));
            acc = __float_as_int(p.w) >= 0 && d2 <= r2;
          }
          // candidates come in position order, after every list entry, so
          // (d2, position) precedes the k-th entry iff d2 < its d2
          unsigned mask = __ballot_sync(full, acc && d2 < kd);
          if (!mask) continue;
          if (__popc(mask) > 4) {
            const bool in = (mask >> lane) & 1;
            merge_all(l, in ? d2 : CUDART_INF_F, in ? base + j : -1, lane,
                      k);
          } else {
            do {
              const int src = __ffs(mask) - 1;
              mask &= mask - 1;
              insert_one(l, __shfl_sync(full, d2, src), base + j0 + src,
                         lane, k);
            } while (mask);
          }
          kd = __shfl_sync(full, l.d, k - 1);
        }
      }
    }
  }
  if (lane < k) {
    float d = 1e30f;
    int id = -1;
    if (l.i >= 0) {
      const int col = l.i / cap;
      d = l.d;
      id = __float_as_int(
          table[(size_t)__ldg(rows + col) * cap + l.i - col * cap].w);
    }
    out_d2[(size_t)qi * k + lane] = d;
    out_idx[(size_t)qi * k + lane] = id;
  }
}

// K10: a warp a row; PER values a lane a read (4: float4 reads)
template <int PER>
__global__ void __launch_bounds__(TOPK_WARPS * 32)
    topk_smallest_kernel(const float* __restrict__ d,
                         const int* __restrict__ idx, int Q, int W, int k,
                         float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int SPAN = 32 * PER;  // columns a read
  __shared__ float buf_v[TOPK_WARPS][SPAN];  // a read's survivors, compacted
  __shared__ int buf_c[TOPK_WARPS][SPAN];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * TOPK_WARPS + warp;
  if (row >= Q) return;
  const float* dr = d + (size_t)row * W;
  List l = {CUDART_INF_F, -1};
  float kd = CUDART_INF_F;  // the list's k-th value, on every lane
  for (int c0 = 0; c0 < W; c0 += TOPK_BATCH * SPAN) {
    float v[TOPK_BATCH][PER];
#pragma unroll
    for (int u = 0; u < TOPK_BATCH; ++u) {
      const int c = c0 + u * SPAN + lane * PER;
      if constexpr (PER == 4) {
        const float4 x = c < W ? __ldcs(reinterpret_cast<const float4*>(dr + c))
                               : make_float4(CUDART_INF_F, CUDART_INF_F,
                                             CUDART_INF_F, CUDART_INF_F);
        v[u][0] = x.x;
        v[u][1] = x.y;
        v[u][2] = x.z;
        v[u][3] = x.w;
      } else {
        v[u][0] = c < W ? __ldcs(dr + c) : CUDART_INF_F;
      }
    }
#pragma unroll
    for (int u = 0; u < TOPK_BATCH; ++u) {
      const int base = c0 + u * SPAN;
      // the read's columns all follow the list's: v < kd is the exact
      // (value, column) reject against the k-th entry
      unsigned m[PER];
      int n = 0;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        m[e] = __ballot_sync(full, v[u][e] < kd && v[u][e] < TOPK_LIMIT);
        n += __popc(m[e]);
      }
      if (n == 0) continue;
      if (n <= 4) {
#pragma unroll
        for (int e = 0; e < PER; ++e)
          while (m[e]) {
            const int src = __ffs(m[e]) - 1;
            m[e] &= m[e] - 1;
            insert_one(l, __shfl_sync(full, v[u][e], src),
                       base + src * PER + e, lane, k);
          }
      } else {
        // the survivors in the warp's buffer, in (component, lane) order
        // (the merges order by (value, column) whatever the order)
        const unsigned below = (1u << lane) - 1;
        int at = 0;
#pragma unroll
        for (int e = 0; e < PER; ++e) {
          if ((m[e] >> lane) & 1) {
            const int slot = at + __popc(m[e] & below);
            buf_v[warp][slot] = v[u][e];
            buf_c[warp][slot] = base + lane * PER + e;
          }
          at += __popc(m[e]);
        }
        __syncwarp();
        for (int r = 0; r < n; r += 32) {
          const bool in = r + lane < n;
          merge_all(l, in ? buf_v[warp][r + lane] : CUDART_INF_F,
                    in ? buf_c[warp][r + lane] : -1, lane, k);
        }
        __syncwarp();
      }
      kd = __shfl_sync(full, l.d, k - 1);
    }
  }
  if (lane < k) {
    const bool found = l.i >= 0;
    out_d[(size_t)row * k + lane] = found ? l.d : 1e30f;
    out_i[(size_t)row * k + lane] =
        found ? __ldg(idx + (size_t)row * W + l.i) : -1;
  }
}

// table (R, cap, 4) f32 (16-byte aligned), counts (R,) int32, nbr (Q, S)
// int32 rows of the table, query (Q, 3) f32, q_valid (Q,) bool;
// out d2 (Q, k) f32, idx (Q, k) int32.
extern "C" int ccn_grid_topk(const float* table, const int* counts,
                             const int* nbr, const float* query,
                             const unsigned char* q_valid, int Q, int S,
                             int cap, int k, float r2, float* d2, int* idx,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > 32 || Q < 1 || S < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  grid_topk_kernel<<<(Q + GRID_WARPS - 1) / GRID_WARPS, GRID_WARPS * 32, 0,
                     st>>>((const float4*)table, counts, nbr, query, q_valid,
                           Q, S, cap, k, r2, d2, idx);
  return (int)cudaGetLastError();
}

// d (Q, W) f32, idx (Q, W) int32; out (Q, k) each.
extern "C" int ccn_topk_smallest(const float* d, const int* idx, int Q, int W,
                                 int k, float* out_d, int* out_i,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > 32 || Q < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (Q + TOPK_WARPS - 1) / TOPK_WARPS;
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0)
    topk_smallest_kernel<4><<<blocks, TOPK_WARPS * 32, 0, st>>>(
        d, idx, Q, W, k, out_d, out_i);
  else
    topk_smallest_kernel<1><<<blocks, TOPK_WARPS * 32, 0, st>>>(
        d, idx, Q, W, k, out_d, out_i);
  return (int)cudaGetLastError();
}
