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
// kernel quantizes them).  Bound: the bytes of d and idx, each read once.
// Design: a block of TOPK_ROWS threads owns TOPK_ROWS rows; it stages
// TOPK_COLS-column tiles of d and idx in shared memory with coalesced
// loads (one thread a column), then each thread scans its own row of the
// tile into a register top-k (topk_insert).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "warp_list.cuh"

#define GRID_WARPS 8
#define TOPK_ROWS 64
#define TOPK_COLS 64

// Insert (cd, ci) into the ascending register list if cd < its last
// entry; strict comparisons keep the earlier of equal candidates.
template <int MAXK>
__device__ __forceinline__ void topk_insert(float (&bd)[MAXK], int (&bi)[MAXK],
                                            float cd, int ci) {
#pragma unroll
  for (int s = 0; s < MAXK; ++s) {
    if (cd < bd[s]) {
      const float td = bd[s];
      const int ti = bi[s];
      bd[s] = cd;
      bi[s] = ci;
      cd = td;
      ci = ti;
    }
  }
}

template <int MAXK>
__device__ __forceinline__ void topk_init(float (&bd)[MAXK], int (&bi)[MAXK],
                                          int k) {
#pragma unroll
  for (int s = 0; s < MAXK; ++s) {
    bd[s] = (s < MAXK - k) ? -CUDART_INF_F : CUDART_INF_F;
    bi[s] = -1;
  }
}

// The k live slots of the list; entries not below `limit` (and slots
// never filled) become the 1e30 / -1 fill.
template <int MAXK>
__device__ __forceinline__ void topk_store(const float (&bd)[MAXK],
                                           const int (&bi)[MAXK], int k,
                                           float limit, float* out_d,
                                           int* out_i) {
#pragma unroll
  for (int s = 0; s < MAXK; ++s) {
    if (s >= MAXK - k) {
      const bool good = bd[s] < limit;
      out_d[s - (MAXK - k)] = good ? bd[s] : 1e30f;
      out_i[s - (MAXK - k)] = good ? bi[s] : -1;
    }
  }
}

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

template <int MAXK>
__global__ void topk_smallest_kernel(const float* __restrict__ d,
                                     const int* __restrict__ idx, int Q,
                                     int W, int k, float* __restrict__ out_d,
                                     int* __restrict__ out_i) {
  // +1 column of padding: thread t reads row t, so rows must fall in
  // different banks
  __shared__ float sd[TOPK_ROWS][TOPK_COLS + 1];
  __shared__ int si[TOPK_ROWS][TOPK_COLS + 1];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * TOPK_ROWS;
  const int nrows = min(TOPK_ROWS, Q - r0);
  float bd[MAXK];
  int bi[MAXK];
  topk_init<MAXK>(bd, bi, k);
  for (int base = 0; base < W; base += TOPK_COLS) {
    const int len = min(TOPK_COLS, W - base);
    __syncthreads();
    if (t < len) {
      for (int r = 0; r < nrows; ++r) {
        const size_t g = (size_t)(r0 + r) * W + base + t;
        sd[r][t] = d[g];
        si[r][t] = idx[g];
      }
    }
    __syncthreads();
    if (t >= nrows) continue;
    for (int j = 0; j < len; ++j) {
      const float v = sd[t][j];
      if (v < bd[MAXK - 1]) topk_insert<MAXK>(bd, bi, v, si[t][j]);
    }
  }
  if (t >= nrows) return;
  topk_store<MAXK>(bd, bi, k, 0.98e30f, out_d + (size_t)(r0 + t) * k,
                   out_i + (size_t)(r0 + t) * k);
}

template <int MAXK>
static void launch_topk(const float* d, const int* idx, int Q, int W, int k,
                        float* out_d, int* out_i, cudaStream_t st) {
  const int blocks = (Q + TOPK_ROWS - 1) / TOPK_ROWS;
  topk_smallest_kernel<MAXK><<<blocks, TOPK_ROWS, 0, st>>>(d, idx, Q, W, k,
                                                          out_d, out_i);
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
  if (k <= 8)
    launch_topk<8>(d, idx, Q, W, k, out_d, out_i, st);
  else if (k <= 16)
    launch_topk<16>(d, idx, Q, W, k, out_d, out_i, st);
  else
    launch_topk<32>(d, idx, Q, W, k, out_d, out_i, st);
  return (int)cudaGetLastError();
}
