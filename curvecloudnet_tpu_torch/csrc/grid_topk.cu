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
// Bound on the H100: the live candidates (a few hundred a query) are read
// from a table of 30-50 MB that mostly stays in L2, so the bytes each
// input must move are far below what the candidate loop takes; the loop is
// latency-bound (dependent loads, per-thread top-k upkeep).  Design: one
// thread per query, K3's fully unrolled register top-k (the first MAXK-k
// slots hold -inf so the list has exactly k live slots) behind a
// k-th-distance reject; records come as one 16-byte load each.
// Consecutive queries are in curve order, hence spatial neighbours that
// read mostly the same rows, so the warp's loads hit L1/L2.
//
// K10 replaces curvecloudnet_tpu/ops/pallas_topk.py topk_smallest (the
// Pallas kernel _topk_kernel): per row of d (Q, W), the k smallest
// entries with their idx, ascending, ties to the lower column; entries
// not below 0.98e30 come out as 1e30 / -1.  Values are exact (the Pallas
// kernel quantizes them).  Bound: the bytes of d and idx, each read once.
// Design: a block of TOPK_ROWS threads owns TOPK_ROWS rows; it stages
// TOPK_COLS-column tiles of d and idx in shared memory with coalesced
// loads (one thread a column), then each thread scans its own row of the
// tile into a register top-k as K5 does.

#include <cuda_runtime.h>
#include <math_constants.h>

#define GRID_THREADS 64
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

template <int MAXK>
__global__ void grid_topk_kernel(const float4* __restrict__ table,
                                 const int* __restrict__ counts,
                                 const int* __restrict__ nbr,
                                 const float* __restrict__ query,
                                 const unsigned char* __restrict__ q_valid,
                                 int Q, int S, int cap, int k, float r2,
                                 float* __restrict__ out_d2,
                                 int* __restrict__ out_idx) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Q) return;
  float bd[MAXK];
  int bi[MAXK];
  topk_init<MAXK>(bd, bi, k);
  if (q_valid[qi]) {
    const float qx = query[3 * (size_t)qi];
    const float qy = query[3 * (size_t)qi + 1];
    const float qz = query[3 * (size_t)qi + 2];
    const int* rows = nbr + (size_t)qi * S;
    for (int c = 0; c < S; ++c) {
      const int row = rows[c];
      const int live = counts[row];
      const float4* rec = table + (size_t)row * cap;
      for (int j = 0; j < live; ++j) {
        const float4 p = rec[j];
        const int pid = __float_as_int(p.w);
        const float dx = __fsub_rn(qx, p.x);
        const float dy = __fsub_rn(qy, p.y);
        const float dz = __fsub_rn(qz, p.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (pid >= 0 && d2 <= r2 && d2 < bd[MAXK - 1])
          topk_insert<MAXK>(bd, bi, d2, pid);
      }
    }
  }
  topk_store<MAXK>(bd, bi, k, CUDART_INF_F, out_d2 + (size_t)qi * k,
                   out_idx + (size_t)qi * k);
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
static void launch_grid(const float* table, const int* counts, const int* nbr,
                        const float* query, const unsigned char* qv, int Q,
                        int S, int cap, int k, float r2, float* d2, int* idx,
                        cudaStream_t st) {
  const int blocks = (Q + GRID_THREADS - 1) / GRID_THREADS;
  grid_topk_kernel<MAXK><<<blocks, GRID_THREADS, 0, st>>>(
      (const float4*)table, counts, nbr, query, qv, Q, S, cap, k, r2, d2, idx);
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
  if (k <= 8)
    launch_grid<8>(table, counts, nbr, query, q_valid, Q, S, cap, k, r2, d2,
                   idx, st);
  else if (k <= 16)
    launch_grid<16>(table, counts, nbr, query, q_valid, Q, S, cap, k, r2, d2,
                    idx, st);
  else
    launch_grid<32>(table, counts, nbr, query, q_valid, Q, S, cap, k, r2, d2,
                    idx, st);
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
