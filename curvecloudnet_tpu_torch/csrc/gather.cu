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
// bfloat16; replaces _collapse and the unique-row scatter of _gather_bwd
// on bfloat16 cotangents): d_src[b, j] = bf16_rn(sum of f32(d_out[b, s])
// over the slots s with idx = j), the sums f32 and each result rounded
// once, as the JAX package's f32 sums cast to the source dtype.  Bound on
// the H100: bytes (R * C bfloat16 cotangents and the R indices read once,
// B * N * C bfloat16 written once).  The design sums each source row's
// slots in a fixed order over an inverse table, so nothing accumulates in
// device memory: no f32 scratch, no memset of it, no float atomics and no
// rounding pass, and two runs give the same bits.  The table is a
// counting sort of the slots by source row, built per call: a count of
// each row's slots, one block's exclusive scan of the counts into each
// row's segment, and a placement of every slot into its row's segment.
// The placement takes a cursor with an integer atomic, so a segment's
// slots land in any order; the sum kernel orders them ascending before it
// sums (a warp's bitonic sort for up to 32 slots; past that, each slot's
// rank counted over the segment into a second table), so the summation
// order is ascending slot order whatever the placement's: the order of
// the plain version (scatter_add_ in slot order), which it equals bit for
// bit.  The sum kernel gives a source row to a group of lanes (16-byte
// loads, 8 bfloat16 a lane, when C % 8 == 0 and the rows are 16-byte
// aligned; else 2-byte loads), several groups to a warp: a warp reads as
// many slot rows at once, each group adds its row's slots into f32
// registers one after another (four loads in flight) and writes its
// bfloat16 row once; a row wider than 32 lanes' loads (C > 256) is split
// into column passes on warps of their own.  The scan reads and writes
// the counts in 16-byte words, 32k counts a batch in registers.  f32
// atomic adds into a zeroed scratch and a rounding pass, even as vector
// reductions (red.global.add.v4.f32 from 16-byte loads), measured slower
// on the card (PERF.md, Findings): a row named ~K times takes ~K
// read-modify-writes at L2.

// Bound on the H100 of K4 and K4b: bytes (K4 reads and writes R * C
// floats, or R * C bfloat16 values; K4b reads them and adds into
// B * N * C).

#include <cuda_bf16.h>
#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

// two floats rounded to bfloat16 (to nearest even) in one word, lo first
__device__ __forceinline__ uint32_t pack_bf16_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

// ---- K4b's bfloat16 variant: a fixed-order sum over an inverse table ----

#define SK_SCAN_THREADS 1024
#define SK_TILE (4 * SK_SCAN_THREADS)  // counts a tile: four a thread
#define SK_TILES 8                     // tiles a thread holds in registers

// four counts from i (16-byte aligned), 0 past M
__device__ __forceinline__ int4 sk_load4(const int* cnt, int i, int M) {
  if (i + 3 < M) return *reinterpret_cast<const int4*>(cnt + i);
  int4 v;
  v.x = i < M ? cnt[i] : 0;
  v.y = i + 1 < M ? cnt[i + 1] : 0;
  v.z = i + 2 < M ? cnt[i + 2] : 0;
  v.w = 0;
  return v;
}

__device__ __forceinline__ void sk_store4(int* p, int i, int M, int4 v) {
  if (i + 3 < M) {
    *reinterpret_cast<int4*>(p + i) = v;
    return;
  }
  if (i < M) p[i] = v.x;
  if (i + 1 < M) p[i + 1] = v.y;
  if (i + 2 < M) p[i + 2] = v.z;
}

// One block: off = the exclusive scan of cnt (M counts, off[M] the
// total), and cnt overwritten with off (the placement's cursors); cnt and
// off 16-byte aligned.  Tiles of SK_TILE counts, SK_TILES of them loaded
// at once (coalesced 16-byte loads), each scanned by the block (a
// thread's four, warp shuffles, the warps' sums) and stored whole.
__device__ void sk_scan(int* __restrict__ cnt, int* __restrict__ off, int M) {
  __shared__ int part[SK_SCAN_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int carry = 0;
  for (int t0 = 0; t0 < M; t0 += SK_TILE * SK_TILES) {
    int4 v[SK_TILES];
#pragma unroll
    for (int k = 0; k < SK_TILES; ++k)
      v[k] = sk_load4(cnt, t0 + k * SK_TILE + 4 * threadIdx.x, M);
#pragma unroll
    for (int k = 0; k < SK_TILES; ++k) {
      if (t0 + k * SK_TILE >= M) break;
      const int i = t0 + k * SK_TILE + 4 * threadIdx.x;
      const int4 c = v[k];
      const int s = c.x + c.y + c.z + c.w;
      int x = s;  // the warp's inclusive scan of the threads' sums
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) part[warp] = x;
      __syncthreads();
      if (warp == 0) {
        int q = part[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, q, o);
          if (lane >= o) q += y;
        }
        part[lane] = q;
      }
      __syncthreads();
      int4 e;
      e.x = carry + x - s + (warp ? part[warp - 1] : 0);
      e.y = e.x + c.x;
      e.z = e.y + c.y;
      e.w = e.z + c.z;
      sk_store4(off, i, M, e);
      sk_store4(cnt, i, M, e);
      carry += part[SK_SCAN_THREADS / 32 - 1];
      __syncthreads();  // part is the next tile's
    }
  }
  if (threadIdx.x == 0) off[M] = carry;
}

// each row's count of slots (cnt zeroed by the caller; -1 slots skipped
// with fill, else row 0), a thread a slot
__global__ void scatter_km_bf16_count(const int* __restrict__ idx,
                                      int* __restrict__ cnt, int N,
                                      long long R, int fill) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (s >= R) return;
  const int j = __ldg(idx + (size_t)b * R + s);
  if (!(fill && j < 0)) atomicAdd(cnt + (size_t)b * N + max(j, 0), 1);
}

// the counts' exclusive scan (sk_scan) in one block
__global__ void __launch_bounds__(SK_SCAN_THREADS)
    scatter_km_bf16_scan(int* __restrict__ cnt, int* __restrict__ off,
                         int M) {
  sk_scan(cnt, off, M);
}

// every counted slot b R + s into its row's segment, at a cursor taken
// with an atomic (any order within the segment)
__global__ void scatter_km_bf16_place(const int* __restrict__ idx,
                                      int* __restrict__ cur,
                                      int* __restrict__ list, int N,
                                      long long R, int fill) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (s >= R) return;
  const int j = __ldg(idx + (size_t)b * R + s);
  if (fill && j < 0) return;
  const int p = atomicAdd(cur + (size_t)b * N + max(j, 0), 1);
  list[p] = (int)((long long)b * R + s);
}

// v over the warp's lanes sorted ascending (bitonic)
__device__ __forceinline__ int sk_sort32(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(0xffffffffu, v, j);
      const bool up = (lane & k) == 0, lower = (lane & j) == 0;
      v = lower == up ? min(v, o) : max(v, o);
    }
  return v;
}

// a segment of m > 32 distinct slots into dst ascending: each slot's rank
// counted over the segment (32 of its slots a round, by shuffles)
__device__ void sk_rank_sort(const int* __restrict__ seg,
                             int* __restrict__ dst, int m) {
  const int lane = threadIdx.x & 31;
  for (int e0 = 0; e0 < m; e0 += 32) {
    const int e = e0 + lane < m ? seg[e0 + lane] : INT_MAX;
    int r = 0;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int x = j0 + lane < m ? seg[j0 + lane] : INT_MAX;
#pragma unroll
      for (int k = 0; k < 32; ++k) r += __shfl_sync(0xffffffffu, x, k) < e;
    }
    if (e0 + lane < m) dst[r] = e;
  }
}

#define SK_WARPS 8    // warps a block of the sum kernel
#define SK_GROUPS 8   // most source rows a warp (lane groups of 4 or more)
#define SK_UNROLL 4   // slot rows a group has in flight

// U bfloat16 values at p (16-byte aligned for U = 8) as f32
template <int U>
__device__ __forceinline__ void sk_load(float (&v)[U],
                                        const unsigned short* p) {
  if constexpr (U == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    v[0] = __uint_as_float((uint32_t)__ldg(p) << 16);
  }
}

// The sum.  A warp takes 32 / lr consecutive source rows (lr lanes, U
// columns a lane, lr U columns a pass), or where a row is wider than one
// pass of 32 lanes, one (row, pass).  It orders each of its rows' segments
// of the table ascending (sk_sort32 into shared memory up to 32 slots,
// sk_rank_sort into `sorted` past that: each pass of a row writes the same
// ranks there), then lane group g adds row g's slot rows in that order
// into f32 registers and writes its columns, rounded to bfloat16 to
// nearest even.
template <int U>
__global__ void __launch_bounds__(SK_WARPS * 32)
    scatter_km_bf16_sum(const unsigned short* __restrict__ d_out,
                        const int* __restrict__ off,
                        const int* __restrict__ list,
                        int* __restrict__ sorted,
                        unsigned short* __restrict__ d_src, int rows, int C,
                        int lr, int passes) {
  __shared__ int ids_sm[SK_WARPS][SK_GROUPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = 32 / lr, w = blockIdx.x * SK_WARPS + warp;
  const int row0 = passes == 1 ? w * groups : w / passes;
  const int c_lo = passes == 1 ? 0 : (w - row0 * passes) * lr * U;
  const int c_hi = passes == 1 ? C : min(C, c_lo + lr * U);
  if (row0 >= rows) return;
  int(*ids)[32] = ids_sm[warp];
  for (int g = 0; g < groups && row0 + g < rows; ++g) {
    const int lo = off[row0 + g], m = off[row0 + g + 1] - lo;
    if (m <= 32)
      ids[g][lane] = sk_sort32(lane < m ? list[lo + lane] : INT_MAX);
    else
      sk_rank_sort(list + lo, sorted + lo, m);
  }
  __syncwarp();
  const int g = lane / lr, row = row0 + g;
  if (row >= rows) return;
  const int lo = off[row], m = off[row + 1] - lo;
  const int* order = m <= 32 ? ids[g] : sorted + lo;
  for (int c = c_lo + (lane - g * lr) * U; c < c_hi; c += lr * U) {
    float acc[U];
#pragma unroll
    for (int e = 0; e < U; ++e) acc[e] = 0.f;
    int p = 0;
    for (; p + SK_UNROLL <= m; p += SK_UNROLL) {
      float v[SK_UNROLL][U];
#pragma unroll
      for (int u = 0; u < SK_UNROLL; ++u)
        sk_load<U>(v[u], d_out + (size_t)order[p + u] * C + c);
#pragma unroll
      for (int u = 0; u < SK_UNROLL; ++u)
#pragma unroll
        for (int e = 0; e < U; ++e) acc[e] += v[u][e];
    }
    for (; p < m; ++p) {
      float v[U];
      sk_load<U>(v, d_out + (size_t)order[p] * C + c);
#pragma unroll
      for (int e = 0; e < U; ++e) acc[e] += v[e];
    }
    unsigned short* o = d_src + (size_t)row * C + c;
    if constexpr (U == 8) {
      uint4 q;
      q.x = pack_bf16_rn(acc[0], acc[1]);
      q.y = pack_bf16_rn(acc[2], acc[3]);
      q.z = pack_bf16_rn(acc[4], acc[5]);
      q.w = pack_bf16_rn(acc[6], acc[7]);
      *reinterpret_cast<uint4*>(o) = q;
    } else {
      *o = __bfloat16_as_ushort(__float2bfloat16_rn(acc[0]));
    }
  }
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

// d_out (B, R, C) bfloat16 -> d_src (B, N, C) bfloat16.  tab: a 16-byte
// aligned int32 scratch (ops/gather.py table_words): the counts (the
// cursors after the scan) padded to 4 words, the B N + 1 segment offsets,
// the placed slots and the ordered copy of the segments past 32 slots.
// Five launches: the counts' memset, count, scan, place, sum.
extern "C" int ccn_scatter_km_bf16(const unsigned short* d_out,
                                   const int* idx, int* tab,
                                   unsigned short* d_src, int B, int N,
                                   long long R, int C, int fill,
                                   void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * N, S = (long long)B * R;
  if (M + 1 > INT_MAX || S > INT_MAX || (R + 255) / 256 > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* cnt = tab;
  int* off = cnt + ((M + 3) & ~3LL);  // 16-byte aligned
  int* list = off + M + 1;
  int* sorted = list + S;
  cudaError_t e = cudaMemsetAsync(cnt, 0, (size_t)M * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const dim3 sgrid((unsigned)((R + 255) / 256), (unsigned)B);
  scatter_km_bf16_count<<<sgrid, 256, 0, st>>>(idx, cnt, N, R, fill);
  scatter_km_bf16_scan<<<1, SK_SCAN_THREADS, 0, st>>>(cnt, off, (int)M);
  scatter_km_bf16_place<<<sgrid, 256, 0, st>>>(idx, cnt, list, N, R, fill);
  const bool vec = C % 8 == 0 && (size_t)d_out % 16 == 0 &&
                   (size_t)d_src % 16 == 0;
  const int units = vec ? C / 8 : C;
  const int lr = units <= 4 ? 4 : units <= 8 ? 8 : units <= 16 ? 16 : 32;
  const int passes = (units + lr - 1) / lr;  // > 1 only at lr 32
  const long long warps =
      passes > 1 ? M * passes : (M + 32 / lr - 1) / (32 / lr);
  const unsigned blocks = (unsigned)((warps + SK_WARPS - 1) / SK_WARPS);
  if (vec)
    scatter_km_bf16_sum<8><<<blocks, SK_WARPS * 32, 0, st>>>(
        d_out, off, list, sorted, d_src, (int)M, C, lr, passes);
  else
    scatter_km_bf16_sum<1><<<blocks, SK_WARPS * 32, 0, st>>>(
        d_out, off, list, sorted, d_src, (int)M, C, lr, passes);
  return (int)cudaGetLastError();
}
