// K6: farthest point sampling, the serial pick loop, one CTA a batch row.
//
// Replaces curvecloudnet_tpu/ops/pallas_fps.py _fps_pallas_batched (the
// Pallas kernel _fps_kernel).  For each batch row, `budget` picks: pick i
// is `last`; every point's running min squared distance to the picks is
// updated with its distance to `last`, and the next `last` is the argmax of
// that field over valid points (invalid points hold -1e30 and are never
// chosen while a valid point is left), ties to the lowest index as
// jnp.argmax.  The output is the pick order; the ascending sort and slot
// validity stay in PyTorch.
//
// Bound on the H100: the serial chain of picks.  A call's operations and
// bytes are microseconds of work (9 FLOP a valid point a round), but pick
// i+1 cannot start before every point has seen pick i, so the time is
// rounds x (one sweep of the points + one argmax over every thread that
// holds some + the barrier between).  The floor a design reaches is the
// rounds x the cost of one round on a tiny row (the fixed cost
// chip_smoke.py measures on a 1024-point row).
//
// Design.  Only valid points can be picked while one is left (invalid
// points hold -1e30 for good), so the CTA first ranks the row's V valid
// points in index order (a block scan of the mask) and keeps their
// positions, compacted, in shared memory (12 B a point); the picks are
// ranks until a last pass maps them to indices.  Each thread holds the
// field of points tid, tid + T, ... in registers, and the positions of
// its first 32 of them too (24 in the build for rows past 32 T points),
// so a row of up to 24 T valid points (6144 at the default 256 threads:
// every main-path row) sweeps registers only; points past those are read
// from shared memory, as the parent design read every point.  A pick sweeps a thread's points, each warp's argmax
// (two redux.sync) goes into its 64-bit slot as (key, ~rank), one
// __syncthreads, and every thread takes the largest slot (the largest
// field at the lowest rank, i.e. the lowest index) and the winner's
// coordinates; the slots alternate by pick parity, so one barrier a pick
// is enough.  (A shared 64-bit atomicMax in their place cost ~0.5 us a
// round; a cluster of CTAs, ~1.0-1.3 us a round whatever its size, lost to
// one CTA at every main-path row.)  Once the largest field is 0 every
// valid point is picked and every later pick is the same point: the rest
// of the budget is written without a round.  Distances use round-to-
// nearest intrinsics in the order (dx*dx + dy*dy) + dz*dz, with no FMA
// contraction, and the field is updated with fminf, so picks equal the
// plain PyTorch version's bit for bit.
//
// Rows past ~19300 points (the A2D2 model's 23040-point fps row) do not
// fit shared memory at 12 B a point.  The build of 48 points a thread
// (BIG, 512 threads: 128 registers a thread, so the field and the
// positions of a thread's first 12 points fit them without spilling; 96
// points on 256 threads spilled and took 9.4 us a pick) keeps in shared
// memory only the points past a thread's first 12, staged in two passes,
// and takes the winner's coordinates from a per-warp slot that the warp's
// winning lane fills beside its (key, ~rank) slot, instead of reading
// them by rank.

#include <cuda_runtime.h>

#define NO_INDEX 0xffffffffu
// points a thread whose positions sit in registers where P > 32 (the
// field of all P takes registers too: 32 would spill at P = 76)
#define REG_POINTS 24
// the same for the 48-point build on 512 threads (BIG)
#define BIG_REG_POINTS 12
#define BIG_P 48

// the most threads a CTA of the build for P points takes
__host__ __device__ constexpr int max_threads(int P) {
  return P == BIG_P ? 512 : (P > 16 ? 256 : (P > 8 ? 512 : 1024));
}

// A field value as an unsigned key that orders like the value for the
// argmax: every negative value (-1e30 of an invalid point, -inf of a slot
// past the row's end) is 0, a value v >= 0 its bits + 1 (bits of
// non-negative floats order as the floats do).  Ties are broken by index.
__device__ __forceinline__ unsigned field_key(float v) {
  return v >= 0.f ? __float_as_uint(v) + 1u : 0u;
}

// (key, index) of the largest key, lowest index, over the warp; every lane
// gets it (two redux.sync)
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& idx) {
  const unsigned m = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == m ? idx : NO_INDEX);
  key = m;
}

// Shared memory through 32-bit window addresses held in registers: with
// plain pointers the compiler recomputes the window's base (an S2UR of the
// CTA id) at each use in the pick loop, ~0.09 us a round.
__device__ __forceinline__ unsigned smem_at(const void* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("" : "+r"(a));
  return a;
}

__device__ __forceinline__ float lds_f32(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ ulonglong2 lds_u64x2(unsigned a) {
  ulonglong2 v;
  asm volatile("ld.shared.v2.u64 {%0, %1}, [%2];"
               : "=l"(v.x), "=l"(v.y) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void sts_u64(unsigned a, unsigned long long v) {
  asm volatile("st.shared.u64 [%0], %1;" :: "r"(a), "l"(v) : "memory");
}

// 16 points a thread take ~90 registers (at most 512 threads), more up to
// ~190 (at most 256)
template <int P, bool BIG>
__global__ void __launch_bounds__(max_threads(P))
    fps_kernel(const float* __restrict__ pos,
               const unsigned char* __restrict__ valid,
               const int* __restrict__ start, int* __restrict__ out, int N,
               int budget) {
  constexpr int PR = BIG ? BIG_REG_POINTS : (P <= 32 ? P : REG_POINTS);
  const int T = blockDim.x, NW = T >> 5;
  // BIG: ranks from R0 on sit in shared memory (at index rank - R0)
  const int R0 = BIG ? PR * T : 0;
  const int NS = BIG ? max(R0, N - R0) : N;
  extern __shared__ uint4 smem[];
  // [2][32] per-warp slots, BIG: [2][32] winner coordinates, then x, y and
  // z of NS points
  unsigned long long* S = reinterpret_cast<unsigned long long*>(smem);
  float4* SC = reinterpret_cast<float4*>(smem + 32);
  float* sx = reinterpret_cast<float*>(smem + 32 + (BIG ? 64 : 0));
  float* sy = sx + NS;
  float* sz = sy + NS;
  __shared__ unsigned warp_cnt[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pb = pos + (size_t)b * N * 3;
  const unsigned char* vb = valid + (size_t)b * N;
  int* ob = out + (size_t)b * budget;

  // ranks of the valid points in index order
  const int chunk = (N + T - 1) / T;
  const int j0 = min(N, tid * chunk), j1 = min(N, j0 + chunk);
  unsigned cnt = 0;
  for (int j = j0; j < j1; ++j) cnt += vb[j] != 0;
  unsigned incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_cnt[warp] = incl;
  __syncthreads();
  unsigned before = 0, V = 0;
  for (int w = 0; w < NW; ++w) {
    const unsigned c = warp_cnt[w];
    before += w < warp ? c : 0u;
    V += c;
  }
  before += incl - cnt;

  if (V == 0) {   // no valid point: start, then index 0 (argmax of an all
                  // -1e30 field)
    for (int i = tid; i < budget; i += T) ob[i] = i == 0 ? start[b] : 0;
    return;
  }
  // the valid points' positions by rank (BIG: those below R0 first, to
  // load the registers from; those from R0 on after)
  for (int j = j0, r = (int)before; j < j1; ++j) {
    if (!vb[j]) continue;
    if (!BIG || r < R0) {
      sx[r] = pb[3 * j];
      sy[r] = pb[3 * j + 1];
      sz[r] = pb[3 * j + 2];
    }
    ++r;
  }
  // every slot, those of warps past NW too (a pair is read at a time)
  for (int s = tid; s < 64; s += T) S[s] = 0ull;
  __syncthreads();

  // the field of points tid + p T in registers, and the positions of the
  // first PR; slots past V hold -inf (never chosen)
  const int pu = ((int)V + T - 1) / T;
  float x[PR], y[PR], z[PR], f[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int l = tid + p * T;
    const bool real = l < (int)V;
    if (p < PR) {
      x[p < PR ? p : 0] = real ? sx[l] : 0.f;
      y[p < PR ? p : 0] = real ? sy[l] : 0.f;
      z[p < PR ? p : 0] = real ? sz[l] : 0.f;
    }
    f[p] = real ? 1e30f : -__int_as_float(0x7f800000);
  }
  if (BIG) {
    __syncthreads();
    for (int j = j0, r = (int)before; j < j1; ++j) {
      if (!vb[j]) continue;
      if (r >= R0) {
        sx[r - R0] = pb[3 * j];
        sy[r - R0] = pb[3 * j + 1];
        sz[r - R0] = pb[3 * j + 2];
      }
      ++r;
    }
    __syncthreads();
  }
  int last = start[b];    // an index; every later pick a rank
  float lx = pb[3 * last], ly = pb[3 * last + 1], lz = pb[3 * last + 2];
  const unsigned a_slots = smem_at(S), a_x = smem_at(sx), a_y = smem_at(sy),
                 a_z = smem_at(sz);
  asm volatile("" : "+l"(ob));   // in registers too, not rebuilt each pick

  for (int i = 0;; ++i) {
    if (tid == 0) ob[i] = last;
    if (i + 1 == budget) break;
    // the sweep; p ascends with the rank, so strict > keeps the lowest.
    // A break, not a guard, past the points in use: a guarded slot is
    // issued predicated off, which costs a large P as much as a full sweep
    float bv = -__int_as_float(0x7f800000);
    int bp = -1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p >= pu) break;
      // (a thread past the last point reads the last: its field is -inf)
      const int l = min(tid + p * T, (int)V - 1) - R0;
      const float px = p < PR ? x[p < PR ? p : 0] : sx[l];
      const float py = p < PR ? y[p < PR ? p : 0] : sy[l];
      const float pz = p < PR ? z[p < PR ? p : 0] : sz[l];
      const float dx = __fsub_rn(px, lx);
      const float dy = __fsub_rn(py, ly);
      const float dz = __fsub_rn(pz, lz);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      f[p] = fminf(f[p], d2);
      if (f[p] > bv) {
        bv = f[p];
        bp = p;
      }
    }
    unsigned key = field_key(bv);
    const unsigned own = bp >= 0 ? (unsigned)(tid + bp * T) : NO_INDEX;
    unsigned g = own;
    // the warp's (key, ~rank) into its slot: the largest of the slots is
    // the largest key at the lowest rank (the lowest index)
    warp_argmax(key, g);
    const unsigned slots = a_slots + (i & 1) * 256;
    if (lane == 0)
      sts_u64(slots + 8 * warp, ((unsigned long long)key << 32) | ~g);
    if (BIG && own == g && g != NO_INDEX) {
      // the warp's winning lane: its point's coordinates into the warp's
      // slot of this parity
      float wx = 0.f, wy = 0.f, wz = 0.f;
      if (bp < PR) {
#pragma unroll
        for (int p = 0; p < PR; ++p)
          if (p == bp) {
            wx = x[p];
            wy = y[p];
            wz = z[p];
          }
      } else {
        wx = sx[g - R0];
        wy = sy[g - R0];
        wz = sz[g - R0];
      }
      SC[(i & 1) * 32 + warp] = make_float4(wx, wy, wz, 0.f);
    }
    __syncthreads();
    unsigned long long w = 0ull;
    for (int s = 0; s < NW; s += 2) {
      const ulonglong2 v = lds_u64x2(slots + 8 * s);
      w = max(w, max(v.x, v.y));
    }
    const unsigned wg = ~(unsigned)w, wk = (unsigned)(w >> 32);
    if (BIG) {
      const float4 c = SC[(i & 1) * 32 + ((wg % T) >> 5)];
      lx = c.x;
      ly = c.y;
      lz = c.z;
    } else {
      lx = lds_f32(a_x + 4 * wg);
      ly = lds_f32(a_y + 4 * wg);
      lz = lds_f32(a_z + 4 * wg);
    }
    last = (int)wg;
    // the largest field is 0: every valid point is picked, the field no
    // longer changes, and every later pick is `last`
    if (wk <= 1u) {
      for (int r = i + 1 + tid; r < budget; r += T) ob[r] = last;
      break;
    }
  }

  // picks 1.. are ranks: map them to indices through a table in sx
  __syncthreads();
  int* index = reinterpret_cast<int*>(sx);
  for (int j = j0, r = (int)before; j < j1; ++j)
    if (vb[j]) index[r++] = j;
  __syncthreads();
  for (int i = 1 + tid; i < budget; i += T) ob[i] = index[__ldcg(ob + i)];
}

template <int P, bool BIG = false>
static int launch(const float* pos, const unsigned char* valid,
                  const int* start, int* out, int B, int N, int budget, int T,
                  cudaStream_t st) {
  // slots, then x, y and z of N points; BIG: slots, the winner
  // coordinates, then x, y and z of the points from rank 12 T on (or of
  // the first 12 T while they are staged), at least the N-entry index table
  const int r0 = BIG_REG_POINTS * T;
  const size_t smem =
      BIG ? 96 * sizeof(uint4) +
                max((size_t)max(r0, N - r0) * 12, (size_t)N * 4)
          : 32 * sizeof(uint4) + (size_t)N * 12;
  cudaError_t e = cudaFuncSetAttribute(
      fps_kernel<P, BIG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fps_kernel<P, BIG><<<B, T, smem, st>>>(pos, valid, start, out, N, budget);
  return (int)cudaGetLastError();
}

// pos (B, N, 3) f32; valid (B, N) bool; start (B,) int32; out (B, budget)
// int32 pick order.  A row runs on one CTA of T threads (a multiple of 32;
// at most 1024, 512 for P > 8, 256 for P > 16, 512 for P = 48), P points a
// thread (1, 2, 4, 8, 12, 16, 24, 32, 76 or 48) with P * T >= N, 12 B of
// shared memory a point beside 512 B of slots (P = 48: 12 B a point past
// the first 12 T, beside 1.5 KB of slots).
extern "C" int ccn_fps(const float* pos, const unsigned char* valid,
                       const int* start, int* out, int B, int N, int budget,
                       int T, int P, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || budget < 1 || B < 1 || T < 32 ||
      T > max_threads(P) || T % 32 ||
      (long long)P * T < N)
    return (int)cudaErrorInvalidValue;
  switch (P) {
    case 1: return launch<1>(pos, valid, start, out, B, N, budget, T, st);
    case 2: return launch<2>(pos, valid, start, out, B, N, budget, T, st);
    case 4: return launch<4>(pos, valid, start, out, B, N, budget, T, st);
    case 8: return launch<8>(pos, valid, start, out, B, N, budget, T, st);
    case 12: return launch<12>(pos, valid, start, out, B, N, budget, T, st);
    case 16: return launch<16>(pos, valid, start, out, B, N, budget, T, st);
    case 24: return launch<24>(pos, valid, start, out, B, N, budget, T, st);
    case 32: return launch<32>(pos, valid, start, out, B, N, budget, T, st);
    case 76: return launch<76>(pos, valid, start, out, B, N, budget, T, st);
    case BIG_P:
      return launch<BIG_P, true>(pos, valid, start, out, B, N, budget, T,
                                 st);
    default: return (int)cudaErrorInvalidValue;
  }
}
