// The live-row tensor-core chain of K2 (group_reduce.cu) and K9
// (edge_mlp.cu): a block compacts its queries' live (query, slot) rows,
// runs them in chunks of R rows through the dense layers (3xTF32 mma.sync)
// and aggregates each query's rows (masked max, or softmax-attend), the
// state carried across a query's chunks.  The kernel does not know where
// a row comes from: a source (Src) says which slots are live and builds
// the chunk's rows of the first dense's input.  K2's source reads the
// layer-0 pre-norm planes h1 and applies the layer-0 BN affine and the
// activation; K9's adds the projected rows U[j] + V[i].  The design is
// described in group_reduce.cu.
//
// A source provides
//   bool live(int b, int m, int k)       slot k of query m of batch row b;
//   bool same_planes(int b, int m, int K, int lane)
//                                        (attend only) whether the K rows
//                                        of a query with no live slot are
//                                        equal (a warp's vote);
//   void load(float* dst, int ld, const unsigned short* list, int r0,
//             int nrow, int rows, int b, int m0, int ms)
//                                        rows 0 .. rows - 1 of a chunk
//                                        (list entries r0 .., zero past
//                                        nrow), columns 0 .. dims[0] - 1;
// the kernel zeroes the columns from dims[0] up to a multiple of 8.
#pragma once

#include "tf32_mma.cuh"

#define GR_MAX_LAYERS 8
#define GR_THREADS 256
#define GR_WARPS (GR_THREADS / 32)
// a row-list entry: query << 7 | plane, so K <= 128 (the ball queries of
// the version-1.0 sa steps) and at most 511 queries a block
#define GR_QBITS 7

struct GroupMeta {
  int n_local, n_attend;
  int dims[2 * GR_MAX_LAYERS + 1];
  long long woff[2 * GR_MAX_LAYERS];  // in floats
  long long boff[2 * GR_MAX_LAYERS];
};

// out (R, cout) = act(in (R, cin) @ W + b) on the tensor cores in 3xTF32
// (mma.sync m16n8k8, f32 accuracy).  in and out lie in shared memory
// (row strides ldi, ldo = 4 mod 32, so the fragment loads are free of bank
// conflicts) and may be the same buffer:
// the whole output stays in the warps' accumulators until every warp has
// read the whole input.  Warp w owns all R rows of the block's 8-column
// tiles w, w + 8, ...: at most NTW of them (512 / R for the widest layers,
// 128 accumulators a thread; fewer for a narrow chain, whose blocks then
// share an SM).  W streams through shared memory in stages of kc rows (row
// stride ldw elements, 8 mod 32), double-buffered with cp.async: stage 0 is
// already in flight in buffer buf, and the last stage's copy time fetches
// stage 0 of the next layer (next, or none) into the other buffer; buf
// returns where that went.  Columns of out up to cout rounded to 8 are
// written (0 past cout); in must hold 0 from cin up to cin rounded to 8.
template <int R, int NTW>
__device__ void dense_mma(const float* in, int ldi, float* outp, int ldo,
                          const WLayer& L, const float* __restrict__ bias,
                          int act, bool do_act, float* Ws, int ldw, int kc,
                          int& buf, const WLayer* next) {
  constexpr int MT = R / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cin = L.cin, cout = L.cout;
  const int cinr = (cin + 7) & ~7;
  const int ntiles = ((cout + 7) & ~7) >> 3;
  float acc[MT][NTW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int nst = (cinr + kc - 1) / kc;
  for (int s = 0; s < nst; ++s) {
    float* other = Ws + ((buf + s + 1) & 1) * kc * ldw;
    if (s + 1 < nst || next != nullptr) {
      if (s + 1 < nst)
        stage_w(other, ldw, L, (s + 1) * kc, kc);
      else
        stage_w(other, ldw, *next, 0, kc);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ws = Ws + ((buf + s) & 1) * kc * ldw;
    const int kend = min(kc, cinr - s * kc);
    for (int kk = 0; kk < kend; kk += 8) {
      const int k0 = s * kc + kk;
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* a = in + (i * 16 + g) * ldi + k0 + t;
        const float v[4] = {a[0], a[8 * ldi], a[4], a[8 * ldi + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[i][e] = tf32_rna(v[e]);
          alo[i][e] = tf32_rna(v[e] - __uint_as_float(ahi[i][e]));
        }
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int tile = warp + j * GR_WARPS;
        if (tile < ntiles) {
          const float* wb = ws + (kk + t) * ldw + tile * 8 + g;
          const float w0 = wb[0], w1 = wb[4 * ldw];
          const uint32_t bh0 = tf32_rna(w0), bh1 = tf32_rna(w1);
          const uint32_t bl0 = tf32_rna(w0 - __uint_as_float(bh0));
          const uint32_t bl1 = tf32_rna(w1 - __uint_as_float(bh1));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_tf32(acc[i][j], alo[i], bh0, bh1);
            mma_tf32(acc[i][j], ahi[i], bl0, bl1);
            mma_tf32(acc[i][j], ahi[i], bh0, bh1);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int tile = warp + j * GR_WARPS;
    if (tile >= ntiles) continue;
    const int n = tile * 8 + 2 * t;
    const float b0 = n < cout ? bias[n] : 0.f;
    const float b1 = n + 1 < cout ? bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = i * 16 + g;
      float2 lo = make_float2(acc[i][j][0] + b0, acc[i][j][1] + b1);
      float2 hi = make_float2(acc[i][j][2] + b0, acc[i][j][3] + b1);
      if (do_act) {
        lo = make_float2(act_fn(lo.x, act), act_fn(lo.y, act));
        hi = make_float2(act_fn(hi.x, act), act_fn(hi.y, act));
      }
      *reinterpret_cast<float2*>(outp + r * ldo + n) = lo;
      *reinterpret_cast<float2*>(outp + (r + 8) * ldo + n) = hi;
    }
  }
  buf = (buf + nst) & 1;
  __syncthreads();
}

// NTW: output tiles a warp (layers up to 64 NTW wide); MINB: blocks an SM
template <int R, int NTW, int MINB, class Src>
__global__ void __launch_bounds__(GR_THREADS, MINB)
    group_chain_kernel(const Src src, const float* __restrict__ wp,
                       float* __restrict__ out, int K, int M, int tq,
                       int aggr, int act, int attend_act, int ldx, int ldm,
                       int ldw, int kc, GroupMeta g) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int c1 = g.dims[0];
  const int cout = g.dims[g.n_local];
  const int fields = aggr == 1 ? 3 : 1;  // max; or running max, sum, acc
  float* Ws = sm;                        // two stages of kc weight rows
  float* X = Ws + 2 * kc * ldw;          // activations
  float* MSG = X + R * ldx;              // attend: the messages
  float* CARRY = MSG + (aggr == 1 ? R * ldm : 0);  // 2 parities x fields
  int* qcnt = reinterpret_cast<int*>(CARRY + 2 * fields * cout);
  int* qstart = qcnt + tq;               // tq + 1
  int* qflag = qstart + tq + 1;          // 1 some live, 2 some dead
  unsigned short* list = reinterpret_cast<unsigned short*>(qflag + tq);
  // the block's queries are blockIdx.x + q * gridDim.x: strided, so that
  // the budget padding at the end of M (queries with no live slot) spreads
  // over every block
  const int b = blockIdx.y, m0 = blockIdx.x, ms = gridDim.x;
  const int nq = min(tq, (M - m0 + ms - 1) / ms);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;

  // 1. the tile's rows: each query's live slots, or all K slots of a
  //    query with no live slot under attend
  for (int q = tid; q < nq; q += nt) {
    int live = 0;
    for (int k = 0; k < K; ++k) live += src.live(b, m0 + q * ms, k);
    qcnt[q] = live ? live : (aggr == 1 ? K : 0);
    qflag[q] = (live > 0) | ((live < K) << 1);
  }
  __syncthreads();
  // a query with no live slot under attend weighs its K messages
  // uniformly: where its K rows are equal (budget padding), their mean is
  // the message of slot 0 alone
  if (aggr == 1) {
    for (int q = warp; q < nq; q += GR_WARPS) {
      if (qflag[q] & 1) continue;
      if (src.same_planes(b, m0 + q * ms, K, lane) && lane == 0) qcnt[q] = 1;
    }
    __syncthreads();
  }
  if (warp == 0) {
    const int per = (nq + 31) / 32;
    const int qa = min(nq, lane * per), qb = min(nq, qa + per);
    int s = 0;
    for (int q = qa; q < qb; ++q) s += qcnt[q];
    int incl = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - s;
    for (int q = qa; q < qb; ++q) {
      qstart[q] = run;
      run += qcnt[q];
    }
    if (lane == 31) qstart[nq] = incl;
  }
  __syncthreads();
  for (int q = tid; q < nq; q += nt) {
    const bool dead = !(qflag[q] & 1);
    int pos = qstart[q];
    for (int k = 0; k < K; ++k)
      if (dead ? k < qcnt[q] : src.live(b, m0 + q * ms, k))
        list[pos++] = (unsigned short)((q << GR_QBITS) | k);
  }
  // a query with no live slot under max: every slot counts as -100
  if (aggr == 0)
    for (int i = tid; i < nq * cout; i += nt) {
      const int q = i / cout;
      if (qcnt[q] == 0)
        out[((size_t)b * M + m0 + q * ms) * cout + i % cout] = -100.f;
    }
  __syncthreads();

  // 2. the rows in chunks of R
  const int total = qstart[nq];
  const int n_layers = g.n_local + (aggr == 1 ? g.n_attend : 0);
  auto layer = [&](int li) {
    const WLayer L = {wp + g.woff[li], g.dims[li], g.dims[li + 1],
                      g.dims[li + 1],
                      g.dims[li + 1] % 4 == 0 && g.woff[li] % 4 == 0};
    return L;
  };
  int buf = 0;  // the weight stage that holds the next layer's first rows
  if (n_layers > 0 && total > 0) {
    stage_w(Ws, ldw, layer(0), 0, kc);
    cp_async_commit();
  }
  const int c1v = (c1 + 7) & ~7;
  // a one-layer MLP under attend: the loaded rows are the messages
  float* load_dst = (g.n_local == 0 && aggr == 1) ? MSG : X;
  const int ld_load = (g.n_local == 0 && aggr == 1) ? ldm : ldx;
  for (int r0 = 0, ch = 0; r0 < total; r0 += R, ++ch) {
    const int nrow = min(R, total - r0);
    src.load(load_dst, ld_load, list, r0, nrow, R, b, m0, ms);
    for (int i = tid; i < R * (c1v - c1); i += nt) {
      const int j = i / (c1v - c1);
      load_dst[j * ld_load + c1 + i - j * (c1v - c1)] = 0.f;
    }
    __syncthreads();
    // the local layers in place in X, the last one under attend into MSG;
    // the attention layers from MSG into X
    const float* cur = load_dst;
    for (int li = 0; li < n_layers; ++li) {
      const bool local = li < g.n_local;
      const bool last = li == g.n_local - 1 || li == n_layers - 1;
      float* dst = (li == g.n_local - 1 && aggr == 1) ? MSG : X;
      const WLayer nxt = layer(li + 1 < n_layers ? li + 1 : 0);
      const bool more = li + 1 < n_layers || r0 + R < total;
      dense_mma<R, NTW>(cur, cur == MSG ? ldm : ldx, dst,
                        dst == MSG ? ldm : ldx, layer(li), wp + g.boff[li],
                        local ? act : attend_act, !last, Ws, ldw, kc, buf,
                        more ? &nxt : nullptr);
      cur = dst;
    }
    const float* msg = aggr == 1 ? MSG : X;
    const int ld_msg = aggr == 1 ? ldm : ldx;

    // 3. aggregate each query's rows of this chunk; a query that goes on
    //    into the next chunk leaves its state in CARRY[ch & 1]
    const int qa = list[r0] >> GR_QBITS;
    const int qb = list[r0 + nrow - 1] >> GR_QBITS;
    const float* carry_in = CARRY + ((ch + 1) & 1) * fields * cout;
    float* carry_out = CARRY + (ch & 1) * fields * cout;
    for (int i = tid; i < (qb - qa + 1) * cout; i += nt) {
      const int q = qa + i / cout, c = i % cout;
      const int s = qstart[q], e = qstart[q + 1];
      const int j0 = max(s, r0), j1 = min(e, r0 + R);
      if (j0 >= j1) continue;
      const bool from_prev = s < r0, to_next = e > r0 + R;
      const size_t o = ((size_t)b * M + m0 + q * ms) * cout + c;
      if (aggr == 0) {
        float v = from_prev ? carry_in[c]
                            : ((qflag[q] & 2) ? -100.f
                                              : -__int_as_float(0x7f800000));
        for (int j = j0; j < j1; ++j) v = fmaxf(v, msg[(j - r0) * ld_msg + c]);
        if (to_next)
          carry_out[c] = v;
        else
          out[o] = v;
      } else {
        const bool ok = qflag[q] & 1;
        float mx = from_prev ? carry_in[c] : -1e30f;
        float den = from_prev ? carry_in[cout + c] : 0.f;
        float acc = from_prev ? carry_in[2 * cout + c] : 0.f;
        for (int j = j0; j < j1; ++j) {
          const float l = ok ? X[(j - r0) * ldx + c] : -500.f;
          const float nm = fmaxf(mx, l);
          const float sc = expf(mx - nm), w = expf(l - nm);
          den = den * sc + w;
          acc = acc * sc + w * msg[(j - r0) * ld_msg + c];
          mx = nm;
        }
        if (to_next) {
          carry_out[c] = mx;
          carry_out[cout + c] = den;
          carry_out[2 * cout + c] = acc;
        } else {
          out[o] = acc / den;
        }
      }
    }
    __syncthreads();
  }
}

static inline int row_stride(int c) { return ((c + 31) & ~31) + 4; }

// Shared memory of a launch in bytes; ops/group_reduce.py _smem_bytes
// repeats it.
static inline size_t smem_bytes(int rows, int tq, int K, int kc, int ldx,
                                int ldm, int ldw, int cout, int aggr) {
  const size_t floats = (size_t)rows * (ldx + (aggr == 1 ? ldm : 0)) +
                        2 * (aggr == 1 ? 3 : 1) * (size_t)cout;
  return 2 * (size_t)kc * ldw * 4 + floats * 4 +
         (3 * (size_t)tq + 1) * 4 + 2 * (size_t)tq * K;
}

template <int R, int NTW, int MINB, class Src>
static cudaError_t launch_chain(const Src& src, const float* wp, float* out,
                                int B, int K, int M, int tq, int aggr,
                                int act, int attend_act, int ldx, int ldm,
                                int ldw, int kc, const GroupMeta& g,
                                size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      group_chain_kernel<R, NTW, MINB, Src>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + tq - 1) / tq, B);
  group_chain_kernel<R, NTW, MINB, Src><<<grid, GR_THREADS, smem, st>>>(
      src, wp, out, K, M, tq, aggr, act, attend_act, ldx, ldm, ldw, kc,
      g);
  return cudaGetLastError();
}

// The chain over M queries of K slots each from src: wp the packed
// weights, f32 (layer j's W (dims[j], dims[j+1]) row-major at float offset
// woff[j], its bias at boff[j]; local layers first, then attention
// layers); out (B, M, dims[n_local]) f32.  aggr: 0 max, 1 attend; act codes: 0 relu, 1 leaky,
// 2 identity.  dims/woff/boff are host arrays.  rows: 16, 32 or 64 rows a
// chunk (every layer at most 32768 / rows wide); tq: queries a block; kc:
// weight rows a stage (a multiple of 8); per_sm: blocks an SM, 1 for any
// width, or 2 / 3 for 64-row chunks of layers up to 128 / 64 wide (fewer
// accumulators, so the blocks' registers share an SM).
template <class Src>
static int run_chain(const Src& src, const float* wp, int n_local, int n_attend, const int* dims,
                     const long long* woff,
                     const long long* boff, int aggr, int act, int attend_act,
                     int B, int K, int M, int rows, int tq, int kc,
                     int per_sm, float* out, cudaStream_t st) {
  if (n_local < 0 || n_local > GR_MAX_LAYERS || n_attend < 0 ||
      n_attend > GR_MAX_LAYERS || (aggr == 1 && n_attend < 1) || K < 1 ||
      K > (1 << GR_QBITS) || tq < 1 || tq > (0xffff >> GR_QBITS) || M < 1 ||
      kc < 8 || kc % 8)
    return (int)cudaErrorInvalidValue;
  GroupMeta g;
  g.n_local = n_local;
  g.n_attend = n_attend;
  const int nl = n_local + n_attend;
  int cmax = 1, wmax = 8;
  for (int j = 0; j <= nl; ++j) {
    g.dims[j] = dims[j];
    cmax = dims[j] > cmax ? dims[j] : cmax;
    if (j > 0) wmax = dims[j] > wmax ? dims[j] : wmax;
  }
  if (((wmax + 7) & ~7) > 32768 / rows ||
      (per_sm > 1 && (rows != 64 || wmax > 64 * (4 - per_sm))) ||
      per_sm < 1 || per_sm > 3)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < nl; ++j) {
    g.woff[j] = woff[j];
    g.boff[j] = boff[j];
  }
  const int cout = dims[n_local];
  const int ldx = row_stride(cmax), ldm = row_stride(cout);
  const int ldw = ((wmax + 31) & ~31) + 8;
  const size_t smem =
      smem_bytes(rows, tq, K, kc, ldx, ldm, ldw, cout, aggr);
  cudaError_t e = cudaErrorInvalidValue;
#define GR_LAUNCH(RR, NT, MB)                                                \
  e = launch_chain<RR, NT, MB>(src, wp, out, B, K, M, tq, aggr, act,         \
                               attend_act, ldx, ldm, ldw, kc, g, smem, st)
  if (per_sm == 3)
    GR_LAUNCH(64, 1, 3);
  else if (per_sm == 2)
    GR_LAUNCH(64, 2, 2);
  else if (rows == 64)
    GR_LAUNCH(64, 8, 1);
  else if (rows == 32)
    GR_LAUNCH(32, 16, 1);
  else if (rows == 16)
    GR_LAUNCH(16, 32, 1);
#undef GR_LAUNCH
  return (int)e;
}
