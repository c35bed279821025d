// K2: grouped message MLP + masked aggregation over the K neighbor axis.
//
// Replaces curvecloudnet_tpu/ops/pallas_group.py fused_group_reduce_single
// (pallas_call at :264, the Pallas kernel _group_kernel), k-major form.
// Input: the layer-0 pre-norm messages h1 (B, K, M, C1) and the query-major
// mask (B, M, K) whose column order follows h1's planes.  Per (query, plane):
//     h   = act0(h1 * s0 + t0)                     (layer-0 BN affine)
//     msg = Dense_L(...act(Dense_1(h))...)         (BN folded, plain last)
// then either a masked max over K (a masked slot counts as -100) or, for
// attend, logits = AttendMLP(msg) (BN folded, plain last) and a per-channel
// softmax over K (a masked slot's logit is -500) weighting msg.
//
// Bound on the H100: the multiply-adds of the dense layers on the live
// (query, plane) rows -- at the FP32 rate (67 TFLOP/s) the flagship's 15
// sites need ~3.4 ms; on the tensor cores, 3xTF32 runs three TF32 products
// per multiply-add, a floor of 3x those operations at 495 TFLOP/s (~1.4 ms).
// What the design does about each limit:
//  * Only live rows.  A block owns tq queries (strided over M, so that the
//    budget padding at its end spreads over all blocks) and compacts their
//    live (query, plane) pairs, query-major, into a row list in shared
//    memory; dead planes are never loaded or multiplied.  A query
//    with no live slot gets the plain version's value: under max -100
//    without any row; under attend the uniform mean of its K planes'
//    messages (all logits -500), from all K rows, or from plane 0 alone
//    where the K planes' h1 rows are equal (budget padding).  A live query
//    drops its dead slots' softmax weights exp(-500 - m), which are 0 in
//    f32 whenever its largest live logit m is above -396.
//  * Row tiles of (query, plane) pairs.  The row list is cut into chunks of
//    R = 64 or 32 rows (32 where a layer is 1024 wide or the buffers would
//    not fit 227 KB: the 1024-wide sites and the 512-wide attend site), so
//    each dense is an R x c_in by c_in x c_out product whatever the plane
//    count, never a product of one plane's few queries.  A layer keeps its
//    whole output in the warps' accumulators until every warp has read its
//    input, then writes it over that input: one activation buffer in shared
//    memory (two under attend, which keeps the messages), never device
//    memory, the layer-0 affine and activation applied on load.  A query's
//    rows may straddle two chunks: its max or online-softmax state is
//    carried to the next chunk, so no second kernel merges partial states.
//  * Tensor cores at f32 accuracy: mma.sync m16n8k8 TF32 with 3xTF32
//    (the helpers in tf32_mma.cuh, shared with K7).  Each
//    operand x splits as hi = rna(x), lo = rna(x - hi), rna the rounding of
//    cvt.rna.tf32.f32 (ops/group_reduce.py tf32_split is the same on the
//    CPU), and a product sums lo*hi + hi*lo + hi*hi in f32.  W streams
//    through shared memory in stages of 32, 16 or 8 rows, double-buffered
//    with cp.async, and every warp of the block reads its fragments there;
//    warp w owns all R rows of the output's 8-column tiles w, w + 8, ...;
//    bias and activation are applied to the accumulators as they are
//    stored.

#include "tf32_mma.cuh"

#define GR_MAX_LAYERS 8
#define GR_THREADS 256
#define GR_WARPS (GR_THREADS / 32)
#define GR_QBITS 6  // a row-list entry: query << 6 | plane

struct GroupMeta {
  int n_local, n_attend;
  int dims[2 * GR_MAX_LAYERS + 1];
  long long woff[2 * GR_MAX_LAYERS];  // in floats
  long long boff[2 * GR_MAX_LAYERS];
};

// out (R, cout) = act(in (R, cin) @ W + b), in 3xTF32 on the tensor cores.
// in and out lie in shared memory (row strides ldi, ldo = 4 mod 32, so the
// fragment loads are free of bank conflicts) and may be the same buffer:
// the whole output stays in the warps' accumulators until every warp has
// read the whole input.  Warp w owns all R rows of the block's 8-column
// tiles w, w + 8, ...: at most NTW = 512 / R of them, 128 accumulators a
// thread.  W streams through shared memory in stages of kc rows (row
// stride ldw = 8 mod 32), double-buffered with cp.async: stage 0 is
// already in flight in buffer buf, and the last stage's copy time fetches
// stage 0 of the next layer (next, or none) into the other buffer; buf
// returns where that went.  Columns of out up to cout rounded to 8 are
// written (0 past cout); in must hold 0 from cin up to cin rounded to 8.
template <int R>
__device__ void dense_mma(const float* in, int ldi, float* outp, int ldo,
                          const WLayer& L, const float* __restrict__ bias,
                          int act, bool do_act, float* Ws, int ldw, int kc,
                          int& buf, const WLayer* next) {
  constexpr int MT = R / 16, NTW = 512 / R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cin = L.cin, cout = L.cout;
  const int cin8 = (cin + 7) & ~7, ntiles = ((cout + 7) & ~7) >> 3;
  float acc[MT][NTW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int nst = (cin8 + kc - 1) / kc;
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
    const int kend = min(kc, cin8 - s * kc);
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

template <int R>
__global__ void __launch_bounds__(GR_THREADS, 1)
    group_reduce_kernel(const float* __restrict__ h1,
                        const unsigned char* __restrict__ mask,
                        const float* __restrict__ s0,
                        const float* __restrict__ t0,
                        const float* __restrict__ wp, float* __restrict__ out,
                        int K, int M, int tq, int aggr, int act,
                        int attend_act, int ldx, int ldm, int ldw, int kc,
                        GroupMeta g) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int c1 = g.dims[0];
  const int cout = g.dims[g.n_local];
  const int fields = aggr == 1 ? 3 : 1;  // max; or running max, sum, acc
  float* Ws = sm;                        // two stages of kc weight rows
  float* X = Ws + 2 * kc * ldw;          // the chunk's activations
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

  // 1. the tile's rows: each query's live planes, or all K planes of a
  //    query with no live slot under attend
  for (int q = tid; q < nq; q += nt) {
    const unsigned char* mr = mask + ((size_t)b * M + m0 + q * ms) * K;
    int live = 0;
    for (int k = 0; k < K; ++k) live += mr[k] != 0;
    qcnt[q] = live ? live : (aggr == 1 ? K : 0);
    qflag[q] = (live > 0) | ((live < K) << 1);
  }
  __syncthreads();
  // a query with no live slot under attend weighs its K messages
  // uniformly: where its K planes' h1 rows are equal (budget padding),
  // their mean is the message of plane 0 alone
  if (aggr == 1) {
    for (int q = warp; q < nq; q += GR_WARPS) {
      if (qflag[q] & 1) continue;
      const float* p0 = h1 + ((size_t)b * K * M + m0 + q * ms) * c1;
      bool same = true;
      for (int k = 1; k < K && same; ++k) {
        const float* pk = p0 + (size_t)k * M * c1;
        bool eq = true;
        for (int c = lane; c < c1; c += 32) eq &= pk[c] == p0[c];
        same = __all_sync(0xffffffffu, eq);
      }
      if (same && lane == 0) qcnt[q] = 1;
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
    const unsigned char* mr = mask + ((size_t)b * M + m0 + q * ms) * K;
    const bool dead = !(qflag[q] & 1);
    int pos = qstart[q];
    for (int k = 0; k < K; ++k)
      if (dead ? k < qcnt[q] : mr[k] != 0)
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
                      (g.dims[li + 1] & 3) == 0 && (g.woff[li] & 3) == 0};
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
    if ((c1 & 3) == 0) {
      const int c4 = c1 >> 2;
      for (int i = tid; i < R * c4; i += nt) {
        const int j = i / c4, c = (i - j * c4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < nrow) {
          const int e = list[r0 + j];
          const int q = e >> GR_QBITS, k = e & ((1 << GR_QBITS) - 1);
          v = __ldg(reinterpret_cast<const float4*>(
              h1 + (((size_t)b * K + k) * M + m0 + q * ms) * c1 + c));
          const float4 s = __ldg(reinterpret_cast<const float4*>(s0 + c));
          const float4 o = __ldg(reinterpret_cast<const float4*>(t0 + c));
          v = make_float4(act_fn(v.x * s.x + o.x, act),
                          act_fn(v.y * s.y + o.y, act),
                          act_fn(v.z * s.z + o.z, act),
                          act_fn(v.w * s.w + o.w, act));
        }
        *reinterpret_cast<float4*>(load_dst + j * ld_load + c) = v;
      }
    } else {
      for (int i = tid; i < R * c1; i += nt) {
        const int j = i / c1, c = i - j * c1;
        float v = 0.f;
        if (j < nrow) {
          const int e = list[r0 + j];
          const int q = e >> GR_QBITS, k = e & ((1 << GR_QBITS) - 1);
          const size_t row = ((size_t)b * K + k) * M + m0 + q * ms;
          v = act_fn(h1[row * c1 + c] * s0[c] + t0[c], act);
        }
        load_dst[j * ld_load + c] = v;
      }
    }
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
      dense_mma<R>(cur, cur == MSG ? ldm : ldx, dst, dst == MSG ? ldm : ldx,
                   layer(li), wp + g.boff[li], local ? act : attend_act,
                   !last, Ws, ldw, kc, buf, more ? &nxt : nullptr);
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

static int row_stride(int c) { return ((c + 31) & ~31) + 4; }

// Shared memory of a launch in bytes; the wrapper's _smem_bytes repeats it.
static size_t smem_bytes(int rows, int tq, int K, int kc, int ldx, int ldm,
                         int ldw, int cout, int aggr) {
  const size_t floats = 2 * (size_t)kc * ldw +
                        (size_t)rows * (ldx + (aggr == 1 ? ldm : 0)) +
                        2 * (aggr == 1 ? 3 : 1) * (size_t)cout;
  return floats * 4 + (3 * (size_t)tq + 1) * 4 + 2 * (size_t)tq * K;
}

template <int R>
static cudaError_t launch(const float* h1, const unsigned char* mask,
                          const float* s0, const float* t0, const float* wp,
                          float* out, int B, int K, int M, int tq, int aggr,
                          int act, int attend_act, int ldx, int ldm, int ldw,
                          int kc, const GroupMeta& g, size_t smem,
                          cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      group_reduce_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + tq - 1) / tq, B);
  group_reduce_kernel<R><<<grid, GR_THREADS, smem, st>>>(
      h1, mask, s0, t0, wp, out, K, M, tq, aggr, act, attend_act, ldx, ldm,
      ldw, kc, g);
  return cudaGetLastError();
}

// h1 (B, K, M, dims[0]) f32; mask (B, M, K) bool; s0/t0 (dims[0],) f32;
// wp packed weights: layer j's W (dims[j], dims[j+1]) row-major at float
// offset woff[j], its bias at boff[j]; local layers first, then attention
// layers.  out (B, M, dims[n_local]) f32.  aggr: 0 max, 1 attend; act codes:
// 0 relu, 1 leaky, 2 identity.  dims/woff/boff are host arrays.  rows: 16,
// 32 or 64 rows a chunk (every layer at most 32768 / rows wide); tq:
// queries a block; kc: weight rows a stage (a multiple of 8).
extern "C" int ccn_group_reduce(const float* h1, const unsigned char* mask,
                                const float* s0, const float* t0,
                                const float* wp, int n_local, int n_attend,
                                const int* dims, const long long* woff,
                                const long long* boff, int aggr, int act,
                                int attend_act, int B, int K, int M, int rows,
                                int tq, int kc, float* out, void* stream) {
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
  if (((wmax + 7) & ~7) > 32768 / rows) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < nl; ++j) {
    g.woff[j] = woff[j];
    g.boff[j] = boff[j];
  }
  const int cout = dims[n_local];
  const int ldx = row_stride(cmax), ldm = row_stride(cout);
  const int ldw = ((wmax + 31) & ~31) + 8;
  const size_t smem = smem_bytes(rows, tq, K, kc, ldx, ldm, ldw, cout, aggr);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
#define GR_LAUNCH(RR)                                                        \
  case RR:                                                                   \
    e = launch<RR>(h1, mask, s0, t0, wp, out, B, K, M, tq, aggr, act,        \
                   attend_act, ldx, ldm, ldw, kc, g, smem, st);              \
    break;
  switch (rows) {
    GR_LAUNCH(16)
    GR_LAUNCH(32)
    GR_LAUNCH(64)
  }
#undef GR_LAUNCH
  return (int)e;
}
