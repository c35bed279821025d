// K2-bf16 on Hopper: the grouped message MLP and the masked max or
// softmax-attend over K with a bfloat16 h1, its products on wgmma.
//
// Replaces curvecloudnet_tpu/ops/pallas_group.py fused_group_reduce_single
// (pallas_call at :264) on a bfloat16 h1.  The contract is the plain
// version's (ops/group_reduce.py group_reduce_ref): the layer-0 BN affine
// and activation in f32 on the bfloat16 h1; each dense takes its input and
// W rounded to bfloat16 and sums in f32, its bias f32; the messages (the
// last local layer's output) and the attention logits stay f32 for the
// aggregation, the messages go to the attention chain rounded; out f32.
//
// Bound on the H100: the bytes (h1's live rows, the mask, the output; the
// flagship's 15 sites ~0.34 ms at 3.35 TB/s) over the bfloat16 products
// (~0.23 ms at 989 TFLOP/s).  What the design does about each limit:
//  * bfloat16 activations in shared memory, in the layout wgmma reads: a
//    64-row chunk's activation is a run of 8 KB tiles of 64 rows x 64
//    columns, K-major with the 128-byte swizzle; the epilogue that writes a
//    hidden activation rounds it once (every consumer rounds it anyway).
//  * Products on wgmma.mma_async m64n(32 NS)k16, bfloat16 operands from
//    shared memory, f32 accumulators: two consumer warpgroups split each
//    pass of 64 NS output columns (NS, 1 to 8, fits the site's widest
//    layer), one wgmma a 16-deep step each.  A layer's whole output (up to
//    512 columns, 128 accumulators a thread) stays in registers until both
//    have read the input and is written over it; a 1024-wide layer's first
//    pass goes to free tiles.  Splitting N, not taking chunks of their
//    own, lets the two share one activation buffer and one weight stream,
//    which is what the 1024-wide sites need.
//  * Weights by bulk copy: the wrapper packs W once a call into the exact
//    shared-memory image of each stage (K-major slabs of 16 k, 32-byte
//    swizzle, zero-padded); a producer thread streams the stages with
//    cp.async.bulk into a ring, each completing on its mbarrier; the
//    consumers wait on the stage's barrier and release it on another, with
//    no block barrier per stage.  Where a site's whole image fits beside
//    the buffers it is loaded once a block and stays resident.
//  * Persistent blocks: one a SM, each walking its queries (strided over
//    B x M, so the budget padding at the end of M spreads over all of them)
//    in chunks of 64 live (query, plane) rows.  A listing warp votes each
//    query's live slots (a ballot over its K mask bytes), lists the chunk's
//    rows and copies their raw h1 (16-byte cp.async) into the tiles of one
//    of up to four chunk slots, so the next chunks come in while this one
//    runs;
//    the consumers apply the affine and activation in f32 in place.
//  * The aggregation off the consumers' path (its data-dependent loops
//    beside wgmma made the compiler serialize every wgmma): the consumers
//    stage 32 f32 columns at a time, two buffers a warpgroup, and an
//    aggregator warp a warpgroup walks each query's rows, a column a lane;
//    a query's state (max, or the softmax's) carries across chunks through
//    a per-block scratch, where attend's f32 messages wait too (the
//    1024-wide attend site's would not fit shared memory).
// The wgmma, mbarrier and bulk-copy primitives are in wgmma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tf32_mma.cuh"
#include "wgmma.cuh"

#define GW_ROWS 64           // rows of a chunk (one wgmma M tile)
#define GW_THREADS 384       // two consumer warpgroups, one producer
#define GW_TILE 8192         // 64 rows x 64 bfloat16 columns
#define GW_SUB 32            // output columns of a subtile
#define GW_MAXL 16           // dense layers (local + attention)
#define GW_MAXST 16          // weight ring slots
#define GW_META 784          // bytes of a chunk slot's row list and table
#define GW_QBITS 512         // bytes of the listing warp's ballots
// a chunk's query entry: (query, r0 | r1 << 8 | flags << 16)
#define GW_LIVE 1            // the query has a live slot
#define GW_DEAD 2            // the query has a dead slot
#define GW_FROM 4            // its rows began in the previous chunk
#define GW_TO 8              // its rows go on into the next chunk

// The launch, filled by ops/group_reduce.py plan_bf16 (GW_FIELDS there
// names these ints in order): each warpgroup takes ns subtiles of 32
// columns of a pass (64 ns columns); layer l maps dims[l] to dims[l + 1]
// columns, npad[l] of them stored (a multiple of 64 ns), its bias at float
// boff[l];
// shared memory from a 1024-aligned base: chunk slot s's activation tiles
// at s * x_bytes, the spill tiles at s_off, the weight ring (nst slots of
// sb bytes) at w_off, the slots' row lists and tables at meta_off, the
// ballots at q_off, the equal-planes bits of the block's queries at
// eq_off, the barriers at bar_off; the scratch a block: the f32
// messages (nslot x 64 rows x msg_ld, msg_floats) then the carried state
// (2 x 3 x msg_ld), per_block floats in all; agg_split: the aggregating
// layer's input lies partly in the spill (its staging then in the slot's
// free head, else in the spill); nstg: staging buffers a consumer
// warpgroup (two: it stages a subtile while the last is aggregated).
struct GwMeta {
  int n_local, n_attend, aggr, act, attend_act;
  int B, K, M, c1, cout;
  int nslot, nst, resident, sb;
  int x_bytes, s_off, w_off, meta_off, bar_off, q_off, eq_off;
  int msg_ld, msg_floats, per_block;
  int vec, grid, smem, ns, agg_split, nstg;
  int dims[GW_MAXL + 1];
  int npad[GW_MAXL];
  int boff[GW_MAXL];
};

// (passes, slabs, slabs a stage) of layer l's pass p: a slab is 16 k of the
// pass's columns (pw x 32 bytes), a stage as many whole slabs as sb holds
struct GwPass {
  int pw, nslab, per;
};

__device__ __forceinline__ GwPass gw_pass(const GwMeta& g, int l, int pass) {
  GwPass s;
  s.pw = pass;
  s.nslab = (g.dims[l] + 15) >> 4;
  s.per = max(1, g.sb / (s.pw * 32));
  return s;
}

__device__ __forceinline__ int gw_npass(const GwMeta& g, int l, int pass) {
  return g.npad[l] / pass;
}

// the f32 value of staging row r, column c (0..31) of a warpgroup's 64 x 32
// staging tile, columns swizzled by the row so that fragment stores and
// column reads are free of bank conflicts
__device__ __forceinline__ int gw_stg(int r, int c) {
  return r * 32 + (c ^ ((r & 3) << 3));
}

// Aggregate column n (< cout) of this chunk's queries qg, qg + qs, ...: a
// max, or the online softmax weighting the f32 messages; the logits, or
// under max the messages, from the staging tile stg (local column c), the
// messages under attend from the staging tile msg; without a staging tile
// (a one-layer MLP under max) the messages from msg_g (the scratch); a
// query's state carried through carry.
__device__ __forceinline__ void gw_aggregate(
    const GwMeta& g, const int2* tab, int nq, int qg, int qs, int n, int c,
    const float* stg, const float* msg, const float* msg_g, float* carry,
    int ch, float* __restrict__ out) {
  const float* cin = carry + ((ch + 1) & 1) * 3 * g.msg_ld;
  float* cnext = carry + (ch & 1) * 3 * g.msg_ld;
  for (int q = qg; q < nq; q += qs) {
    const int2 e = tab[q];
    const int r0 = e.y & 255, r1 = (e.y >> 8) & 255, f = e.y >> 16;
    if (g.aggr == 0) {
      float v = (f & GW_FROM) ? cin[n]
                              : ((f & GW_DEAD) ? -100.f
                                               : -__int_as_float(0x7f800000));
      if (stg) {
#pragma unroll 4
        for (int r = r0; r < r1; ++r) v = fmaxf(v, stg[gw_stg(r, c)]);
      } else {
        for (int r = r0; r < r1; ++r) v = fmaxf(v, msg_g[r * g.msg_ld + n]);
      }
      if (f & GW_TO)
        cnext[n] = v;
      else
        out[(size_t)e.x * g.cout + n] = v;
    } else {
      float mx = (f & GW_FROM) ? cin[n] : -1e30f;
      float den = (f & GW_FROM) ? cin[g.msg_ld + n] : 0.f;
      float acc = (f & GW_FROM) ? cin[2 * g.msg_ld + n] : 0.f;
#pragma unroll 4
      for (int r = r0; r < r1; ++r) {
        const float l = (f & GW_LIVE) ? stg[gw_stg(r, c)] : -500.f;
        const float nm = fmaxf(mx, l);
        const float sc = __expf(mx - nm), w = __expf(l - nm);
        den = den * sc + w;
        acc = acc * sc + w * msg[gw_stg(r, c)];
        mx = nm;
      }
      if (f & GW_TO) {
        cnext[n] = mx;
        cnext[g.msg_ld + n] = den;
        cnext[2 * g.msg_ld + n] = acc;
      } else {
        out[(size_t)e.x * g.cout + n] = __fdividef(acc, den);
      }
    }
  }
}

// Where a pass's products read and release their operands: the weight
// ring and its barriers, the activation's tiles (the first split of them
// in the spill), this warpgroup's first column in the pass, whether this
// thread signals its warp's release.
struct GwProducts {
  uint32_t ring, wfull0, wempty0, xb, sreg;
  int split, row0;
  bool signal;
};

// A pass's products on NS subtiles of 32 columns: its stages in turn, the
// previous stage released once its products are done (the wgmma straight
// in a row, so that none waits on the one before)
template <int NS>
__device__ __forceinline__ void gw_products(float (&acc)[NS][16],
                                            const GwMeta& g,
                                            const GwPass& ps,
                                            const GwProducts& pr, int& gs) {
  int prev = -1;
  for (int k0 = 0; k0 < ps.nslab; k0 += ps.per) {
    const int ns = min(ps.per, ps.nslab - k0);
    const int slot = gs % g.nst;
    gw_wait(pr.wfull0 + 8 * slot, (gs / g.nst) & 1);
    const uint32_t stage = pr.ring + slot * g.sb + pr.row0 * 32;
    gw_fence_acc(acc);
    gw_wg_fence();
    for (int sl = 0; sl < ns; ++sl) {
      const int k = k0 + sl, tile = k >> 2;
      const uint64_t da = gw_desc128((tile < pr.split ? pr.sreg : pr.xb) +
                                     tile * GW_TILE + (k & 3) * 32);
      const uint64_t db = gw_desc32(stage + sl * ps.pw * 32);
      gw_mma<NS>(acc, da, db, k > 0);
    }
    gw_wg_commit();
    gw_fence_acc(acc);
    if (!g.resident) {
      if (prev >= 0) {
        gw_wg_wait<1>();
        gw_arrive_if(pr.wempty0 + 8 * prev, pr.signal);
      }
      prev = slot;
    }
    ++gs;
  }
  gw_wg_wait<0>();
  gw_fence_acc(acc);
  if (prev >= 0) gw_arrive_if(pr.wempty0 + 8 * prev, pr.signal);
}

// 8 bfloat16 values each (raw bits), equal as floats (-0 equals 0, a NaN
// nothing)
__device__ __forceinline__ bool gw_eq8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  bool eq = true;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    eq &= __uint_as_float(x[i] << 16) == __uint_as_float(y[i] << 16) &&
          __uint_as_float(x[i] & 0xffff0000u) ==
              __uint_as_float(y[i] & 0xffff0000u);
  return eq;
}

// Whether query q's K planes of h1 are equal (a warp; budget padding),
// 16-byte loads, four a lane in flight, where the rows allow them
__device__ __forceinline__ bool gw_same_planes(
    const GwMeta& g, const __nv_bfloat16* __restrict__ h1, int q,
    int lane) {
  const int b = q / g.M, m = q - b * g.M;
  const __nv_bfloat16* p0 = h1 + ((size_t)b * g.K * g.M + m) * g.c1;
  const size_t plane = (size_t)g.M * g.c1;
  if (g.vec) {
    const int nck = g.c1 >> 3, total = (g.K - 1) * nck;
    for (int i0 = lane; i0 < total; i0 += 4 * 32) {
      uint4 a[4], c[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u;
        a[u] = c[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total) {
          const int k = 1 + i / nck, j = (i - (k - 1) * nck) * 8;
          a[u] = __ldg(reinterpret_cast<const uint4*>(p0 + j));
          c[u] = __ldg(reinterpret_cast<const uint4*>(p0 + k * plane + j));
        }
      }
      bool eq = true;
#pragma unroll
      for (int u = 0; u < 4; ++u) eq &= gw_eq8(a[u], c[u]);
      if (!__all_sync(0xffffffffu, eq)) return false;
    }
    return true;
  }
  for (int k = 1; k < g.K; ++k) {
    bool eq = true;
    for (int j = lane; j < g.c1; j += 32)
      eq &= __bfloat162float(p0[k * plane + j]) == __bfloat162float(p0[j]);
    if (!__all_sync(0xffffffffu, eq)) return false;
  }
  return true;
}

// A chunk slot's row list and query table: hdr (rows, queries; -1 past
// the last chunk), then the table, then the rows (h1 row indices)
struct GwSlot {
  int* hdr;
  int2* tab;
  int* rows;
};

__device__ __forceinline__ GwSlot gw_slot(const GwMeta& g, unsigned char* sm,
                                          int slot) {
  GwSlot s;
  s.hdr = reinterpret_cast<int*>(sm + g.meta_off + slot * GW_META);
  s.tab = reinterpret_cast<int2*>(s.hdr + 2);
  s.rows = reinterpret_cast<int*>(s.tab + GW_ROWS);
  return s;
}

// Warp 9: each chunk's rows listed into slot c % nslot once the consumers
// and the aggregators have released it, its place in the block's query walk
// carried from chunk to chunk; then the rows' raw h1 groups copied
// (cp.async) into their places in the slot's tiles, the slot's full
// barrier completing as they land (the consumers apply the affine and
// activation in place).
__device__ __forceinline__ void gw_list(
    const GwMeta& g, unsigned char* sm, const __nv_bfloat16* __restrict__ h1,
    const unsigned char* __restrict__ mask, float* __restrict__ out,
    uint32_t empty0, uint32_t full0) {
  const int lane = threadIdx.x & 31;
  const int total = g.B * g.M;
  const int nqb = (total - (int)blockIdx.x + (int)gridDim.x - 1) /
                  (int)gridDim.x;
  const int nw = (g.K + 31) >> 5;
  uint32_t* qbits = reinterpret_cast<uint32_t*>(sm + g.q_off);
  // the next query, the current one's slots and rows out
  int qi = 0, cnt = 0, off = 0, flags = 0, have = 0, q = 0;
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
  for (int c = 0;; ++c) {
    const int slot = c % g.nslot, use = c / g.nslot;
    const GwSlot sl = gw_slot(g, sm, slot);
    unsigned char* xs = sm + slot * g.x_bytes;
    gw_wait_bounded(empty0 + 8 * slot, (use & 1) ^ 1);
    int n = 0, nq = 0;
    while (n < GW_ROWS) {
      if (!have) {
        if (qi >= nqb) break;
        if ((qi & 31) == 0) {
          // ballots of the next 32 queries' mask bytes, 16 a round
          for (int j0 = 0; j0 < 32; j0 += 16)
            for (int w = 0; w < nw; ++w) {
              unsigned char v[16];
              const int k = 32 * w + lane;
#pragma unroll
              for (int u = 0; u < 16; ++u) {
                const int qq = qi + j0 + u;
                const long long gq =
                    (long long)blockIdx.x + (long long)qq * gridDim.x;
                v[u] = (qq < nqb && k < g.K) ? __ldg(mask + gq * g.K + k)
                                             : (unsigned char)0;
              }
              // every byte in before the first ballot: the compiler would
              // otherwise let each ballot wait on its own load in turn
              uint32_t all = 0;
#pragma unroll
              for (int u = 0; u < 16; ++u) all |= v[u];
              asm volatile("" ::"r"(all));
#pragma unroll
              for (int u = 0; u < 16; ++u) {
                const uint32_t b = __ballot_sync(0xffffffffu, v[u] != 0);
                if (lane == 0) qbits[(j0 + u) * 4 + w] = b;
              }
            }
          __syncwarp();
        }
        q = (int)blockIdx.x + qi * (int)gridDim.x;
        cnt = 0;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          bits[w] = w < nw ? qbits[(qi & 31) * 4 + w] : 0u;
          cnt += __popc(bits[w]);
        }
        flags = (cnt > 0 ? GW_LIVE : 0) | (cnt < g.K ? GW_DEAD : 0);
        if (cnt == 0) {
          if (g.aggr == 0) {
            // no live slot under max: every slot counts as -100
            for (int j = lane; j < g.cout; j += 32)
              out[(size_t)q * g.cout + j] = -100.f;
            ++qi;
            continue;
          }
          // under attend the uniform mean of its K planes' messages:
          // plane 0 alone where the K planes' h1 rows are equal
          const uint32_t* eq = reinterpret_cast<const uint32_t*>(sm + g.eq_off);
          cnt = (eq[qi >> 5] >> (qi & 31)) & 1u ? 1 : g.K;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int lo = 32 * w, hi = min(cnt, lo + 32);
            bits[w] = hi <= lo ? 0u
                               : (hi - lo == 32 ? 0xffffffffu
                                                : (1u << (hi - lo)) - 1u);
          }
        }
        off = 0;
        have = 1;
      }
      const int take = min(cnt - off, GW_ROWS - n);
      // this query's rows off .. off + take - 1, a slot a lane, each row's
      // raw h1 groups copied as it is listed
      const int b = g.B == 1 ? 0 : q / g.M, m = q - b * g.M;
      int before = 0;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int k = 32 * w + lane;
        const int pos = before + __popc(bits[w] & ((1u << lane) - 1u));
        if (((bits[w] >> lane) & 1u) && pos >= off && pos < off + take) {
          const int r = n + pos - off, row = (b * g.K + k) * g.M + m;
          sl.rows[r] = row;
          if (g.vec)
            for (int cc = 0; cc < g.c1; cc += 8)
              cp_async16(xs + (cc >> 6) * GW_TILE + gw_tile_at(r, cc),
                         h1 + (size_t)row * g.c1 + cc);
        }
        before += __popc(bits[w]);
      }
      if (lane == 0)
        sl.tab[nq] = make_int2(
            q, n | ((n + take) << 8) |
                   ((flags | (off > 0 ? GW_FROM : 0) |
                     (off + take < cnt ? GW_TO : 0))
                    << 16));
      ++nq;
      n += take;
      off += take;
      if (off == cnt) {
        have = 0;
        ++qi;
      }
    }
    const bool done = n == 0 && qi >= nqb;
    if (lane == 0) {
      sl.hdr[0] = n;
      sl.hdr[1] = done ? -1 : nq;
    }
    __syncwarp();
    if (g.vec)
      gw_arrive_copies(full0 + 8 * slot);
    else
      gw_arrive(full0 + 8 * slot);
    if (done) return;
  }
}

// Staging buffer b of consumer warpgroup w for chunk slot slot: the
// logits (or max's messages), f32, then under attend the messages
__device__ __forceinline__ float* gw_staging(const GwMeta& g,
                                             unsigned char* sm, int slot,
                                             int w, int b) {
  return reinterpret_cast<float*>(
      sm + (g.agg_split > 0 ? slot * g.x_bytes : g.s_off) +
      (g.aggr + 1) * (w * g.nstg + b) * GW_TILE);
}

// The consumers' first step of a chunk: its rows in place in the slot's
// tiles (the raw h1 groups the listing warp copied there, or for a ragged
// width loaded here), the layer-0 affine and activation in f32, rounded;
// rows past the chunk's and columns past c1 zero; a one-layer MLP's
// messages, f32, to the scratch.  Thread t of 256 takes groups t, t + 256..
__device__ __forceinline__ void gw_rows_in(
    const GwMeta& g, unsigned char* sm, int slot, const GwSlot& sl,
    const __nv_bfloat16* __restrict__ h1, const float* __restrict__ s0,
    const float* __restrict__ t0, float* msg, int t) {
  const int nrow = sl.hdr[0];
  const int ngrp = ((g.c1 + 15) & ~15) >> 3;  // 8-column groups read
  unsigned char* xs = sm + slot * g.x_bytes;
  for (int i = t; i < GW_ROWS * ngrp; i += 256) {
    const int r = i / ngrp, cc = (i - r * ngrp) * 8;
    uint4* at =
        reinterpret_cast<uint4*>(xs + (cc >> 6) * GW_TILE + gw_tile_at(r, cc));
    float v[8];
    if (r < nrow && g.vec && cc + 8 <= g.c1) {
      const uint4 raw = *at;
      const float4 sa = __ldg(reinterpret_cast<const float4*>(s0 + cc));
      const float4 sb = __ldg(reinterpret_cast<const float4*>(s0 + cc + 4));
      const float4 ta = __ldg(reinterpret_cast<const float4*>(t0 + cc));
      const float4 tb = __ldg(reinterpret_cast<const float4*>(t0 + cc + 4));
      const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
      const float sh[8] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
      const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = act_fn(
            __uint_as_float((w4[j >> 1] >> ((j & 1) * 16)) << 16) * sc[j] +
                sh[j],
            g.act);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cc + j;
        v[j] = r < nrow && col < g.c1
                   ? act_fn(__bfloat162float(__ldg(
                                h1 + (size_t)sl.rows[r] * g.c1 + col)) *
                                    __ldg(s0 + col) +
                                __ldg(t0 + col),
                            g.act)
                   : 0.f;
      }
    }
    *at = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    if (g.n_local == 0 && r < nrow) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (cc + j < g.c1) msg[r * g.msg_ld + cc + j] = v[j];
    }
  }
}

// Warps 10-11: the aggregation, off the consumers' path (data-dependent
// loops near wgmma would make the compiler serialize every wgmma): warp
// 10 takes consumer warpgroup 0's staged subtiles, warp 11 warpgroup 1's,
// the messages under attend from the scratch (cp.async) beside each
// subtile's logits.  A one-layer MLP under max (no dense in the kernel)
// aggregates the scratch's messages, the two warps alternating subtiles.
template <int NS>
__device__ __forceinline__ void gw_aggregator(
    const GwMeta& g, unsigned char* sm, float* scratch, float* out,
    uint32_t full0, uint32_t empty0, uint32_t staged0, uint32_t freed0) {
  const int w = (threadIdx.x >> 5) - 10, lane = threadIdx.x & 31;
  const int nl = g.n_local + (g.aggr == 1 ? g.n_attend : 0);
  const int np = nl > 0 ? g.npad[nl - 1] / (64 * NS) : 0;
  float* carry = scratch + g.msg_floats;
  int su = 0;  // staged subtiles taken
  for (int c = 0;; ++c) {
    const int slot = c % g.nslot;
    gw_wait_bounded(full0 + 8 * slot, (c / g.nslot) & 1);
    const GwSlot sl = gw_slot(g, sm, slot);
    const int nq = sl.hdr[1];
    if (nq < 0) return;
    const float* msg = scratch + slot * GW_ROWS * g.msg_ld;
    if (nl == 0) {
      // the consumers wrote the messages into the scratch
      gw_wait_bounded(staged0 + 8 * (2 * w + su % g.nstg),
                      (su / g.nstg) & 1);
      ++su;
      for (int n = w * 32 + lane; n < g.cout; n += 64)
        gw_aggregate(g, sl.tab, nq, 0, 1, n, n & 31, nullptr, nullptr, msg,
                     carry, c, out);
    }
    for (int t = 0; t < np * NS; ++t, ++su) {
      const int col = (t / NS) * 64 * NS + w * NS * GW_SUB + (t % NS) * GW_SUB;
      const int b = su % g.nstg;
      const uint32_t staged = staged0 + 8 * (2 * w + b);
      float* stg = gw_staging(g, sm, slot, w, b);
      float* mstg = stg + GW_TILE / 4;
      // the subtile's messages, 16 bytes a copy: written in this chunk's
      // message layer, so before any of its logits were staged (the first
      // subtile's copies wait for that; the later ones overlap the wait
      // for their logits)
      if (t == 0) gw_wait_bounded(staged, (su / g.nstg) & 1);
      if (g.aggr == 1) {
#pragma unroll 4
        for (int i = lane; i < GW_ROWS * 8; i += 32) {
          const int r = i >> 3, c4 = (i & 7) * 4;
          cp_async16(mstg + gw_stg(r, c4), msg + r * g.msg_ld + col + c4);
        }
        cp_async_commit();
      }
      if (t > 0) gw_wait_bounded(staged, (su / g.nstg) & 1);
      if (g.aggr == 1) {
        cp_async_wait<0>();
        __syncwarp();
      }
      if (col + lane < g.cout)
        gw_aggregate(g, sl.tab, nq, 0, 1, col + lane, lane, stg, mstg, msg,
                     carry, c, out);
      __syncwarp();
      gw_arrive_if(freed0 + 8 * (2 * w + b), lane == 0);
    }
    gw_arrive_if(empty0 + 8 * slot, lane == 0);
  }
}

// Kernel K2-bf16: a persistent block per SM.  Warps 0-7: two consumer
// warpgroups of NS subtiles each; warp 8: the weight stream; warp 9: the
// row lists and the rows' raw copies; warps 10-11: the aggregation.
template <int NS>
__global__ void __launch_bounds__(GW_THREADS, 1)
    group_wgmma_kernel(const __nv_bfloat16* __restrict__ h1,
                       const unsigned char* __restrict__ mask,
                       const float* __restrict__ s0,
                       const float* __restrict__ t0,
                       const char* __restrict__ wimg,
                       const float* __restrict__ bias,
                       float* __restrict__ out, float* __restrict__ scratch,
                       const __grid_constant__ GwMeta g) {
  extern __shared__ __align__(1024) unsigned char gw_raw[];
  const uint32_t raw_addr = gw_smem(gw_raw);
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  unsigned char* sm = gw_raw + pad;
  const uint32_t sbase = raw_addr + pad;
  // barriers (8 bytes each): full[nslot], empty[nslot], wfull[nst],
  // wempty[nst], staged[2][2], freed[2][2]
  const uint32_t full0 = sbase + g.bar_off;
  const uint32_t empty0 = full0 + 8 * g.nslot;
  const uint32_t wfull0 = empty0 + 8 * g.nslot;
  const uint32_t wempty0 = wfull0 + 8 * g.nst;
  const uint32_t staged0 = wempty0 + 8 * g.nst;  // [warpgroup][buffer]
  const uint32_t freed0 = staged0 + 32;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < g.nslot; ++s) {
      gw_mbar_init(full0 + 8 * s, 32);
      gw_mbar_init(empty0 + 8 * s, 10);
    }
    for (int i = 0; i < g.nst; ++i) {
      gw_mbar_init(wfull0 + 8 * i, 1);
      gw_mbar_init(wempty0 + 8 * i, 8);
    }
    for (int w = 0; w < 4; ++w) {
      gw_mbar_init(staged0 + 8 * w, 128);
      gw_mbar_init(freed0 + 8 * w, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (g.aggr == 1) {
    // which of the block's queries with no live slot have K equal h1
    // planes (budget padding), every warp on its share of them
    uint32_t* eq = reinterpret_cast<uint32_t*>(sm + g.eq_off);
    const int nqb = (g.B * g.M - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;
    for (int i = tid; i < (nqb + 31) >> 5; i += GW_THREADS) eq[i] = 0u;
    __syncthreads();
    const int lane = tid & 31;
    for (int qi = tid >> 5; qi < nqb; qi += GW_THREADS / 32) {
      const int q = (int)blockIdx.x + qi * (int)gridDim.x;
      bool live = false;
      for (int k = lane; k < g.K; k += 32)
        live |= __ldg(mask + (size_t)q * g.K + k) != 0;
      if (!__any_sync(0xffffffffu, live) && gw_same_planes(g, h1, q, lane) &&
          lane == 0)
        atomicOr(eq + (qi >> 5), 1u << (qi & 31));
    }
  }
  __syncthreads();
  scratch += (size_t)blockIdx.x * g.per_block;
  const int nl = g.n_local + (g.aggr == 1 ? g.n_attend : 0);
  // the warpgroup, uniform in the compiler's eyes (a shuffle of lane 0's),
  // so that the consumers' wgmma sit on a path it knows is not divergent
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  // registers move from the producer to the consumers within the block's
  // allocation (168 a thread at launch): 128 x (168 - 64) >= 256 x (216 - 168)
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 64;\n" ::: "memory");
    if (tid >= 10 * 32) {
      gw_aggregator<NS>(g, sm, scratch, out, full0, empty0, staged0, freed0);
    } else if (tid >= 9 * 32) {
      gw_list(g, sm, h1, mask, out, empty0, full0);
    } else if (tid == 8 * 32) {
      // the weight stream: each chunk's stages in the consumers' order
      // (layers, passes, groups of slabs), or once where resident
      const uint32_t ring = sbase + g.w_off;
      int gs = 0;
      for (int c = 0;; ++c) {
        if (!g.resident || c == 0) {
          if (!g.resident) {
            gw_wait_bounded(full0 + 8 * (c % g.nslot), (c / g.nslot) & 1);
            const int* hdr =
                reinterpret_cast<const int*>(sm + g.meta_off +
                                             (c % g.nslot) * GW_META);
            if (hdr[1] < 0) break;
          }
          size_t off = 0;
          for (int l = 0; l < nl; ++l)
            for (int p = 0; p < gw_npass(g, l, 64 * NS); ++p) {
              const GwPass ps = gw_pass(g, l, 64 * NS);
              for (int k0 = 0; k0 < ps.nslab; k0 += ps.per) {
                const uint32_t bytes =
                    (uint32_t)min(ps.per, ps.nslab - k0) * ps.pw * 32;
                const int slot = gs % g.nst, use = gs / g.nst;
                if (!g.resident)
                  gw_wait_bounded(wempty0 + 8 * slot, (use & 1) ^ 1);
                gw_expect_tx(wfull0 + 8 * slot, bytes);
                gw_bulk(ring + slot * g.sb, wimg + off, bytes,
                        wfull0 + 8 * slot);
                off += bytes;
                ++gs;
              }
            }
        }
        if (g.resident) {
          // hold the block until the resident stages have landed
          for (int i = 0; i < gs; ++i) gw_wait_bounded(wfull0 + 8 * i, 0);
          break;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    const uint32_t ring = sbase + g.w_off;
    const uint32_t sreg = sbase + g.s_off;
    int gs = 0, fu = 0;  // weight stages used; staging slot uses
    // a layer whose earlier passes go to the spill tiles
    bool spills = false;
    for (int l = 0; l + 1 < nl; ++l) spills |= g.npad[l] > 64 * NS;
    for (int c = 0;; ++c) {
      const int slot = c % g.nslot;
      gw_wait(full0 + 8 * slot, (c / g.nslot) & 1);
      const GwSlot sl = gw_slot(g, sm, slot);
      const int nq = sl.hdr[1];
      // a vote, so that the compiler sees the loop's exit as uniform and
      // the wgmma inside it on no divergent path
      if (__any_sync(0xffffffffu, nq < 0)) break;
      const uint32_t xb = sbase + slot * g.x_bytes;
      float* msgw = scratch + slot * GW_ROWS * g.msg_ld;
      if (g.resident) gs = 0;
      // both warpgroups past the previous chunk, its spill tiles free
      if (spills) gw_bar(1, 256);
      gw_rows_in(g, sm, slot, sl, h1, s0, t0, msgw, tid);
      gw_fence_async();
      gw_bar(1, 256);
      if (nl == 0) {
        gw_arrive(staged0 + 8 * (2 * wg + fu % g.nstg));
        ++fu;
      }
      int split = 0;  // the activation's first split tiles lie in the spill
      for (int l = 0; l < nl; ++l) {
        const bool last_local = l == g.n_local - 1, last = l == nl - 1;
        const bool agg = g.aggr == 0 ? last_local : last;
        const bool msg_out = g.aggr == 1 && last_local;
        const bool do_act = !(last_local || last);
        const int act = l < g.n_local ? g.act : g.attend_act;
        const int np = gw_npass(g, l, 64 * NS);
        const float* bl = bias + g.boff[l];
        for (int p = 0; p < np; ++p) {
          const GwPass ps = gw_pass(g, l, 64 * NS);
          const int row0 = wg * NS * GW_SUB;  // within the pass
          const int col0 = p * 64 * NS + row0;
          // the products (the same code for both warpgroups: no branch on
          // the warpgroup comes near a wgmma)
          float acc[NS][16];
          const GwProducts pr = {ring, wfull0, wempty0, xb, sreg, split, row0,
                                 lane == 0};
          gw_products<NS>(acc, g, ps, pr, gs);

          if (agg) {
            // the aggregators take 32 columns at a time: bias added, f32,
            // into this warpgroup's staging tile, once they have freed it
#pragma unroll
            for (int j = 0; j < NS; ++j) {
              const float* v = acc[j];
              const int b = fu % g.nstg;
              float* stg = gw_staging(g, sm, slot, wg, b);
              gw_wait(freed0 + 8 * (2 * wg + b), ((fu / g.nstg) & 1) ^ 1);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const int r = warp * 16 + (lane >> 2) + 8 * (e & 1);
                const int cl = (e >> 1) * 8 + 2 * (lane & 3);
                const float2 b2 = __ldg(reinterpret_cast<const float2*>(
                    bl + col0 + j * GW_SUB + cl));
                *reinterpret_cast<float2*>(stg + gw_stg(r, cl)) =
                    make_float2(v[(e >> 1) * 4 + 2 * (e & 1)] + b2.x,
                                v[(e >> 1) * 4 + 2 * (e & 1) + 1] + b2.y);
              }
              gw_arrive(staged0 + 8 * (2 * wg + b));
              ++fu;
            }
          } else {
            // a hidden activation (or attend's messages): bias, activation,
            // rounded into the tiles; the last pass over the input's own
            // tiles once both warpgroups have read them, an earlier one
            // into free tiles (the spill, or the input's free head)
            const bool held = p == np - 1;
            if (held) gw_bar(1, 256);
            const uint32_t dst = held ? xb : (split == 0 ? sreg : xb);
#pragma unroll
            for (int j = 0; j < NS; ++j) {
              const float* v = acc[j];
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const int r = warp * 16 + (lane >> 2) + 8 * (e & 1);
                const int n = col0 + j * GW_SUB + (e >> 1) * 8 + 2 * (lane & 3);
                const float2 b2 =
                    __ldg(reinterpret_cast<const float2*>(bl + n));
                float v0 = v[(e >> 1) * 4 + 2 * (e & 1)] + b2.x;
                float v1 = v[(e >> 1) * 4 + 2 * (e & 1) + 1] + b2.y;
                if (msg_out)
                  *reinterpret_cast<float2*>(msgw + r * g.msg_ld + n) =
                      make_float2(v0, v1);
                if (do_act) {
                  v0 = act_fn(v0, act);
                  v1 = act_fn(v1, act);
                }
                gw_st32(dst + (n >> 6) * GW_TILE + gw_tile_at(r, n),
                        pack_bf16(v0, v1));
              }
            }
          }
        }
        if (!agg) {
          gw_fence_async();
          gw_bar(1, 256);
          split = (np > 1 && split == 0) ? (np - 1) * NS : 0;
        }
      }
      // release the slot: each warp past its reads of it (the aggregators
      // release it too)
      __syncwarp();
      gw_arrive_if(empty0 + 8 * slot, lane == 0);
    }
  }
}

// K2-bf16's launch: plan holds GwMeta's ints in order (nplan of them);
// h1 (B, K, M, c1) bfloat16, mask (B, M, K), s0 / t0 (c1,) f32, wimg the
// packed stage image, bias the padded biases, scratch grid x per_block f32,
// out (B, M, cout) f32.
static int run_group_wgmma(const __nv_bfloat16* h1, const unsigned char* mask,
                           const float* s0, const float* t0, const void* wimg,
                           const float* bias, float* scratch, const int* plan,
                           int nplan, float* out, cudaStream_t st) {
  GwMeta g;
  if (nplan != (int)(sizeof(GwMeta) / sizeof(int)))
    return (int)cudaErrorInvalidValue;
  memcpy(&g, plan, sizeof g);
  const int nl = g.n_local + (g.aggr == 1 ? g.n_attend : 0);
  if (g.K < 1 || g.K > 128 || nl > GW_MAXL || g.n_local < 0 ||
      (g.aggr == 1 && g.n_attend < 1) || g.nslot < 1 || g.nslot > 4 ||
      g.nst < 1 || g.nst > GW_MAXST || g.sb % 1024 || g.grid < 1 ||
      g.smem > 232448 || g.B * g.M < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaErrorInvalidValue;
#define GW_LAUNCH(NS)                                                         \
  case NS:                                                                    \
    e = cudaFuncSetAttribute(group_wgmma_kernel<NS>,                          \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                             g.smem);                                         \
    if (e != cudaSuccess) return (int)e;                                      \
    group_wgmma_kernel<NS><<<g.grid, GW_THREADS, g.smem, st>>>(               \
        h1, mask, s0, t0, reinterpret_cast<const char*>(wimg), bias, out,     \
        scratch, g);                                                          \
    break;
  switch (g.ns) {
    GW_LAUNCH(1) GW_LAUNCH(2) GW_LAUNCH(3) GW_LAUNCH(4)
    GW_LAUNCH(5) GW_LAUNCH(6) GW_LAUNCH(7) GW_LAUNCH(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GW_LAUNCH
  return (int)cudaGetLastError();
}
