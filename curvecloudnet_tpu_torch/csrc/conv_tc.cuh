// The window product of the conv1d-fast-v2 kernels K1 (conv1d_chain.cu) and
// K8 (conv1d_train.cu) as 3xTF32 tensor-core GEMMs over rows of slots.
//
// A layer with half-window h maps u (C_in wide) to
//     z(q) = u(q) W_0 + sum_{d=1..h} (u(q-d) + u(q+d)) W_d + b.
// By linearity, with P = u [W_0 | W_1 | ... | W_h] ((h+1) C_out wide),
//     z(q) = P_0(q) + sum_{d=1..h} (P_d(q-d) + P_d(q+d)) + b,
// where P_d(q) is 0 wherever u(q) is (outside [0, n_exp), dead slots): the
// (possibly wide) u is read once as a plain A operand and the pair sums and
// shifts run on the (h+1) C_out wide side (shift_sum below).  The backward
// shifts the C_out-wide cotangent dz instead: d_u_prev = window(dz) W^T and
// dW = u^T window(dz), with window(dz)(q) = [dz(q), dz(q-1) + dz(q+1), ...].
//
// warp_mma is the one product routine: a warp's 16 rows (CV_ROWS a block of
// 8 warps) times NT 8-column tiles, mma.sync m16n8k8 in TF32 with each
// operand split into (hi, lo) TF32 parts (tf32_mma.cuh) and three products
// lo*hi + hi*lo + hi*hi accumulated in f32 (f32 accuracy).  A is raw f32 in
// shared memory, split as its fragments load (each A element is loaded by
// one warp); B is stored split (put_split), since every warp reads all of it.
#pragma once

#include "tf32_mma.cuh"

#define CV_THREADS 256
#define CV_ROWS 128  // rows (slots) of a block's tile: 8 warps x 16
#define CV_KC 32     // inner depth of a streamed stage
#define CV_LDA 36    // row stride of an A stage, [row][k] (4 mod 32)

// Row stride of a B operand of NT 8-column tiles ([k][n], 8 mod 32 when
// 8 NT is a multiple of 32) and of an accumulator tile stored as [row][n].
template <int NT>
struct CvDims {
  static constexpr int NP = 8 * NT;
  static constexpr int LDB = NP + 8;
  static constexpr int LDP = NP + 4;
  static constexpr int BSTAGE = 2 * CV_KC * LDB;  // a stage's hi, then lo
};

// (row, column) of a flat index i = row w + column, stepped by CV_THREADS
// without a division a step (w is a runtime width)
struct RowCol {
  int r, c, dq, dr, w;
  __device__ __forceinline__ RowCol(int i, int w_)
      : r(i / w_), c(i % w_), dq(CV_THREADS / w_), dr(CV_THREADS % w_),
        w(w_) {}
  __device__ __forceinline__ void next() {
    r += dq;
    c += dr;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

// Offsets, from row p of a C_out-wide buffer of rows p - h .., of the two
// terms of column n of the windows [x(q), x(q-1) + x(q+1), ...] at q = p:
// (h - d) C_out + co and (h + d) C_out + co for column n = d C_out + co;
// the second is -1 for d = 0, both -1 past (h+1) C_out.
__device__ __forceinline__ int2 window_offsets(int n, int cout, int h) {
  if (n >= (h + 1) * cout) return make_int2(-1, -1);
  const int d = n / cout, co = n - d * cout;
  return make_int2((h - d) * cout + co, d ? (h + d) * cout + co : -1);
}

// column n of the windows at row p of x (C_out wide, rows p - h ..), by the
// offsets window_offsets gives
__device__ __forceinline__ float window_at(const float* x, int p, int cout,
                                           int2 o) {
  const float* c = x + (size_t)p * cout;
  return o.x < 0 ? 0.f : o.y < 0 ? c[o.x] : c[o.x] + c[o.y];
}

__device__ __forceinline__ void put_split(uint32_t* hi, uint32_t* lo, int o,
                                          float v) {
  const uint32_t h = tf32_rna(v);
  hi[o] = h;
  lo[o] = tf32_lo(v, h);
}

// acc[j] (rows r0 + g, r0 + g + 8; columns 8 j + 2 t, + 1) += the warp's
// 16 rows of A (columns 0 .. 8 ksteps) x B (hi, lo; rows 0 .. 8 ksteps).
// A is [row][k] with stride lda (4 mod 32), or with ATRANS [k][row] with
// stride lda (8 mod 32); B is [k][n] with stride ldb (8 mod 32): every
// fragment load is free of bank conflicts.  With BRAW, Bhi holds B's raw
// f32 bits, split here (Blo is not read).
template <int NT, bool ATRANS, bool BRAW = false>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* A,
                                         int lda, int r0, const uint32_t* Bhi,
                                         const uint32_t* Blo, int ldb,
                                         int ksteps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = 8 * ks;
    float a[4];
    if (ATRANS) {
      const float* p = A + (size_t)(k + t) * lda + r0 + g;
      a[0] = p[0];
      a[1] = p[8];
      a[2] = p[4 * lda];
      a[3] = p[4 * lda + 8];
    } else {
      const float* p = A + (size_t)(r0 + g) * lda + k + t;
      a[0] = p[0];
      a[1] = p[8 * lda];
      a[2] = p[4];
      a[3] = p[8 * lda + 4];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[e] = tf32_rna(a[e]);
      al[e] = tf32_lo(a[e], ah[e]);
    }
    const int o = (k + t) * ldb + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh0, bh1, bl0, bl1;
      if (BRAW) {
        const float b0 = __uint_as_float(Bhi[o + 8 * j]);
        const float b1 = __uint_as_float(Bhi[o + 8 * j + 4 * ldb]);
        bh0 = tf32_rna(b0);
        bh1 = tf32_rna(b1);
        bl0 = tf32_lo(b0, bh0);
        bl1 = tf32_lo(b1, bh1);
      } else {
        bh0 = Bhi[o + 8 * j];
        bh1 = Bhi[o + 8 * j + 4 * ldb];
        bl0 = Blo[o + 8 * j];
        bl1 = Blo[o + 8 * j + 4 * ldb];
      }
      mma_tf32(acc[j], al, bh0, bh1);
      mma_tf32(acc[j], ah, bl0, bl1);
      mma_tf32(acc[j], ah, bh0, bh1);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// The warp's accumulator tile into P ([row][n], stride ldp) at rows r0..
template <int NT>
__device__ __forceinline__ void store_acc(float* P, int ldp, int r0,
                                          const float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* d = P + (size_t)(r0 + g + 8 * hh) * ldp + 8 * j + 2 * t;
      d[0] = acc[j][2 * hh];
      d[1] = acc[j][2 * hh + 1];
    }
}

// z(r) - b at tile row r, channel co from P ([row][d C_out + co])
__device__ __forceinline__ float shift_sum(const float* P, int ldp, int r,
                                           int co, int cout, int h) {
  float z = P[(size_t)r * ldp + co];
  for (int d = 1; d <= h; ++d)
    z += P[(size_t)(r - d) * ldp + d * cout + co] +
         P[(size_t)(r + d) * ldp + d * cout + co];
  return z;
}

// Element j of a thread's share of the stacked taps' stage rows k0.. (B of
// the forward, CV_KC x NP): B[k][d C_out + co] = W[d C_in + k][co] from
// the row-major W ((h+1) C_in, C_out); 0 past C_in and (h+1) C_out.
template <int NT>
__device__ __forceinline__ float tap_at(const float* W, int cin, int cout,
                                        int h, int k0, int j) {
  constexpr int NP = CvDims<NT>::NP;
  const int idx = threadIdx.x + CV_THREADS * j;
  const int k = k0 + idx / NP, n = idx % NP;
  if (k >= cin || n >= (h + 1) * cout) return 0.f;
  const int d = n / cout;
  return W[((size_t)d * cin + k) * cout + (n - d * cout)];
}

// Stores a thread's NT values of a B stage (as tap_at numbers them), split.
template <int NT>
__device__ __forceinline__ void put_b(uint32_t* Bs, const float (&rb)[NT]) {
  constexpr int NP = CvDims<NT>::NP, LDB = CvDims<NT>::LDB;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int idx = threadIdx.x + CV_THREADS * j;
    put_split(Bs, Bs + CV_KC * LDB, (idx / NP) * LDB + idx % NP, rb[j]);
  }
}

// The forward's product over a tile of CV_ROWS rows, the inner depth
// (C_in) streamed in CV_KC-deep stages, double-buffered: stage c + 1's A
// (a 16-value share a thread: row idx >> 5, column idx & 31, of
// idx = threadIdx.x + CV_THREADS j) and B (tap_at's NT values) are read into
// registers by fetch_a / fetch_b while stage c's products run, then stored
// into the other buffer (A raw, B split).  As holds two A stages
// (CV_ROWS x CV_LDA), Bs two B stages.  Ends after a __syncthreads, so the
// caller may reuse both.
template <int NT, class FA, class FB>
__device__ __forceinline__ void gemm_stream(float (&acc)[NT][4], float* As,
                                            uint32_t* Bs, int K, FA fetch_a,
                                            FB fetch_b) {
  constexpr int BSTAGE = CvDims<NT>::BSTAGE, LDB = CvDims<NT>::LDB;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int nch = (K + CV_KC - 1) / CV_KC;
  float ra[16], rb[NT];
  fetch_a(0, ra);
  fetch_b(0, rb);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int idx = threadIdx.x + CV_THREADS * j;
    As[(idx >> 5) * CV_LDA + (idx & 31)] = ra[j];
  }
  put_b<NT>(Bs, rb);
  __syncthreads();
  for (int c = 0; c < nch; ++c) {
    const int cur = c & 1;
    const bool more = c + 1 < nch;
    if (more) {
      fetch_a(c + 1, ra);
      fetch_b(c + 1, rb);
    }
    const uint32_t* B = Bs + cur * BSTAGE;
    warp_mma<NT, false>(acc, As + cur * CV_ROWS * CV_LDA, CV_LDA, r0, B,
                        B + CV_KC * LDB, LDB,
                        (min(CV_KC, K - c * CV_KC) + 7) / 8);
    if (more) {
      float* An = As + (cur ^ 1) * CV_ROWS * CV_LDA;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int idx = threadIdx.x + CV_THREADS * j;
        An[(idx >> 5) * CV_LDA + (idx & 31)] = ra[j];
      }
      put_b<NT>(Bs + (cur ^ 1) * BSTAGE, rb);
    }
    __syncthreads();
  }
}

// Shared-memory words of gemm_stream's buffers
template <int NT>
constexpr int stream_words() {
  return 2 * CV_ROWS * CV_LDA + 2 * CvDims<NT>::BSTAGE;
}

// The bfloat16 window product of K1's and K8's bfloat16 variants
// (conv1d_chain.cu, conv1d_train.cu): one mma.sync m16n8k16 a 16-deep
// step, the pairs summed and rounded in bfloat16 on the input side.
// acc (NT 8-column tiles of the warp's 16 rows r0 ..) += the (h+1) tap
// products of layer input A (bfloat16, row stride lda, cin wide, 0 from
// cin to cin rounded to 16) against the packed taps Wt: tap d's rows are
// the pair sums A(r - d) + A(r + d), rounded to bfloat16 (tap 0: A(r)).
template <int NT>
__device__ __forceinline__ void cb_taps(float (&acc)[NT][4],
                                        const unsigned short* A, int lda,
                                        int r0, const uint32_t* Wt, int kp,
                                        int ldn, int cin, int h, int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ksteps = (cin + 15) >> 4;
  for (int d = 0; d <= h; ++d) {
    const uint32_t* Wd = Wt + (size_t)d * kp * ldn;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int c = ks * 16 + 2 * t;
      uint32_t a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e & 1) * 8, col = c + (e >> 1) * 8;
        if (d == 0) {
          a[e] = *reinterpret_cast<const uint32_t*>(A + r * lda + col);
        } else {
          const int rm = r - d, rp = r + d;
          const uint32_t um =
              rm >= 0 ? *reinterpret_cast<const uint32_t*>(A + rm * lda + col)
                      : 0u;
          const uint32_t up = rp < CV_ROWS ? *reinterpret_cast<const uint32_t*>(
                                                 A + rp * lda + col)
                                           : 0u;
          a[e] = pack_bf16(
              __uint_as_float(um << 16) + __uint_as_float(up << 16),
              __uint_as_float(um & 0xffff0000u) +
                  __uint_as_float(up & 0xffff0000u));
        }
      }
      const uint32_t* wb = Wd + (size_t)(ks * 8 + t) * ldn + g;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) mma_bf16(acc[j], a, wb[8 * j], wb[4 * ldn + 8 * j]);
    }
  }
}

// ---- the bfloat16 streamed-input routines of K1-bf16 (conv1d_chain.cu)
// and K8-bf16's forward (conv1d_train.cu) ----

#define CB_KC 64  // columns of an input chunk (ops/conv1d_chain.py CHUNK_BF16)
#define CB_LDK (CB_KC + 8)  // a chunk's row stride in halves (4 mod 32 words)

// n16 16-byte words from src (device) to dst (shared), cp.async, one group
__device__ __forceinline__ void cb_copy(uint32_t* dst, const uint32_t* src,
                                        int n16) {
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

// two bfloat16 pairs (raw bits) added and rounded to nearest even: one
// rounding of the exact sum, the bits of an f32 add rounded to bfloat16
// (the f32 sum of two bfloat16 values is exact unless their exponents lie
// more than 16 apart, and then both give the larger)
__device__ __forceinline__ uint32_t cb_add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// cb_taps (above) for a tile of ROWS rows, the pairs summed by
// cb_add2: acc (NT 8-column tiles of the warp's 16 rows r0 ..) += the (h+1)
// tap products of A (bfloat16, row stride lda, 0 from cin to cin rounded
// to 16) against the packed taps Wt; tap d's rows are the pairs
// A(r - d) + A(r + d) (0 outside the tile), tap 0's A(r).  Taps in order,
// 16-deep steps in order within a tap.
template <int NT, int ROWS>
__device__ __forceinline__ void cb1_taps(float (&acc)[NT][4],
                                         const unsigned short* A, int lda,
                                         int r0, const uint32_t* Wt, int kp,
                                         int ldn, int cin, int h, int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ksteps = (cin + 15) >> 4;
  for (int d = 0; d <= h; ++d) {
    const uint32_t* Wd = Wt + (size_t)d * kp * ldn;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int c = ks * 16 + 2 * t;
      uint32_t a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e & 1) * 8, col = c + (e >> 1) * 8;
        if (d == 0) {
          a[e] = *reinterpret_cast<const uint32_t*>(A + r * lda + col);
        } else {
          const int rm = r - d, rp = r + d;
          const uint32_t um =
              rm >= 0 ? *reinterpret_cast<const uint32_t*>(A + rm * lda + col)
                      : 0u;
          const uint32_t up = rp < ROWS ? *reinterpret_cast<const uint32_t*>(
                                              A + rp * lda + col)
                                        : 0u;
          a[e] = cb_add2(um, up);
        }
      }
      const uint32_t* wb = Wd + (size_t)(ks * 8 + t) * ldn + g;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) mma_bf16(acc[j], a, wb[8 * j], wb[4 * ldn + 8 * j]);
    }
  }
}

// a cp.async of `bytes` (4, 8 or 16), filling zeros where !ok
template <int BYTES>
__device__ __forceinline__ void cb_cp_zfill(void* dst, const void* src,
                                            bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n));
}

// Chunk k0 .. k0 + CB_KC - 1 of the tile's ROWS input rows (slots base ..)
// of x (TP: bfloat16 bits or float; rows c0 wide) into stage S (row
// stride LDR elements) in copies of `unit` elements (unit divides c0, and
// the rows' addresses allow it; a 2-byte unit: plain loads); 0 outside
// [0, n_exp) and past c0.  A thread keeps one column and steps over the
// rows.
template <int ROWS, class TP = unsigned short, int LDR = CB_LDK>
__device__ __forceinline__ void cb_issue(TP* S, const TP* xb, int base,
                                         int n_exp, int c0, int k0,
                                         int unit) {
  const int nu = CB_KC / unit, step = 2 * ROWS / nu;
  const int r0 = threadIdx.x / nu, col = k0 + (threadIdx.x - r0 * nu) * unit;
  const bool col_ok = col < c0;
  for (int r = r0; r < ROWS; r += step) {
    const int gs = base + r;
    const bool ok = col_ok && gs >= 0 && gs < n_exp;
    const TP* src = xb + (ok ? (long long)gs * c0 + col : 0);
    TP* dst = S + r * LDR + (col - k0);
    switch (unit * (int)sizeof(TP)) {
      case 16: cb_cp_zfill<16>(dst, src, ok); break;
      case 8: cb_cp_zfill<8>(dst, src, ok); break;
      case 4: cb_cp_zfill<4>(dst, src, ok); break;
      default: *dst = ok ? __ldg(src) : (TP)0;
    }
  }
}

// cp.async.wait_group stages - 2: every chunk but the last stages - 2
// issued has landed
__device__ __forceinline__ void cb_wait_ring(int stages) {
  switch (stages) {
    case 2: cp_async_wait<0>(); break;
    case 3: cp_async_wait<1>(); break;
    case 4: cp_async_wait<2>(); break;
    case 5: cp_async_wait<3>(); break;
    default: cp_async_wait<4>();
  }
}
