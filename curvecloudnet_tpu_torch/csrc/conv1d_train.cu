// K8: the conv1d-fast-v2 train chain over gap-expanded rows, forward and
// backward, with exact masked BatchNorm batch statistics.
//
// Replaces curvecloudnet_tpu/ops/pallas_conv1d.py: _run_fwd_layer
// (_fwd_layer_kernel, pallas_call at :407), _run_bwd_reduce
// (_bwd_reduce_kernel, :431) and _run_bwd_t (_bwd_t_kernel, :477), which
// conv1d_chain_train's custom VJP drives.  One C entry runs one pass over
// the whole batch; ops/conv1d_train.py sequences them.  Per layer, with
// m(q) = [q < used] and u = 0 outside [0, n_exp):
//     z(q)  = u(q) W_0 + sum_{d=1..h} (u(q-d) + u(q+d)) W_d + b
//     u'(q) = leaky(BN(z(q))) * m(q)
// backward, with dz = inv * (dxh - m * (c1 + xhat * c2)):
//     d_u_prev(q) = dz(q) W_0^T + sum_d (dz(q-d) + dz(q+d)) W_d^T
//     dW_d = sum_p (u(p-d) + u(p+d))^T dz(p)   (u(p)^T dz(p) for d = 0)
//
// Design: one block takes a tile of rows of one sample plus an h-row halo on
// each side in shared memory (not the TPU's whole neighbouring tiles).  The
// forward and the t pass rebuild the layer input u from the previous
// layer's pre-BN z as they load it (BN affine, leaky, tail mask), so u never
// reaches device memory, as in the Pallas kernels.  What the TPU carries
// across its sequential grid in accumulator outputs (s1, s2; the four
// reduce sums; dW and db) is written here as one partial per block and
// summed by a second kernel in a fixed order: no atomics, so a step's
// gradients do not depend on the order blocks ran (train BatchNorm over the
// flagship's 33 steps amplifies rounding ~1000x).  The statistics combine
// per-block (count, mean, M2) with Chan's formula: the mean and biased
// variance of the two-pass plain version, without the cancellation of the
// JAX kernel's one-pass E[z^2] - mean^2.  The BN affine and the BN backward
// round each operation once (explicit _rn intrinsics), as the plain
// version's elementwise ops do, so the kink decisions y >= 0 of the forward
// and of both backward passes agree with each other and with it.
//
// Bound on the H100: FP32 FMAs of the window products (the flagship's
// step_31 first layer: 49164 slots x 786 x 32, ~2.5 GFLOP forward, twice that
// in the t pass) and the bytes of the 262-wide input row.  No tensor cores
// yet (FP32 FMA, so results stay within f32 rounding of the plain version).

#include <cuda_runtime.h>

#define CT_THREADS 256

__device__ __forceinline__ float leaky(float y) {
  return y >= 0.f ? y : __fmul_rn(0.01f, y);
}

__device__ __forceinline__ float dleaky(float y) {
  return y >= 0.f ? 1.f : 0.01f;
}

// y = xhat * gamma + beta with xhat = (z - mean) * inv; bn holds
// (mean, inv, gamma, beta) of C channels
__device__ __forceinline__ float bn_y(float z, const float* bn, int c, int C,
                                      float* xhat) {
  const float xh = __fmul_rn(__fsub_rn(z, bn[c]), bn[C + c]);
  *xhat = xh;
  return __fadd_rn(__fmul_rn(xh, bn[2 * C + c]), bn[3 * C + c]);
}

// the layer input u at slot g, channel c of one sample's rows src (C wide):
// src itself when bn is null (xe), else leaky(BN(src)) * m(g)
__device__ __forceinline__ float u_at(const float* src, const float* bn,
                                      int g, int c, int C, int n_exp,
                                      int live_end) {
  if (g < 0 || g >= n_exp) return 0.f;
  const float v = src[(size_t)g * C + c];
  if (bn == nullptr) return v;
  float xh;
  const float y = bn_y(v, bn, c, C, &xh);
  return g < live_end ? leaky(y) : 0.f;
}

// dz at slot g, channel c; coef holds (mean, inv, gamma, beta, c1, c2)
__device__ __forceinline__ float dz_at(const float* du, const float* z,
                                       const float* coef, size_t off, int c,
                                       int C) {
  float xh;
  const float y = bn_y(z[off], coef, c, C, &xh);
  const float dxh = __fmul_rn(__fmul_rn(du[off], dleaky(y)), coef[2 * C + c]);
  const float t = __fadd_rn(coef[4 * C + c], __fmul_rn(xh, coef[5 * C + c]));
  return __fmul_rn(coef[C + c], __fsub_rn(dxh, t));
}

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s pairwise combination of (count, mean, M2)
__device__ __forceinline__ Moments chan(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// forward: z of a tile and the tile's (count, mean, M2) per channel
__global__ void conv1d_train_fwd_kernel(
    const float* __restrict__ zp, const float* __restrict__ bnp,
    const float* __restrict__ w, const float* __restrict__ bias,
    const int* __restrict__ used, float* __restrict__ z,
    float* __restrict__ parts, int n_exp, int cin, int cout, int h, int tile) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int rows = tile + 2 * h;
  float* u = smem;                        // rows x cin, slot t0 - h + r
  float* zt = smem + (size_t)rows * cin;  // tile x cout
  const int live_end = min(used[b], n_exp);
  const float* src = zp + (size_t)b * n_exp * cin;
  for (int i = threadIdx.x; i < rows * cin; i += blockDim.x) {
    const int r = i / cin, c = i - r * cin;
    u[i] = u_at(src, bnp, t0 - h + r, c, cin, n_exp, live_end);
  }
  __syncthreads();
  // thread per (row, output channel), the channel fastest: weight reads
  // coalesce, u reads broadcast
  for (int i = threadIdx.x; i < tile * cout; i += blockDim.x) {
    const int r = i / cout, co = i - r * cout;
    const float* ctr = u + (size_t)(r + h) * cin;
    float acc = 0.f;
    for (int ci = 0; ci < cin; ++ci)
      acc = fmaf(ctr[ci], w[(size_t)ci * cout + co], acc);
    for (int d = 1; d <= h; ++d) {
      const float* lo = ctr - (size_t)d * cin;
      const float* hi = ctr + (size_t)d * cin;
      const float* wd = w + (size_t)d * cin * cout;
      for (int ci = 0; ci < cin; ++ci)
        acc = fmaf(lo[ci] + hi[ci], wd[(size_t)ci * cout + co], acc);
    }
    acc += bias[co];
    zt[i] = acc;
    const int g = t0 + r;
    if (g < n_exp) z[((size_t)b * n_exp + g) * cout + co] = acc;
  }
  __syncthreads();
  const int cnt = max(0, min(t0 + tile, live_end) - t0);
  float* part = parts + ((size_t)b * gridDim.x + blockIdx.x) * (2 * cout + 1);
  for (int co = threadIdx.x; co < cout; co += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < cnt; ++r) s += zt[(size_t)r * cout + co];
    const float mean = cnt ? s / (float)cnt : 0.f;
    float m2 = 0.f;
    for (int r = 0; r < cnt; ++r) {
      const float d = zt[(size_t)r * cout + co] - mean;
      m2 = fmaf(d, d, m2);
    }
    part[1 + co] = mean;
    part[1 + cout + co] = m2;
  }
  if (threadIdx.x == 0) part[0] = (float)cnt;
}

// one block per channel: the P tile partials combined in a fixed order
__global__ void conv1d_train_moments_kernel(const float* __restrict__ parts,
                                            int P, int cout,
                                            float* __restrict__ mean,
                                            float* __restrict__ var) {
  __shared__ float sn[CT_THREADS], sm[CT_THREADS], s2[CT_THREADS];
  const int co = blockIdx.x, t = threadIdx.x;
  Moments acc = {0.f, 0.f, 0.f};
  for (int p = t; p < P; p += blockDim.x) {
    const float* row = parts + (size_t)p * (2 * cout + 1);
    acc = chan(acc, {row[0], row[1 + co], row[1 + cout + co]});
  }
  sn[t] = acc.n;
  sm[t] = acc.mean;
  s2[t] = acc.m2;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) {
      const Moments m = chan({sn[t], sm[t], s2[t]},
                             {sn[t + s], sm[t + s], s2[t + s]});
      sn[t] = m.n;
      sm[t] = m.mean;
      s2[t] = m.m2;
    }
    __syncthreads();
  }
  if (t == 0) {
    mean[co] = sm[0];
    var[co] = sn[0] > 0.f ? fmaxf(s2[0] / sn[0], 0.f) : 0.f;
  }
}

// reduce: the tile's live-slot sums of dxh, dxh * xhat, da, da * xhat
// (block 32 x 8: channel lanes x row lanes)
__global__ void conv1d_train_reduce_kernel(
    const float* __restrict__ du, const float* __restrict__ z,
    const float* __restrict__ bn, const int* __restrict__ used,
    float* __restrict__ parts, int n_exp, int C, int tile) {
  __shared__ float red[4][8][32];
  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r_end = min(t0 + tile, min(used[b], n_exp));
  float* part = parts + ((size_t)b * gridDim.x + blockIdx.x) * 4 * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + tx;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if (c < C) {
      for (int g = t0 + ty; g < r_end; g += 8) {
        const size_t off = ((size_t)b * n_exp + g) * C + c;
        float xh;
        const float y = bn_y(z[off], bn, c, C, &xh);
        const float da = __fmul_rn(du[off], dleaky(y));
        const float dxh = __fmul_rn(da, bn[2 * C + c]);
        a0 += dxh;
        a1 = fmaf(dxh, xh, a1);
        a2 += da;
        a3 = fmaf(da, xh, a3);
      }
    }
    red[0][ty][tx] = a0;
    red[1][ty][tx] = a1;
    red[2][ty][tx] = a2;
    red[3][ty][tx] = a3;
    __syncthreads();
    if (ty < 4 && c < C) {
      float s = 0.f;
      for (int k = 0; k < 8; ++k) s += red[ty][k][tx];
      part[(size_t)ty * C + c] = s;
    }
    __syncthreads();
  }
}

// column sums of P partial rows of width W, in a fixed order (block 32 x 8)
__global__ void conv1d_train_colsum_kernel(const float* __restrict__ parts,
                                           int P, int W,
                                           float* __restrict__ out) {
  __shared__ float red[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < W)
    for (int p = threadIdx.y; p < P; p += 8) s += parts[(size_t)p * W + col];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < W) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += red[k][threadIdx.x];
    out[col] = t;
  }
}

// t: dz over the tile and its halo, d_u_prev of the tile, and the tile's
// partial dW (row blocks d = 0..h) and db
__global__ void conv1d_train_t_kernel(
    const float* __restrict__ du, const float* __restrict__ z,
    const float* __restrict__ zp, const float* __restrict__ coef,
    const float* __restrict__ bnp, const float* __restrict__ wt,
    const int* __restrict__ used, float* __restrict__ dup,
    float* __restrict__ parts, int n_exp, int cin, int cout, int h,
    int tile) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int rows = tile + 2 * h;
  float* dz = smem;                        // rows x cout, slot t0 - h + r
  float* u = smem + (size_t)rows * cout;   // rows x cin, the layer input
  const int live_end = min(used[b], n_exp);
  for (int i = threadIdx.x; i < rows * cout; i += blockDim.x) {
    const int r = i / cout, co = i - r * cout;
    const int g = t0 - h + r;
    // dead and outside slots: da = 0 and m = 0, so dz = 0
    dz[i] = (g >= 0 && g < live_end)
                ? dz_at(du, z, coef, ((size_t)b * n_exp + g) * cout + co, co,
                        cout)
                : 0.f;
  }
  const float* src = zp + (size_t)b * n_exp * cin;
  for (int i = threadIdx.x; i < rows * cin; i += blockDim.x) {
    const int r = i / cin, c = i - r * cin;
    u[i] = u_at(src, bnp, t0 - h + r, c, cin, n_exp, live_end);
  }
  __syncthreads();
  const int r_end = min(tile, n_exp - t0);
  // d_u_prev: thread per (row, input channel); wt is (h+1, cout, cin)
  for (int i = threadIdx.x; i < r_end * cin; i += blockDim.x) {
    const int r = i / cin, ci = i - r * cin;
    const float* ctr = dz + (size_t)(r + h) * cout;
    float acc = 0.f;
    for (int co = 0; co < cout; ++co)
      acc = fmaf(ctr[co], wt[(size_t)co * cin + ci], acc);
    for (int d = 1; d <= h; ++d) {
      const float* lo = ctr - (size_t)d * cout;
      const float* hi = ctr + (size_t)d * cout;
      const float* wd = wt + (size_t)d * cout * cin;
      for (int co = 0; co < cout; ++co)
        acc = fmaf(lo[co] + hi[co], wd[(size_t)co * cin + ci], acc);
    }
    dup[((size_t)b * n_exp + t0 + r) * cin + ci] = acc;
  }
  // dW: thread per weight (d, ci, co), the output channel fastest
  const int n_dw = (h + 1) * cin * cout;
  float* part = parts + ((size_t)b * gridDim.x + blockIdx.x) * (n_dw + cout);
  for (int o = threadIdx.x; o < n_dw; o += blockDim.x) {
    const int d = o / (cin * cout);
    const int rem = o - d * cin * cout;
    const int ci = rem / cout, co = rem - ci * cout;
    float acc = 0.f;
    if (d == 0) {
      for (int r = 0; r < r_end; ++r)
        acc = fmaf(u[(size_t)(r + h) * cin + ci], dz[(size_t)(r + h) * cout + co],
                   acc);
    } else {
      for (int r = 0; r < r_end; ++r)
        acc = fmaf(u[(size_t)(r + h - d) * cin + ci] +
                       u[(size_t)(r + h + d) * cin + ci],
                   dz[(size_t)(r + h) * cout + co], acc);
    }
    part[o] = acc;
  }
  for (int co = threadIdx.x; co < cout; co += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < r_end; ++r) s += dz[(size_t)(r + h) * cout + co];
    part[n_dw + co] = s;
  }
}

static int colsum(const float* parts, int P, int W, float* out,
                  cudaStream_t s) {
  conv1d_train_colsum_kernel<<<(W + 31) / 32, dim3(32, 8), 0, s>>>(parts, P,
                                                                    W, out);
  return (int)cudaGetLastError();
}

// z_prev (B, n_exp, cin) f32; bnp the previous layer's (mean, inv, gamma,
// beta) (4 cin) or null on layer 1; w ((h+1) cin, cout); bias (cout);
// used (B,) int32 -> z (B, n_exp, cout), mean, var (cout); parts is
// scratch of B * ceil(n_exp / tile) rows of 2 cout + 1 floats.
extern "C" int ccn_conv1d_train_fwd(const float* zp, const float* bnp,
                                    const float* w, const float* bias,
                                    const int* used, float* z, float* parts,
                                    float* mean, float* var, int B, int n_exp,
                                    int cin, int cout, int h, int tile,
                                    void* stream) {
  if (B < 1 || n_exp < 1 || cin < 1 || cout < 1 || h < 0 || tile < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)(tile + 2 * h) * cin + (size_t)tile * cout) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((n_exp + tile - 1) / tile, B);
  conv1d_train_fwd_kernel<<<grid, CT_THREADS, smem, s>>>(
      zp, bnp, w, bias, used, z, parts, n_exp, cin, cout, h, tile);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  conv1d_train_moments_kernel<<<cout, CT_THREADS, 0, s>>>(
      parts, (int)(grid.x * grid.y), cout, mean, var);
  return (int)cudaGetLastError();
}

// d_u, z (B, n_exp, C) f32; bn (mean, inv, gamma, beta) (4 C); used (B,)
// -> sums (4 C): dxh, dxh * xhat, da, da * xhat; parts is scratch of
// B * ceil(n_exp / tile) rows of 4 C floats.
extern "C" int ccn_conv1d_train_reduce(const float* du, const float* z,
                                       const float* bn, const int* used,
                                       float* parts, float* sums, int B,
                                       int n_exp, int C, int tile,
                                       void* stream) {
  if (B < 1 || n_exp < 1 || C < 1 || tile < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((n_exp + tile - 1) / tile, B);
  conv1d_train_reduce_kernel<<<grid, dim3(32, 8), 0, s>>>(du, z, bn, used,
                                                          parts, n_exp, C,
                                                          tile);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return colsum(parts, (int)(grid.x * grid.y), 4 * C, sums, s);
}

// d_u, z (B, n_exp, cout); z_prev (B, n_exp, cin) (xe on layer 1); coef
// (mean, inv, gamma, beta, c1, c2) of this layer (6 cout); bnp the previous
// layer's BN (4 cin) or null; wt (h+1, cout, cin) -> d_u_prev (B, n_exp,
// cin) and sums ((h+1) cin cout + cout): dW row-major ((h+1) cin, cout),
// then db; parts is scratch of B * ceil(n_exp / tile) rows of that width.
extern "C" int ccn_conv1d_train_t(const float* du, const float* z,
                                  const float* zp, const float* coef,
                                  const float* bnp, const float* wt,
                                  const int* used, float* dup, float* parts,
                                  float* sums, int B, int n_exp, int cin,
                                  int cout, int h, int tile, void* stream) {
  if (B < 1 || n_exp < 1 || cin < 1 || cout < 1 || h < 0 || tile < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(tile + 2 * h) * (cin + cout) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_train_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((n_exp + tile - 1) / tile, B);
  conv1d_train_t_kernel<<<grid, CT_THREADS, smem, s>>>(
      du, z, zp, coef, bnp, wt, used, dup, parts, n_exp, cin, cout, h, tile);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return colsum(parts, (int)(grid.x * grid.y), (h + 1) * cin * cout + cout,
                sums, s);
}
