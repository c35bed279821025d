// K11: the mesh z-buffer rasterizer of the offline scanning simulator.
//
// Replaces no pl.pallas_call: it is the port of the JAX package's native
// C++ kernel, curvecloudnet_tpu/simulator/native/rasterizer.cpp
// (rasterize_mesh), a serial z-buffer the JAX package runs on the host.
// The upstream CurveCloudNet rasterized on the GPU (its
// minimal_pytorch_rasterizer), and the port's generator rasterizes on the
// card, so the stage gets a kernel of its own.
//
// Contract: bit for bit what rasterize_mesh gives.  Over an h x w pinhole
// image of a camera-space mesh, the mask, the camera-space surface point
// and the face normal (turned toward -z) of the face that the serial loop
// leaves in each pixel.  That loop visits faces in order and writes a
// pixel where a strict z < depth holds, depth starting at +inf, so the
// winner is the least z in float order, then the least face index, and a
// candidate whose z is +inf or NaN never writes.  Faces are skipped as the
// loop skips them: an index >= n_verts (or, here, < 0, which the loop
// reads out of bounds), a vertex at z <= 1e-6, a normal shorter than
// 1e-12, an empty clamped bounding box, |det| < 1e-12.  Pixel centres at
// +0.5, edges kept at l >= -1e-6, interpolation perspective-correct
// through 1/z.
//
// Design (simple and right first):
//   * face pass: a thread a face does the skips and the projection and
//     stores the face's table row (projected corners, 1/det, 1/z of the
//     corners, the normal, the corners, the clamped bounding box);
//   * depth pass: a block a face, its threads striding over the face's
//     bounding-box pixels; each covered pixel takes an atomicMin on a
//     64-bit key: the order-preserving map of z's bits in the high word
//     (so negative z orders right; -0 is made +0, which '<' treats as
//     equal) and the face index in the low word, the buffer set to all
//     ones first;
//   * resolve pass: a thread a pixel recomputes its winner's barycentrics,
//     z and weights from the face table and writes coords, normals, mask.
// Bit-equality needs the C++ operation order without FMA contraction (nvcc
// contracts a*b+c by default and the shared NVCC_FLAGS stay as they are),
// so every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn).  The C++ takes
// (int)std::floor(v), which x86-64 turns into INT_MIN for NaN and values
// past the int range where CUDA's conversion saturates; floor_int and
// ceil_int give the x86 result.
//
// Bound on the H100: bytes.  The outputs, h * w * (12 + 12 + 1), and the
// key buffer's write and read, 2 * 8 * h * w, dwarf the mesh.

#include <climits>
#include <cuda_runtime.h>

namespace {

struct Face {
  float ax, ay, bx, by, cx, cy;  // projected corners
  float inv_det, iza, izb, izc;  // 1 / det, 1 / z of each corner
  float n[3];                    // unit normal, toward -z
  float A[3], B[3], C[3];        // camera-space corners
  int x0, x1, y0, y1;            // clamped bounding box; x0 > x1: skipped
};
static_assert(sizeof(Face) == 26 * 4, "the wrapper sizes the table so");

constexpr unsigned long long EMPTY = ~0ull;

__device__ __forceinline__ int x86_int(float v) {
  return (v != v || v >= 2147483648.0f || v < -2147483648.0f) ? INT_MIN
                                                              : (int)v;
}

__device__ __forceinline__ void bary(const Face& t, int x, int y, float& l0,
                                     float& l1, float& l2) {
  const float px = __fadd_rn(__int2float_rn(x), 0.5f);
  const float py = __fadd_rn(__int2float_rn(y), 0.5f);
  const float dx = __fsub_rn(px, t.cx), dy = __fsub_rn(py, t.cy);
  l0 = __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(t.by, t.cy), dx),
                           __fmul_rn(__fsub_rn(t.cx, t.bx), dy)),
                 t.inv_det);
  l1 = __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(t.cy, t.ay), dx),
                           __fmul_rn(__fsub_rn(t.ax, t.cx), dy)),
                 t.inv_det);
  l2 = __fsub_rn(__fsub_rn(1.0f, l0), l1);
}

__device__ __forceinline__ float depth(const Face& t, float l0, float l1,
                                       float l2) {
  const float iz = __fadd_rn(__fadd_rn(__fmul_rn(l0, t.iza),
                                       __fmul_rn(l1, t.izb)),
                             __fmul_rn(l2, t.izc));
  return __fdiv_rn(1.0f, iz);
}

__device__ __forceinline__ float proj(float f, float u, float z, float c) {
  return __fadd_rn(__fdiv_rn(__fmul_rn(f, u), z), c);
}

__global__ void rast_faces(const float* __restrict__ verts,
                           long long n_verts, const int* __restrict__ faces,
                           long long n_faces, float fx, float fy, float cx,
                           float cy, int h, int w, Face* __restrict__ table) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_faces) return;
  Face t;
  t.x0 = 1;
  t.x1 = 0;
  t.y0 = 1;
  t.y1 = 0;
  const int ia = faces[f * 3], ib = faces[f * 3 + 1], ic = faces[f * 3 + 2];
  if (ia < 0 || ib < 0 || ic < 0 || ia >= n_verts || ib >= n_verts ||
      ic >= n_verts) {
    table[f] = t;
    return;
  }
  for (int d = 0; d < 3; ++d) {
    t.A[d] = verts[(long long)ia * 3 + d];
    t.B[d] = verts[(long long)ib * 3 + d];
    t.C[d] = verts[(long long)ic * 3 + d];
  }
  const float *A = t.A, *B = t.B, *C = t.C;
  if (A[2] <= 1e-6f || B[2] <= 1e-6f || C[2] <= 1e-6f) {
    table[f] = t;
    return;
  }
  const float e1[3] = {__fsub_rn(B[0], A[0]), __fsub_rn(B[1], A[1]),
                       __fsub_rn(B[2], A[2])};
  const float e2[3] = {__fsub_rn(C[0], A[0]), __fsub_rn(C[1], A[1]),
                       __fsub_rn(C[2], A[2])};
  float n0 = __fsub_rn(__fmul_rn(e1[1], e2[2]), __fmul_rn(e1[2], e2[1]));
  float n1 = __fsub_rn(__fmul_rn(e1[2], e2[0]), __fmul_rn(e1[0], e2[2]));
  float n2 = __fsub_rn(__fmul_rn(e1[0], e2[1]), __fmul_rn(e1[1], e2[0]));
  const float nl = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(n0, n0), __fmul_rn(n1, n1)), __fmul_rn(n2, n2)));
  if (nl < 1e-12f) {
    table[f] = t;
    return;
  }
  n0 = __fdiv_rn(n0, nl);
  n1 = __fdiv_rn(n1, nl);
  n2 = __fdiv_rn(n2, nl);
  if (n2 > 0) {
    n0 = -n0;
    n1 = -n1;
    n2 = -n2;
  }
  t.n[0] = n0;
  t.n[1] = n1;
  t.n[2] = n2;
  t.ax = proj(fx, A[0], A[2], cx);
  t.ay = proj(fy, A[1], A[2], cy);
  t.bx = proj(fx, B[0], B[2], cx);
  t.by = proj(fy, B[1], B[2], cy);
  t.cx = proj(fx, C[0], C[2], cx);
  t.cy = proj(fy, C[1], C[2], cy);
  int x0 = x86_int(floorf(fminf(t.ax, fminf(t.bx, t.cx))));
  int x1 = x86_int(ceilf(fmaxf(t.ax, fmaxf(t.bx, t.cx))));
  int y0 = x86_int(floorf(fminf(t.ay, fminf(t.by, t.cy))));
  int y1 = x86_int(ceilf(fmaxf(t.ay, fmaxf(t.by, t.cy))));
  if (x0 < 0) x0 = 0;
  if (y0 < 0) y0 = 0;
  if (x1 >= w) x1 = w - 1;
  if (y1 >= h) y1 = h - 1;
  if (x0 > x1 || y0 > y1) {
    table[f] = t;
    return;
  }
  const float det =
      __fadd_rn(__fmul_rn(__fsub_rn(t.by, t.cy), __fsub_rn(t.ax, t.cx)),
                __fmul_rn(__fsub_rn(t.cx, t.bx), __fsub_rn(t.ay, t.cy)));
  if (fabsf(det) < 1e-12f) {
    table[f] = t;
    return;
  }
  t.inv_det = __fdiv_rn(1.0f, det);
  t.iza = __fdiv_rn(1.0f, A[2]);
  t.izb = __fdiv_rn(1.0f, B[2]);
  t.izc = __fdiv_rn(1.0f, C[2]);
  t.x0 = x0;
  t.x1 = x1;
  t.y0 = y0;
  t.y1 = y1;
  table[f] = t;
}

__global__ void rast_depth(const Face* __restrict__ table, int w,
                           unsigned long long* __restrict__ keys) {
  __shared__ Face s;
  if (threadIdx.x == 0) s = table[blockIdx.x];
  __syncthreads();
  const Face t = s;
  if (t.x0 > t.x1) return;
  const int bw = t.x1 - t.x0 + 1;
  const long long n = (long long)bw * (t.y1 - t.y0 + 1);
  for (long long p = threadIdx.x; p < n; p += blockDim.x) {
    const int x = t.x0 + (int)(p % bw), y = t.y0 + (int)(p / bw);
    float l0, l1, l2;
    bary(t, x, y, l0, l1, l2);
    if (l0 < -1e-6f || l1 < -1e-6f || l2 < -1e-6f) continue;
    float z = depth(t, l0, l1, l2);
    if (!(z < __int_as_float(0x7f800000))) continue;  // +inf, NaN
    if (z == 0.0f) z = 0.0f;                           // -0 ties +0
    unsigned u = __float_as_uint(z);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    atomicMin(keys + (long long)y * w + x,
              ((unsigned long long)u << 32) | blockIdx.x);
  }
}

__global__ void rast_resolve(const Face* __restrict__ table,
                             const unsigned long long* __restrict__ keys,
                             long long hw, int w, float* __restrict__ coords,
                             float* __restrict__ normals,
                             unsigned char* __restrict__ mask) {
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const unsigned long long key = keys[pix];
  float c[3] = {0.0f, 0.0f, 0.0f}, n[3] = {0.0f, 0.0f, 0.0f};
  unsigned char m = 0;
  if (key != EMPTY) {
    const Face t = table[key & 0xffffffffull];
    float l0, l1, l2;
    bary(t, (int)(pix % w), (int)(pix / w), l0, l1, l2);
    const float z = depth(t, l0, l1, l2);
    const float w0 = __fmul_rn(__fmul_rn(l0, t.iza), z);
    const float w1 = __fmul_rn(__fmul_rn(l1, t.izb), z);
    const float w2 = __fmul_rn(__fmul_rn(l2, t.izc), z);
    for (int d = 0; d < 3; ++d) {
      c[d] = __fadd_rn(__fadd_rn(__fmul_rn(w0, t.A[d]), __fmul_rn(w1, t.B[d])),
                       __fmul_rn(w2, t.C[d]));
      n[d] = t.n[d];
    }
    m = 1;
  }
  for (int d = 0; d < 3; ++d) {
    coords[pix * 3 + d] = c[d];
    normals[pix * 3 + d] = n[d];
  }
  mask[pix] = m;
}

}  // namespace

// verts (n_verts, 3) f32, faces (n_faces, 3) int32, the pinhole, the image
// size; scratch: table (n_faces Face rows), keys (h * w u64); out: coords
// and normals (h, w, 3) f32, mask (h, w) bool.  Three launches on stream.
extern "C" int ccn_rasterize(const float* verts, long long n_verts,
                             const int* faces, long long n_faces, float fx,
                             float fy, float cx, float cy, int h, int w,
                             void* table, unsigned long long* keys,
                             float* coords, float* normals,
                             unsigned char* mask, void* stream) {
  if (h < 1 || w < 1 || n_verts < 0 || n_faces < 0 || n_faces > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long hw = (long long)h * w;
  cudaError_t e = cudaMemsetAsync(keys, 0xff, hw * sizeof(*keys), st);
  if (e != cudaSuccess) return (int)e;
  Face* t = (Face*)table;
  if (n_faces > 0) {
    rast_faces<<<(unsigned)((n_faces + 255) / 256), 256, 0, st>>>(
        verts, n_verts, faces, n_faces, fx, fy, cx, cy, h, w, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    rast_depth<<<(unsigned)n_faces, 256, 0, st>>>(t, w, keys);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rast_resolve<<<(unsigned)((hw + 255) / 256), 256, 0, st>>>(
      t, keys, hw, w, coords, normals, mask);
  return (int)cudaGetLastError();
}
