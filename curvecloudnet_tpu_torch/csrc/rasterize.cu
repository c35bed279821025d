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
// through 1/z.  The (z, face) minimum is associative, so the order in
// which faces are visited does not change the winner.
//
// Design: screen tiles, the depth test and the resolve on chip.
//   * face pass (rast_faces): a thread a face does the skips and the
//     projection, stores the face's table row (projected corners, 1/det,
//     1/z of the corners, the normal, the corners) and its clamped
//     bounding box (x0, x1, y0, y1; 16 B, empty for a skipped face), and
//     each warp the union box of its 32 faces (a chunk box);
//   * tile pass (rast_tiles): a block a TILE x TILE screen tile keeps the
//     tile's 64-bit (z order, face) keys in shared memory.  In rounds of
//     ROUND_CHUNKS chunks, a warp tests 32 chunk boxes at once (a lane a
//     chunk), then the 32 face boxes of each chunk that meets the tile (a
//     lane a face), and a ballot and a shared counter append the faces
//     that meet it to the round's list; the warps then take the listed
//     faces in turn, the warp's lanes stepping over the face's box
//     clipped to the tile, and each covered pixel takes a shared 64-bit
//     atomicMin on its key: the order-preserving map of z's bits in the
//     high word (so negative z orders right; -0 is made +0, which '<'
//     treats as equal) and the face index in the low word.  A large face
//     is spread over every tile it touches, and no tile waits on faces far
//     from it.  Shared atomics, not pixels owned by threads: a thread
//     owning pixels would test every listed face against each of them
//     (a dense mesh lists hundreds of faces a tile), where the atomics
//     cost one operation a covered candidate and rarely collide;
//   * resolve, in the same block: a thread a pixel recomputes its
//     winner's barycentrics, z and weights from the face table, stages
//     coords, normals and mask for BAND rows in shared memory, and the
//     block writes them as whole lines (consecutive threads on
//     consecutive 16-byte words where the tile is whole).
// No key buffer in device memory, no memset, no global atomic, no host
// sync, and nothing sized from a count read back from the device.
// Bit-equality needs the C++ operation order without FMA contraction (nvcc
// contracts a*b+c by default and the shared NVCC_FLAGS stay as they are),
// so every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn).  The C++ takes
// (int)std::floor(v), which x86-64 turns into INT_MIN for NaN and values
// past the int range where CUDA's conversion saturates; x86_int gives the
// x86 result.
//
// Bound on the H100: bytes, the mesh read once and the outputs, h * w *
// (12 + 12 + 1), written once.

#include <climits>
#include <cuda_runtime.h>

namespace {

struct Face {
  float ax, ay, bx, by, cx, cy;  // projected corners
  float inv_det, iza, izb, izc;  // 1 / det, 1 / z of each corner
  float n[3];                    // unit normal, toward -z
  float A[3], B[3], C[3];        // camera-space corners
};
static_assert(sizeof(Face) == 22 * 4, "the wrapper sizes the table so");

constexpr unsigned long long EMPTY = ~0ull;
constexpr int CHUNK = 32;       // faces a chunk box covers (a warp)
constexpr int TILE = 64;        // a tile pass block's screen tile
constexpr int RT_THREADS = 256;
constexpr int RT_WARPS = RT_THREADS / 32;
constexpr int ROUND_CHUNKS = 32 * RT_WARPS;    // chunk boxes a round
constexpr int LIST_CAP = ROUND_CHUNKS * CHUNK;  // faces a round can list
constexpr int BAND = 16;        // rows the resolve stages at a time
static_assert(BAND * TILE * (6 * 4 + 1) <= LIST_CAP * 4,
              "the resolve's stage lies over the list");
// a box that meets no tile: (x0, x1, y0, y1)
__device__ __forceinline__ int4 no_box() {
  return make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
}

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

__device__ __forceinline__ bool meets(int4 b, int tx0, int tx1, int ty0,
                                      int ty1) {
  return b.x <= tx1 && b.y >= tx0 && b.z <= ty1 && b.w >= ty0;
}

// face f's table row -> its clamped box (no_box() for a skipped face)
__device__ int4 face_row(const float* __restrict__ verts, long long n_verts,
                         const int* __restrict__ faces, long long f, float fx,
                         float fy, float cx, float cy, int h, int w,
                         Face* __restrict__ table) {
  const int ia = faces[f * 3], ib = faces[f * 3 + 1], ic = faces[f * 3 + 2];
  if (ia < 0 || ib < 0 || ic < 0 || ia >= n_verts || ib >= n_verts ||
      ic >= n_verts)
    return no_box();
  Face t;
  for (int d = 0; d < 3; ++d) {
    t.A[d] = verts[(long long)ia * 3 + d];
    t.B[d] = verts[(long long)ib * 3 + d];
    t.C[d] = verts[(long long)ic * 3 + d];
  }
  const float *A = t.A, *B = t.B, *C = t.C;
  if (A[2] <= 1e-6f || B[2] <= 1e-6f || C[2] <= 1e-6f) return no_box();
  const float e1[3] = {__fsub_rn(B[0], A[0]), __fsub_rn(B[1], A[1]),
                       __fsub_rn(B[2], A[2])};
  const float e2[3] = {__fsub_rn(C[0], A[0]), __fsub_rn(C[1], A[1]),
                       __fsub_rn(C[2], A[2])};
  float n0 = __fsub_rn(__fmul_rn(e1[1], e2[2]), __fmul_rn(e1[2], e2[1]));
  float n1 = __fsub_rn(__fmul_rn(e1[2], e2[0]), __fmul_rn(e1[0], e2[2]));
  float n2 = __fsub_rn(__fmul_rn(e1[0], e2[1]), __fmul_rn(e1[1], e2[0]));
  const float nl = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(n0, n0), __fmul_rn(n1, n1)), __fmul_rn(n2, n2)));
  if (nl < 1e-12f) return no_box();
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
  if (x0 > x1 || y0 > y1) return no_box();
  const float det =
      __fadd_rn(__fmul_rn(__fsub_rn(t.by, t.cy), __fsub_rn(t.ax, t.cx)),
                __fmul_rn(__fsub_rn(t.cx, t.bx), __fsub_rn(t.ay, t.cy)));
  if (fabsf(det) < 1e-12f) return no_box();
  t.inv_det = __fdiv_rn(1.0f, det);
  t.iza = __fdiv_rn(1.0f, A[2]);
  t.izb = __fdiv_rn(1.0f, B[2]);
  t.izc = __fdiv_rn(1.0f, C[2]);
  table[f] = t;
  return make_int4(x0, x1, y0, y1);
}

// a thread a face; blockDim a multiple of 32, so a warp's faces are one
// chunk 32 c .. 32 c + 31
__global__ void rast_faces(const float* __restrict__ verts,
                           long long n_verts, const int* __restrict__ faces,
                           long long n_faces, float fx, float fy, float cx,
                           float cy, int h, int w, Face* __restrict__ table,
                           int4* __restrict__ boxes,
                           int4* __restrict__ chunks) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int4 b = no_box();
  if (f < n_faces) {
    b = face_row(verts, n_verts, faces, f, fx, fy, cx, cy, h, w, table);
    boxes[f] = b;
  }
  int x0 = b.x, x1 = b.y, y0 = b.z, y1 = b.w;  // no_box() is the identity
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 = min(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    x1 = max(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    y0 = min(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    y1 = max(y1, __shfl_xor_sync(0xffffffffu, y1, o));
  }
  if ((threadIdx.x & 31) == 0 && f < n_faces)
    chunks[f / CHUNK] = make_int4(x0, x1, y0, y1);
}

// the winner's (coords, normal, mask) at pixel (x, y) from its key
__device__ __forceinline__ unsigned char resolve(
    const Face* __restrict__ table, unsigned long long key, int x, int y,
    float (&c)[3], float (&n)[3]) {
  for (int d = 0; d < 3; ++d) c[d] = n[d] = 0.0f;
  if (key == EMPTY) return 0;
  const Face t = table[key & 0xffffffffull];
  float l0, l1, l2;
  bary(t, x, y, l0, l1, l2);
  const float z = depth(t, l0, l1, l2);
  const float w0 = __fmul_rn(__fmul_rn(l0, t.iza), z);
  const float w1 = __fmul_rn(__fmul_rn(l1, t.izb), z);
  const float w2 = __fmul_rn(__fmul_rn(l2, t.izc), z);
  for (int d = 0; d < 3; ++d) {
    c[d] = __fadd_rn(__fadd_rn(__fmul_rn(w0, t.A[d]), __fmul_rn(w1, t.B[d])),
                     __fmul_rn(w2, t.C[d]));
    n[d] = t.n[d];
  }
  return 1;
}

__global__ void __launch_bounds__(RT_THREADS) rast_tiles(
    const Face* __restrict__ table, const int4* __restrict__ boxes,
    const int4* __restrict__ chunks, long long n_faces, int h, int w,
    float* __restrict__ coords, float* __restrict__ normals,
    unsigned char* __restrict__ mask) {
  extern __shared__ unsigned long long keys[];  // TILE x TILE
  int* list = reinterpret_cast<int*>(keys + TILE * TILE);  // LIST_CAP
  __shared__ int n_list;
  const int tx0 = blockIdx.x * TILE, ty0 = blockIdx.y * TILE;
  const int tw = min(TILE, w - tx0), th = min(TILE, h - ty0);
  const int tx1 = tx0 + tw - 1, ty1 = ty0 + th - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < TILE * TILE / 2; i += RT_THREADS)
    reinterpret_cast<ulonglong2*>(keys)[i] = make_ulonglong2(EMPTY, EMPTY);
  if (threadIdx.x == 0) n_list = 0;
  __syncthreads();
  const long long n_chunks = (n_faces + CHUNK - 1) / CHUNK;
  for (long long c0 = 0; c0 < n_chunks; c0 += ROUND_CHUNKS) {
    // cull: 32 chunk boxes a warp, then the faces of each chunk that meets
    // the tile, appended to the round's list
    const long long cw = c0 + 32 * warp;
    const long long c = cw + lane;
    unsigned hit = __ballot_sync(
        0xffffffffu, c < n_chunks && meets(__ldg(chunks + c), tx0, tx1, ty0,
                                           ty1));
    while (hit) {
      const int j = __ffs(hit) - 1;
      hit &= hit - 1;
      const long long f = (cw + j) * CHUNK + lane;
      const unsigned in = __ballot_sync(
          0xffffffffu,
          f < n_faces && meets(__ldg(boxes + f), tx0, tx1, ty0, ty1));
      int base = 0;
      if (lane == 0) base = atomicAdd(&n_list, __popc(in));
      base = __shfl_sync(0xffffffffu, base, 0);
      if ((in >> lane) & 1u)
        list[base + __popc(in & ((1u << lane) - 1u))] = (int)f;
    }
    __syncthreads();
    // depth test: a listed face a warp, its lanes over its box in the tile
    const int n = n_list;
    for (int e = warp; e < n; e += RT_WARPS) {
      const int f = list[e];
      const int4 b = __ldg(boxes + f);
      Face t;
      t.ax = __ldg(&table[f].ax);
      t.ay = __ldg(&table[f].ay);
      t.bx = __ldg(&table[f].bx);
      t.by = __ldg(&table[f].by);
      t.cx = __ldg(&table[f].cx);
      t.cy = __ldg(&table[f].cy);
      t.inv_det = __ldg(&table[f].inv_det);
      t.iza = __ldg(&table[f].iza);
      t.izb = __ldg(&table[f].izb);
      t.izc = __ldg(&table[f].izc);
      const int x0 = max(b.x, tx0), x1 = min(b.y, tx1);
      const int y0 = max(b.z, ty0), y1 = min(b.w, ty1);
      const int bw = x1 - x0 + 1, cnt = bw * (y1 - y0 + 1);
      // (row, column) of candidate p = lane + 32 k, stepped without a
      // division a step
      int r = lane / bw, col = lane - r * bw;
      const int dq = 32 / bw, dr = 32 - dq * bw;
      for (int p = lane; p < cnt; p += 32) {
        const int x = x0 + col, y = y0 + r;
        col += dr;
        r += dq;
        if (col >= bw) {
          col -= bw;
          ++r;
        }
        float l0, l1, l2;
        bary(t, x, y, l0, l1, l2);
        if (l0 < -1e-6f || l1 < -1e-6f || l2 < -1e-6f) continue;
        float z = depth(t, l0, l1, l2);
        if (!(z < __int_as_float(0x7f800000))) continue;  // +inf, NaN
        if (z == 0.0f) z = 0.0f;                           // -0 ties +0
        unsigned u = __float_as_uint(z);
        u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
        atomicMin(keys + (y - ty0) * TILE + (x - tx0),
                  ((unsigned long long)u << 32) | (unsigned)f);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) n_list = 0;
    __syncthreads();
  }
  // resolve BAND rows at a time into a stage over the list, then write
  // each row's coords, normals and mask as whole lines: 16-byte stores
  // where the tile is whole and every row starts 16-byte aligned (w a
  // multiple of 16; the outputs' base is)
  const bool vec = tw == TILE && w % 16 == 0;
  float* sc = reinterpret_cast<float*>(list);  // BAND x tw x 3
  float* sn = sc + BAND * TILE * 3;
  unsigned char* sm = reinterpret_cast<unsigned char*>(sn + BAND * TILE * 3);
  for (int r0 = 0; r0 < th; r0 += BAND) {
    const int rows = min(BAND, th - r0);
    for (int i = threadIdx.x; i < rows * tw; i += RT_THREADS) {
      const int r = i / tw, x = i - r * tw;
      float c[3], nv[3];
      sm[i] = resolve(table, keys[(r0 + r) * TILE + x], tx0 + x,
                      ty0 + r0 + r, c, nv);
      for (int d = 0; d < 3; ++d) {
        sc[3 * i + d] = c[d];
        sn[3 * i + d] = nv[d];
      }
    }
    __syncthreads();
    if (vec) {  // a full tile row: 48 float4 of coords (normals), 4 uint4
      for (int i = threadIdx.x; i < rows * 48; i += RT_THREADS) {
        const int r = i / 48, j = i - r * 48;
        const long long o = ((long long)(ty0 + r0 + r) * w + tx0) * 3;
        reinterpret_cast<float4*>(coords + o)[j] =
            reinterpret_cast<const float4*>(sc)[i];
        reinterpret_cast<float4*>(normals + o)[j] =
            reinterpret_cast<const float4*>(sn)[i];
      }
      for (int i = threadIdx.x; i < rows * 4; i += RT_THREADS) {
        const int r = i >> 2, j = i & 3;
        reinterpret_cast<uint4*>(mask + (long long)(ty0 + r0 + r) * w +
                                 tx0)[j] = reinterpret_cast<const uint4*>(sm)[i];
      }
    } else {
      const int line = 3 * tw;
      for (int i = threadIdx.x; i < rows * line; i += RT_THREADS) {
        const int r = i / line, j = i - r * line;
        const long long o = ((long long)(ty0 + r0 + r) * w + tx0) * 3 + j;
        coords[o] = sc[i];
        normals[o] = sn[i];
      }
      for (int i = threadIdx.x; i < rows * tw; i += RT_THREADS) {
        const int r = i / tw, x = i - r * tw;
        mask[(long long)(ty0 + r0 + r) * w + tx0 + x] = sm[i];
      }
    }
    __syncthreads();
  }
}

__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) & ~15ll;
}

}  // namespace

// verts (n_verts, 3) f32, faces (n_faces, 3) int32, the pinhole, the image
// size; scratch: table, 16-byte aligned, of the face table (22 floats a
// face), the boxes (16 B a face) and the chunk boxes (16 B a CHUNK faces),
// each part 16-byte aligned (simulator/rasterizer.py table_bytes); out: coords and normals (h, w, 3) f32, mask (h, w) bool.  Two
// launches on stream.
extern "C" int ccn_rasterize(const float* verts, long long n_verts,
                             const int* faces, long long n_faces, float fx,
                             float fy, float cx, float cy, int h, int w,
                             void* table, float* coords, float* normals,
                             unsigned char* mask, void* stream) {
  if (h < 1 || w < 1 || n_verts < 0 || n_faces < 0 || n_faces > INT_MAX ||
      (h + TILE - 1) / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  char* base = static_cast<char*>(table);
  Face* t = reinterpret_cast<Face*>(base);
  int4* boxes = reinterpret_cast<int4*>(
      base + align16(n_faces * (long long)sizeof(Face)));
  int4* chunks = boxes + n_faces;
  cudaError_t e;
  if (n_faces > 0) {
    rast_faces<<<(unsigned)((n_faces + 255) / 256), 256, 0, st>>>(
        verts, n_verts, faces, n_faces, fx, fy, cx, cy, h, w, t, boxes,
        chunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int smem = TILE * TILE * 8 + LIST_CAP * 4;
  e = cudaFuncSetAttribute(rast_tiles,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  rast_tiles<<<grid, RT_THREADS, smem, st>>>(t, boxes, chunks, n_faces, h, w,
                                             coords, normals, mask);
  return (int)cudaGetLastError();
}
