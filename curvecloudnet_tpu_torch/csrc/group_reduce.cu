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
// The row list, the chunked chain and the aggregation are group_chain.cuh,
// which K9 (edge_mlp.cu) shares; this file gives them K2's rows.
//
// The bfloat16 variant (ccn_group_reduce_bf16; the Pallas kernel with a
// bfloat16 h1, a model computing in bfloat16) is its own kernel, on wgmma
// with bfloat16 activations in shared memory: group_wgmma.cuh.

#include "group_chain.cuh"
#include "group_wgmma.cuh"

// K2's rows: the layer-0 pre-norm planes h1 (B, K, M, c1), the layer-0 BN
// affine (s0, t0) and the activation applied on load; mask (B, M, K).
struct H1Src {
  const float* h1;
  const unsigned char* mask;
  const float* s0;
  const float* t0;
  int c1, K, M, act;

  __device__ __forceinline__ bool live(int b, int m, int k) const {
    return __ldg(mask + ((size_t)b * M + m) * K + k) != 0;
  }

  __device__ bool same_planes(int b, int m, int, int lane) const {
    const float* p0 = h1 + ((size_t)b * K * M + m) * c1;
    bool same = true;
    for (int k = 1; k < K && same; ++k) {
      const float* pk = p0 + (size_t)k * M * c1;
      bool eq = true;
      for (int c = lane; c < c1; c += 32)
        eq &= load_f32(pk + c) == load_f32(p0 + c);
      same = __all_sync(0xffffffffu, eq);
    }
    return same;
  }

  __device__ void load(float* dst, int ld, const unsigned short* list,
                       int r0, int nrow, int rows, int b, int m0,
                       int ms) const {
    const int tid = threadIdx.x, nt = blockDim.x;
    if ((c1 & 3) == 0) {
      const int c4 = c1 >> 2;
      for (int i = tid; i < rows * c4; i += nt) {
        const int j = i / c4, c = (i - j * c4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < nrow) {
          const int e = list[r0 + j];
          const int q = e >> GR_QBITS, k = e & ((1 << GR_QBITS) - 1);
          v = load4_f32(h1 + (((size_t)b * K + k) * M + m0 + q * ms) * c1 +
                        c);
          const float4 s = __ldg(reinterpret_cast<const float4*>(s0 + c));
          const float4 o = __ldg(reinterpret_cast<const float4*>(t0 + c));
          v = make_float4(act_fn(v.x * s.x + o.x, act),
                          act_fn(v.y * s.y + o.y, act),
                          act_fn(v.z * s.z + o.z, act),
                          act_fn(v.w * s.w + o.w, act));
        }
        *reinterpret_cast<float4*>(dst + j * ld + c) = v;
      }
    } else {
      for (int i = tid; i < rows * c1; i += nt) {
        const int j = i / c1, c = i - j * c1;
        float v = 0.f;
        if (j < nrow) {
          const int e = list[r0 + j];
          const int q = e >> GR_QBITS, k = e & ((1 << GR_QBITS) - 1);
          const size_t row = ((size_t)b * K + k) * M + m0 + q * ms;
          v = act_fn(load_f32(h1 + row * c1 + c) * __ldg(s0 + c) +
                         __ldg(t0 + c),
                     act);
        }
        dst[j * ld + c] = v;
      }
    }
  }
};

// h1 (B, K, M, dims[0]) f32; mask (B, M, K) bool; s0/t0 (dims[0],) f32;
// the rest as run_chain (group_chain.cuh) takes it.
extern "C" int ccn_group_reduce(const float* h1, const unsigned char* mask,
                                const float* s0, const float* t0,
                                const float* wp, int n_local, int n_attend,
                                const int* dims, const long long* woff,
                                const long long* boff, int aggr, int act,
                                int attend_act, int B, int K, int M, int rows,
                                int tq, int kc, float* out, void* stream) {
  const H1Src src = {h1, mask, s0, t0, dims[0], K, M, act};
  return run_chain(src, wp, n_local, n_attend, dims, woff, boff, aggr, act,
                   attend_act, B, K, M, rows, tq, kc, 1, out,
                   (cudaStream_t)stream);
}

// The bfloat16 variant: h1 bfloat16; wimg the packed weight stages and
// bias the padded biases (ops/group_reduce.py pack_bf16), scratch the
// per-block f32 scratch, plan the launch (GwMeta's nplan ints, plan_bf16);
// out (B, M, cout) f32.
extern "C" int ccn_group_reduce_bf16(const __nv_bfloat16* h1,
                                     const unsigned char* mask,
                                     const float* s0, const float* t0,
                                     const void* wimg, const float* bias,
                                     float* scratch, const int* plan,
                                     int nplan, float* out, void* stream) {
  return run_group_wgmma(h1, mask, s0, t0, wimg, bias, scratch, plan, nplan,
                         out, (cudaStream_t)stream);
}
