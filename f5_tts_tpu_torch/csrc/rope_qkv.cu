// The fused qkv projection's output to rotated, head-major q, k, v, for
// Hopper (sm_90a): the serving forward of every DiT and UNetT block's
// rotary and layout glue in one pass.
//
// Replaces no Pallas TPU kernel: XLA fuses this glue on the TPU
// (f5_tts_tpu/models/layers.py::mha, the chunk, the head split and
// f5_tts_tpu/ops/rope.py::apply_rotary).  In eager PyTorch it was some 19
// launches of strided and broadcast elementwise kernels, ~22 activations'
// worth of device traffic a block.  ops/rope.py::rope_qkv_cuda is the
// wrapper, rope_qkv_plain the plain version.
//
// For qkv bf16 [b, n, 3 h 64] (contiguous), cos and sin bf16 [n, 64] (the
// interleaved rotary table's cos and sin, rounded to bf16), it writes q, k, v
// bf16 [b, h, n, 64], each contiguous:
//   q[i, j, t, :] = rot(qkv[i, t, (0 h + j) 64 : ... + 64])  for j < rot_heads
//   k likewise from the second third, v the third third as it is, and heads
//   j >= rot_heads of q and k as they are;
//   rot(x)[2p]     = x[2p] cos[t, 2p]     - x[2p+1] sin[t, 2p]
//   rot(x)[2p + 1] = x[2p + 1] cos[t, 2p + 1] + x[2p] sin[t, 2p + 1]
// Each product of two bf16 values is exact in fp32; the sum rounds to fp32,
// then to bf16 once, at the store (the plain version rounds each product and
// the sum to bf16).
//
// Bound: bytes.  It reads qkv once and writes q, k, v once, 12 bytes per
// head-dim element of a token's head (6 per qkv element); at [16, 2048, 3072]
// that is 403 MB, 0.120 ms at 3.35 TB/s.  The [n, 64] tables are 256 bytes a
// token and stay in L1 / L2.
//
// Design.  Every thread moves 16-byte vectors (8 bf16): a flat index over
// the vectors of qkv, so neighbouring threads read neighbouring addresses of
// a token's 6 KB row, and the 8 vectors of one head's 128-byte row go to 8
// neighbouring threads, which write that output row whole.  A rotary pair
// (2p, 2p + 1) lies inside one vector.  A thread loads kUnroll vectors
// (kThreads apart) before it stores any, to keep loads in flight.  No
// shared memory, no synchronisation: it launches on the caller's stream and
// captures into a CUDA graph.
#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kVec = 8;                       // bf16 per 16-byte vector
constexpr int kRowVecs = kHeadDim / kVec;     // vectors per head row
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ uint4 rotate8(uint4 x, uint4 c, uint4 s) {
  const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ch = reinterpret_cast<const __nv_bfloat162*>(&c);
  const __nv_bfloat162* sh = reinterpret_cast<const __nv_bfloat162*>(&s);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 xf = __bfloat1622float2(xh[i]);
    float2 cf = __bfloat1622float2(ch[i]);
    float2 sf = __bfloat1622float2(sh[i]);
    // explicit roundings: no contraction into an fma (equal anyway, the
    // products being exact), so the result is the fp32 reference's
    float lo = __fadd_rn(__fmul_rn(xf.x, cf.x), __fmul_rn(-xf.y, sf.x));
    float hi = __fadd_rn(__fmul_rn(xf.y, cf.y), __fmul_rn(xf.x, sf.y));
    o[i] = pack_bf16(lo, hi);
  }
  return out;
}

__global__ void __launch_bounds__(kThreads)
rope_qkv_kernel(const uint4* __restrict__ qkv, const uint4* __restrict__ cos,
                const uint4* __restrict__ sin, uint4* __restrict__ q, uint4* __restrict__ k,
                uint4* __restrict__ v, unsigned n, unsigned heads, unsigned rot_heads,
                unsigned total) {
  const unsigned part_vecs = heads * kRowVecs;  // vectors of q (or k, v) in a token
  const unsigned token_vecs = 3 * part_vecs;
  const unsigned first = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  uint4 in[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = first + u * kThreads;
    if (i < total) in[u] = __ldg(qkv + i);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = first + u * kThreads;
    if (i >= total) break;
    const unsigned token = i / token_vecs;       // b * n + t
    const unsigned j = i - token * token_vecs;
    const unsigned which = j / part_vecs;        // 0 q, 1 k, 2 v
    const unsigned r = j - which * part_vecs;
    const unsigned head = r / kRowVecs;
    const unsigned vec = r % kRowVecs;
    const unsigned bi = token / n;
    const unsigned t = token - bi * n;
    uint4 val = in[u];
    if (which < 2 && head < rot_heads) {
      const unsigned at = t * kRowVecs + vec;
      val = rotate8(val, __ldg(cos + at), __ldg(sin + at));
    }
    uint4* dst = which == 0 ? q : (which == 1 ? k : v);
    dst[((static_cast<size_t>(bi) * heads + head) * n + t) * kRowVecs + vec] = val;
  }
}

}  // namespace

// qkv bf16 [b, n, 3 heads 64], cos / sin bf16 [n, 64], q / k / v bf16
// [b, heads, n, 64]; every pointer 16-byte aligned and contiguous; fewer
// than 2^31 vectors of 8 in qkv (the wrapper checks).
extern "C" int rope_qkv(const void* qkv, const void* cos, const void* sin, void* q, void* k,
                        void* v, int b, int n, int heads, int rot_heads, void* stream) {
  if (b < 0 || n < 0 || heads < 0 || rot_heads < 0 || rot_heads > heads)
    return cudaErrorInvalidValue;
  const long long total = 3LL * b * n * heads * kRowVecs;
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  const unsigned per_block = kThreads * kUnroll;
  const unsigned blocks = static_cast<unsigned>((total + per_block - 1) / per_block);
  rope_qkv_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qkv), static_cast<const uint4*>(cos),
      static_cast<const uint4*>(sin), static_cast<uint4*>(q), static_cast<uint4*>(k),
      static_cast<uint4*>(v), static_cast<unsigned>(n), static_cast<unsigned>(heads),
      static_cast<unsigned>(rot_heads), static_cast<unsigned>(total));
  return static_cast<int>(cudaGetLastError());
}

F5_EXPORT_ERROR_STRING
