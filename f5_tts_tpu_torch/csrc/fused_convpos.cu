// Fused ConvPositionEmbedding, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel f5_tts_tpu/ops/fused_convpos.py::_kernel
// (called through _conv_pos_fused / conv_pos_fused).  For x [b, n, d] with
// `groups` groups of 64 channels it runs, per batch row,
//   mask -> grouped conv1d (k=31, "same", bias) -> Mish -> mask
//        -> grouped conv1d (k=31, bias) -> Mish -> mask
// where mask keeps the logical rows [0, lens[b]); the intermediate is zero
// outside [0, len), including the rows before 0 that conv2's padding reads,
// and is rounded to the working dtype before conv2 (as the TPU kernel does).
//
// Design.  A grouped conv's output group depends only on its input group,
// so the whole chain is separable per (batch row, group).  One block of 256
// threads takes one (row tile of 64, group, batch row): it stages the x tile
// with its 30-row halo on each side (124 x 64 fp32) and keeps the conv1
// result for the tile plus a 15-row halo each side (94 x 64 fp32) in shared
// memory, so the intermediate never reaches device memory.  One conv's
// weights for one group (31 x 64 x 64) exceed shared memory in bf16, so they
// are staged one tap (64 x 64) at a time from a tap-major copy
// [groups][31][c_in][c_out] that the wrapper makes from torch's
// [out, in/g, k] layout.  The TPU kernel's 128-lane group pairs and its
// <=1024-row grid chunks were VMEM artefacts and are not reproduced.
//
// Bound on the H100: 2 convs x 31 taps x 64 inputs = 3968 multiply-adds per
// output element against 4 bytes in and out (bf16), so the function is
// compute-bound.  This first version uses fp32 FMA from shared memory (each
// 16-byte broadcast load of x feeds 4 FMAs per thread), not the tensor
// cores; the tensor-core version (each tap a 64 x 64 GEMM) is later work.

#include "common.cuh"

namespace {

constexpr int KS = 31;                 // taps
constexpr int HALF = KS / 2;           // 15
constexpr int DG = 64;                 // channels per group
constexpr int TR = 64;                 // output rows per block
constexpr int NI = TR + 2 * HALF;      // 94 intermediate rows
constexpr int NI_PAD = 96;             // computed conv1 rows (2 spare, never stored)
constexpr int NX = NI_PAD + 2 * HALF;  // 126 staged x rows
constexpr int NTHREADS = 256;          // 64 output channels x 4 row groups
constexpr size_t SMEM_BYTES = (NX + NI_PAD + DG) * DG * sizeof(float);

__device__ __forceinline__ float mish(float x) {
  // softplus as logaddexp(x, 0), the JAX formulation
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

template <typename T>
__device__ __forceinline__ void stage_tap(float* ws, const T* __restrict__ wt, int g, int t) {
  const T* src = wt + (static_cast<size_t>(g) * KS + t) * DG * DG;
  for (int idx = threadIdx.x; idx < DG * DG; idx += NTHREADS) ws[idx] = to_float(src[idx]);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
convpos_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1t, const T* __restrict__ b1,
                   const T* __restrict__ w2t, const T* __restrict__ b2,
                   const int* __restrict__ lens, T* __restrict__ out, int n, int d) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [NX][DG]      x rows r0-30 .. r0+TR+31
  float* inter = xs + NX * DG;       // [NI_PAD][DG]  conv1 rows r0-15 .. r0+TR+16
  float* ws = inter + NI_PAD * DG;   // [DG c][DG o]  one tap of weights

  const int r0 = blockIdx.x * TR;
  const int g = blockIdx.y;
  const int bi = blockIdx.z;
  int L = lens[bi];
  L = L < 0 ? 0 : (L > n ? n : L);
  const int o = threadIdx.x % DG;   // output channel within the group
  const int rg = threadIdx.x / DG;  // row group: rows rg, rg + 4, ...
  const size_t row_base = static_cast<size_t>(bi) * n;
  const int ch0 = g * DG;

  // masked x tile: logical rows outside [0, L) read as 0
  for (int idx = threadIdx.x; idx < NX * DG / 8; idx += NTHREADS) {
    const int i = idx / (DG / 8), c = (idx % (DG / 8)) * 8;
    const int row = r0 - 2 * HALF + i;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row >= 0 && row < L) load8(x + (row_base + row) * d + ch0 + c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) xs[i * DG + c + e] = f[e];
  }

  // conv1: rows i = rg + 4r of the intermediate, i in [0, NI_PAD)
  constexpr int R1 = NI_PAD / 4;
  float acc1[R1];
#pragma unroll
  for (int r = 0; r < R1; ++r) acc1[r] = 0.f;
  for (int t = 0; t < KS; ++t) {
    __syncthreads();
    stage_tap(ws, w1t, g, t);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < DG; c += 4) {
      const float w0 = ws[c * DG + o], w1 = ws[(c + 1) * DG + o];
      const float w2 = ws[(c + 2) * DG + o], w3 = ws[(c + 3) * DG + o];
#pragma unroll
      for (int r = 0; r < R1; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[(rg + 4 * r + t) * DG + c]);
        acc1[r] += xv.x * w0 + xv.y * w1 + xv.z * w2 + xv.w * w3;
      }
    }
  }
  const float bias1 = to_float(b1[ch0 + o]);
#pragma unroll
  for (int r = 0; r < R1; ++r) {
    const int i = rg + 4 * r;
    const int row = r0 - HALF + i;
    const float val = (row >= 0 && row < L) ? mish(acc1[r] + bias1) : 0.f;
    inter[i * DG + o] = to_float(from_float<T>(val));  // working-dtype rounding
  }

  // conv2: output rows i = rg + 4r, i in [0, TR)
  constexpr int R2 = TR / 4;
  float acc2[R2];
#pragma unroll
  for (int r = 0; r < R2; ++r) acc2[r] = 0.f;
  for (int t = 0; t < KS; ++t) {
    __syncthreads();  // also publishes `inter` before the first tap
    stage_tap(ws, w2t, g, t);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < DG; c += 4) {
      const float w0 = ws[c * DG + o], w1 = ws[(c + 1) * DG + o];
      const float w2 = ws[(c + 2) * DG + o], w3 = ws[(c + 3) * DG + o];
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        const float4 iv = *reinterpret_cast<const float4*>(&inter[(rg + 4 * r + t) * DG + c]);
        acc2[r] += iv.x * w0 + iv.y * w1 + iv.z * w2 + iv.w * w3;
      }
    }
  }
  const float bias2 = to_float(b2[ch0 + o]);
#pragma unroll
  for (int r = 0; r < R2; ++r) {
    const int row = r0 + rg + 4 * r;
    if (row < n) {
      const float val = row < L ? mish(acc2[r] + bias2) : 0.f;
      out[(row_base + row) * d + ch0 + o] = from_float<T>(val);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1t, const void* b1, const void* w2t, const void* b2,
           const void* lens, void* out, int b, int n, int d, int groups, cudaStream_t st) {
  static bool attr_set = false;  // one attribute call per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(convpos_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((n + TR - 1) / TR, groups, b);
  convpos_fwd_kernel<T><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1t), static_cast<const T*>(b1),
      static_cast<const T*>(w2t), static_cast<const T*>(b2), static_cast<const int*>(lens),
      static_cast<T*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

F5_EXPORT_ERROR_STRING

// x, out: [b, n, d] contiguous; w1t, w2t: [groups][31][64][64] tap-major;
// b1, b2: [d]; all of one dtype.  lens: int32 [b].  d must be 64 * groups.
extern "C" int fused_convpos_fwd(const void* x, const void* w1t, const void* b1, const void* w2t,
                                 const void* b2, const void* lens, void* out, int b, int n, int d,
                                 int groups, int dtype, void* stream) {
  if (groups <= 0 || d != groups * DG || n <= 0 || b <= 0 || b > 65535 || groups > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(x, w1t, b1, w2t, b2, lens, out, b, n, d, groups, st);
  }
  if (dtype == kFloat32) return launch<float>(x, w1t, b1, w2t, b2, lens, out, b, n, d, groups, st);
  return cudaErrorInvalidValue;
}
