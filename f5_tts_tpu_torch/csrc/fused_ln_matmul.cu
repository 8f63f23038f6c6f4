// LayerNorm + AdaLN modulate fused into a bf16 matrix product's prologue,
// for Hopper (sm_90a): kernel I, an experiment.
//
// Replaces the Pallas TPU kernel scripts/exp_fused_ln_matmul.py::_kernel
// (:27), called through fused_ln_matmul (:48).  Computes
//   out = bf16( bf16(LN(x) * scale1p + shift) @ w + bias )
// with LN over K without affine (eps 1e-6, fp32 statistics, two-pass
// variance), for x bf16 [M, K], w bf16 [K, N] (the experiment's layout),
// bias fp32 [N], scale1p / shift fp32 [K] -> out bf16 [M, N].  The product
// accumulates in fp32; the bias is added to the fp32 sum before the one
// rounding to bf16.  Neither this kernel nor its driver
// (f5_tts_tpu_torch/scripts/exp_fused_ln_matmul.py) is on the serving path;
// it asks whether the normalise-and-modulate pass before each block's qkv
// matmul can ride in the matmul's operand load.
//
// Design.  One block of 8 warps per 64 x 128 output tile.
//  1. Prologue: each warp takes 8 of the block's 64 rows and computes their
//     fp32 mean and variance over the whole K from x (coalesced loads), while
//     it copies the raw row into a [64, K] bf16 panel in dynamic shared
//     memory (128 KB at K = 1024; the attribute is set per launch); then it
//     rewrites the panel in place as the normalised, modulated bf16 A
//     operand.  Rows past M and the columns past K up to the last k step are
//     zeros.
//  2. Main loop: 32 x 128 tiles of w stream through two shared-memory
//     stages with 16-byte cp.async copies (element loads when N % 8 != 0),
//     the next one in flight while the current one is multiplied; the warps
//     tile the output 4 (rows) x 2 (columns), 16 x 64 each, with mma.sync
//     m16n8k16 (bf16 in, fp32 accumulate); A fragments are 32-bit loads
//     from the panel, B fragments ldmatrix.trans from the row-major w tile.
//  3. Epilogue: + bias in fp32, one rounding to bf16, masked stores.
// Every block recomputes its rows' statistics (N / 128 times per row in
// all, as the TPU kernel does per column block); the panel bounds K:
// 64 (round_up(K, 32) + 8) * 2 bytes plus the two w stages must fit the
// 227 KB a block can use, i.e. K <= 1664; the wrapper raises above that.
//
// Bound on the H100: at the experiment's shape M = 2048, K = 1024,
// N = 3072, 12.9 GFLOP take 13.0 us at the bf16 tensor-core rate; the
// bytes (4.2 MB of x, 6.3 MB of w, 12.6 MB of output) take 6.9 us: the
// products bound it.

#include "common.cuh"

namespace {

constexpr int BM = 64;         // rows per block
constexpr int BN = 128;        // columns per block
constexpr int BKW = 32;        // k rows of w per stage
constexpr int LDW = BN + 8;    // padded w-tile row (bf16): conflict-free ldmatrix
constexpr int NTHREADS = 256;  // 8 warps
constexpr float LN_EPS = 1e-6f;

__host__ __device__ constexpr int panel_ld(int k) { return (k + BKW - 1) / BKW * BKW + 8; }

// BKW x BN tile of w [K, N] from (k0, n0) into s [BKW][LDW]; zeros past the edges
template <bool VEC>
__device__ __forceinline__ void load_w_tile(__nv_bfloat16* s, const __nv_bfloat16* __restrict__ w,
                                            int K, int N, int k0, int n0, int tid) {
  if constexpr (VEC) {  // N % 8 == 0: a 16-byte chunk lies wholly inside or past the edge
#pragma unroll
    for (int idx = tid; idx < BKW * (BN / 8); idx += NTHREADS) {
      const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
      const bool in = k0 + r < K && n0 + c < N;
      cp_async16(s + r * LDW + c, in ? w + static_cast<size_t>(k0 + r) * N + n0 + c : w,
                 in ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < BKW * BN; idx += NTHREADS) {
      const int r = idx / BN, c = idx % BN;
      s[r * LDW + c] = (k0 + r < K && n0 + c < N) ? w[static_cast<size_t>(k0 + r) * N + n0 + c]
                                                  : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS)
fused_ln_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ sc,
                       const float* __restrict__ sh, __nv_bfloat16* __restrict__ out, int M,
                       int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = panel_ld(K);
  const int kpad = lda - 8;
  __nv_bfloat16* panel = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][lda]
  __nv_bfloat16* sW = panel + BM * lda;                                // [2][BKW][LDW]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ktiles = kpad / BKW;

  // the first w stage flies while the prologue normalises the panel
  load_w_tile<VEC>(sW, w, K, N, 0, n0, tid);
  cp_async_commit();

  // 1. prologue: row statistics and the modulated bf16 panel
  for (int r = warp; r < BM; r += NTHREADS / 32) {
    __nv_bfloat16* row = panel + r * lda;
    const int gr = m0 + r;
    if (gr >= M) {
      for (int c = lane; c < kpad; c += 32) row[c] = __float2bfloat16(0.f);
      continue;
    }
    const __nv_bfloat16* src = x + static_cast<size_t>(gr) * K;
    float s = 0.f;
    for (int c = lane; c < K; c += 32) {
      const __nv_bfloat16 v = src[c];
      row[c] = v;
      s += __bfloat162float(v);
    }
    const float mean = warp_sum(s) / K;
    float s2 = 0.f;
    for (int c = lane; c < K; c += 32) {  // this lane's own entries: no barrier needed
      const float d = __bfloat162float(row[c]) - mean;
      s2 += d * d;
    }
    const float rstd = rsqrtf(warp_sum(s2) / K + LN_EPS);
    for (int c = lane; c < kpad; c += 32) {
      row[c] = c < K ? __float2bfloat16((__bfloat162float(row[c]) - mean) * rstd * sc[c] + sh[c])
                     : __float2bfloat16(0.f);
    }
  }

  // 2. main loop over k
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 64;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int mi = lane >> 3, rr = lane & 7;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles) {
      load_w_tile<VEC>(sW + (st ^ 1) * BKW * LDW, w, K, N, (kt + 1) * BKW, n0, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // stage st has landed (and, at kt = 0, the panel is written)
    __syncthreads();
    const __nv_bfloat16* tw = sW + st * BKW * LDW;
#pragma unroll
    for (int kk = 0; kk < BKW; kk += 16) {
      const int c = kt * BKW + kk + t4 * 2;
      uint32_t a[4];
      a[0] = ld_u32(&panel[(wm + g) * lda + c]);
      a[1] = ld_u32(&panel[(wm + g + 8) * lda + c]);
      a[2] = ld_u32(&panel[(wm + g) * lda + c + 8]);
      a[3] = ld_u32(&panel[(wm + g + 8) * lda + c + 8]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &tw[(kk + (mi & 1) * 8 + rr) * LDW + wn + (2 * np + (mi >> 1)) * 8]);
        mma_16816(acc[2 * np], a, b[0], b[1]);
        mma_16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

  // 3. epilogue: + bias (fp32), one rounding to bf16
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + wm + g + 8 * h;
    if (r >= M) continue;
    __nv_bfloat16* dst = out + static_cast<size_t>(r) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + wn + j * 8 + 2 * t4;
      if (c >= N) continue;
      const float v0 = acc[j][2 * h] + bias[c];
      if (c + 1 < N) {
        const float v1 = acc[j][2 * h + 1] + bias[c + 1];
        if (pairs) {
          *reinterpret_cast<uint32_t*>(dst + c) = pack_bf16(v0, v1);
        } else {
          dst[c] = __float2bfloat16(v0);
          dst[c + 1] = __float2bfloat16(v1);
        }
      } else {
        dst[c] = __float2bfloat16(v0);
      }
    }
  }
}

template <bool VEC>
int launch(const void* x, const void* w, const void* bias, const void* sc, const void* sh,
           void* out, int M, int N, int K, size_t smem, cudaStream_t st) {
  auto kern = fused_ln_matmul_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(sc),
      static_cast<const float*>(sh), static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

F5_EXPORT_ERROR_STRING

// The dynamic shared memory the kernel needs for a given K (bytes).
extern "C" int fused_ln_matmul_smem_bytes(int K) {
  return (BM * panel_ld(K) + 2 * BKW * LDW) * 2;
}

// x: bf16 [M, K], w: bf16 [K, N], bias: fp32 [N], scale1p, shift: fp32 [K],
// out: bf16 [M, N]; all contiguous and 16-byte aligned on the device.
// Returns cudaGetLastError() (or the error of the shared-memory attribute).
extern "C" int fused_ln_matmul(const void* x, const void* w, const void* bias,
                               const void* scale1p, const void* shift, void* out, int M, int N,
                               int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(fused_ln_matmul_smem_bytes(K));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % 8 == 0) return launch<true>(x, w, bias, scale1p, shift, out, M, N, K, smem, st);
  return launch<false>(x, w, bias, scale1p, shift, out, M, N, K, smem, st);
}
