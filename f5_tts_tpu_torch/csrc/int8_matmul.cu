// W8A8 int8 matrix product with the scale epilogue, for Hopper (sm_90a):
// kernel G.
//
// Replaces the Pallas TPU kernel f5_tts_tpu/ops/quant.py::_kernel (:35),
// called through int8_matmul (:67).  Computes
//   out[i, j] = float(sum_k x_q[i, k] * w_q[j, k]) * x_scale[i] * w_scale[j]
// for x_q int8 [m, k] (per-row quantized activations), w_q int8 [n, k]
// (per-output-channel quantized weights, nn.Linear's layout: the TPU kernel
// takes [k, n]), x_scale fp32 [m], w_scale fp32 [n] -> out fp32 [m, n].
// The int32 sum is exact (|sum| <= 127^2 k < 2^31 for k <= 133,143, which
// the wrapper checks); the epilogue converts it to fp32 with one rounding
// and multiplies by the two scales in the TPU kernel's order, so the output
// is bitwise what the plain version computes.
//
// Design.  One block of 8 warps per 64 x 128 output tile; the warps tile it
// 2 (rows) x 4 (columns), 32 x 32 each.  The block walks k in 64-byte
// steps: the x and w tiles are staged in shared memory with 16-byte
// cp.async copies, double-buffered so that step s + 1's copy runs under step
// s's products, and multiplied with mma.sync m16n8k32 (s8 x s8 -> s32, the
// accumulators in registers).  Both operands are k-contiguous, which is the
// layout the instruction's row (A) and col (B) fragments read with one
// 32-bit load per register; rows are padded to 80 bytes, so the eight rows a
// fragment load touches fall in eight different bank groups.  Any m, n, k:
// the ragged edge is zero-filled in shared memory (cp.async's zero fill) and
// masked on the store.  A k that is not a multiple of 16 leaves the rows
// unaligned for 16-byte copies; that instance stages the tiles with byte
// loads instead.
//
// Bound on the H100.  The serving shapes of F5TTS_v1_Base are m = 2 b
// bucket rows (fused CFG) by (k, n) in {(1024, 3072), (1024, 1024),
// (1024, 4096), (4096, 1024)}.  At m = 1024, (k, n) = (1024, 4096): 8.6
// GOP take 4.3 us at the 1,979 TOP/s int8 rate, while the bytes (1 MB of
// x_q, 4 MB of w_q, 16.8 MB of fp32 output) take 6.6 us at 3.35 TB/s: the
// fp32 output, not the tensor cores, bounds the kernel at these shapes, and
// more so at (1024, 1024) (output 4.2 MB against 2.1 GOP).  Fusing the cast
// to the compute dtype into the epilogue would halve that traffic; it is
// left for later, since the output must stay bitwise the fp32 product cast
// afterwards.  This first version issues mma.sync with no warp
// specialisation and writes the output with 8-byte stores.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 128;         // output columns per block
constexpr int BK = 64;          // k bytes per stage
constexpr int LDS = BK + 16;    // padded shared row, bytes
constexpr int NTHREADS = 256;   // 8 warps, 2 x 4, 32 x 32 each

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, s32 accumulators.  Fragments
// (g = lane / 4, t = lane % 4): a0 row g, k 4t..4t+3; a1 row g+8, same k;
// a2 row g, k 16+4t..; a3 row g+8, k 16+4t..; b0 k 4t..4t+3, column g; b1 k
// 16+4t.., column g; d0, d1 row g, columns 2t, 2t+1; d2, d3 row g+8.
__device__ __forceinline__ void mma_16832_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows x BK bytes of a row-major [rows_total, k] int8 matrix, from (r0, k0),
// into s [rows][LDS]; zeros past either edge
template <int ROWS, bool VEC16>
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* __restrict__ g, int rows_total,
                                          int k, int r0, int k0, int tid) {
#pragma unroll
  for (int idx = tid; idx < ROWS * (BK / 16); idx += NTHREADS) {
    const int r = idx / (BK / 16), c = (idx % (BK / 16)) * 16;
    const int gr = r0 + r, gc = k0 + c;
    int8_t* dst = s + r * LDS + c;
    if constexpr (VEC16) {
      // k % 16 == 0: a 16-byte chunk lies wholly inside or wholly past the edge
      const bool in = gr < rows_total && gc < k;
      cp_async16(dst, in ? g + static_cast<size_t>(gr) * k + gc : g, in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gr < rows_total) {
        const int8_t* src = g + static_cast<size_t>(gr) * k;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          if (gc + e < k) {
            w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[gc + e])) << (8 * (e & 3));
          }
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <bool VEC16>
__global__ void __launch_bounds__(NTHREADS)
int8_matmul_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                   const int8_t* __restrict__ w, const float* __restrict__ ws,
                   float* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) int8_t sA[2][BM * LDS];
  __shared__ __align__(16) int8_t sB[2][BN * LDS];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int ktiles = (k + BK - 1) / BK;
  if (ktiles > 0) {
    load_tile<BM, VEC16>(sA[0], x, m, k, m0, 0, tid);
    load_tile<BN, VEC16>(sB[0], w, n, k, n0, 0, tid);
  }
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles) {  // the next stage, whose last reader passed the barrier below
      load_tile<BM, VEC16>(sA[st ^ 1], x, m, k, m0, (kt + 1) * BK, tid);
      load_tile<BN, VEC16>(sB[st ^ 1], w, n, k, n0, (kt + 1) * BK, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every copy but the one just issued: stage st has landed
    __syncthreads();
    const int8_t* a = sA[st];
    const int8_t* b = sB[st];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = a + (wm + mi * 16 + g) * LDS + kk + 4 * t4;
        af[mi][0] = ld_s32(p);
        af[mi][1] = ld_s32(p + 8 * LDS);
        af[mi][2] = ld_s32(p + 16);
        af[mi][3] = ld_s32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = b + (wn + ni * 8 + g) * LDS + kk + 4 * t4;
        bfr[ni][0] = ld_s32(p);
        bfr[ni][1] = ld_s32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16832_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();  // stage st is consumed before the next iteration refills it
  }

  // epilogue: float(acc) * x_scale * w_scale, in the TPU kernel's order
  const bool pairs = (n & 1) == 0;  // column pairs are 8-byte aligned
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + mi * 16 + g + 8 * h;
      if (r >= m) continue;
      const float sx = xs[r];
      float* dst = out + static_cast<size_t>(r) * n;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + wn + ni * 8 + 2 * t4;
        if (c >= n) continue;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), sx), ws[c]);
        if (c + 1 < n) {
          const float v1 =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), sx), ws[c + 1]);
          if (pairs) {
            *reinterpret_cast<float2*>(dst + c) = make_float2(v0, v1);
          } else {
            dst[c] = v0;
            dst[c + 1] = v1;
          }
        } else {
          dst[c] = v0;
        }
      }
    }
  }
}

}  // namespace

F5_EXPORT_ERROR_STRING

// x_q: int8 [m, k], x_scale: fp32 [m], w_q: int8 [n, k], w_scale: fp32 [n],
// out: fp32 [m, n]; all contiguous, 16-byte aligned, on the device.
// Returns cudaGetLastError().
extern "C" int int8_matmul(const void* x_q, const void* x_scale, const void* w_q,
                           const void* w_scale, void* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(x_q);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  float* o = static_cast<float*>(out);
  if (k % 16 == 0) {
    int8_matmul_kernel<true><<<grid, NTHREADS, 0, st>>>(x, xs, w, ws, o, m, n, k);
  } else {
    int8_matmul_kernel<false><<<grid, NTHREADS, 0, st>>>(x, xs, w, ws, o, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
