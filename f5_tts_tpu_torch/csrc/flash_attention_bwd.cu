// Masked flash attention, backward, for Hopper (sm_90a): kernels D and E.
//
// Replace the two Pallas TPU kernels of f5_tts_tpu/ops/flash_attention.py::
// _flash_bwd, the backward of the training VJP (flash_attention_trainable,
// flash_attention_with_stats):
//   kernel D (_kernel_dq):  dq_i = scale * sum_j ds_ij k_j
//   kernel E (_kernel_dkv): dv_j = sum_i p_ij do_i,  dk_j = scale * sum_i ds_ij q_i
// with p_ij = exp(s_ij - L_i) recomputed from the forward's natural-log
// logsumexp L (kernel C), ds_ij = p_ij (do_i . v_j - D_i), D_i the caller's
// rowsum(do_i * o_i) (minus the logsumexp cotangent, for
// flash_attention_with_stats).  Keys are valid only in [0, lens[b]); every
// query row is computed, padded ones included.  The SEG instances are the
// TPU kernels' two-segment mode (static `seg`, MMDiT's joint attention):
// lens int32 [b, 2] = (len_a, len_t), keys valid in
// [0, len_a) U [seg, seg + len_t) (common.cuh KeyMask).
//
// Design.  As in the TPU kernels the two halves are separate launches: D
// walks key tiles for a fixed query tile, E walks query tiles for a fixed
// key tile, so each output tile has one owner and no atomics are needed (the
// gradients are deterministic).  One block of 4 warps per (b*h, 64 rows);
// each warp owns 16 rows.  Products run on the tensor cores with mma.sync
// m16n8k16 (bf16 in, fp32 accumulate).  Operands are staged in shared memory
// as bf16 row-major, and transposed where a product needs them along its
// reduction axis (K for ds.k in D; q and do for ds^T.q and p^T.do in E), so
// every B fragment is one 32-bit load; shared memory stays below 38 KB
// whatever n is.  Rounding follows the TPU kernels: q prescaled by
// scale*log2(e) then rounded to bf16 for the scores (p = exp2(s2 - L log2 e)),
// raw q, k, v, do, p and ds rounded to bf16 for the products.  p is forced
// to 0 on masked keys.  D visits only the key tiles holding a valid key
// (common.cuh key_tiles: the prefix, and in the two-segment mode the tiles
// covering the second segment, skipping the gap); E writes zeros for a key
// tile that holds no valid key in either segment and returns.
//
// Bound on the H100: per (b, h), with kv valid keys, D does 6*n*kv*dh flops
// and E 8*n*kv*dh against ~(5*n*dh*2 + 2*n*4) bytes, i.e. ~n flops per byte:
// compute-bound at the bf16 tensor-core rate for n above a few hundred.
// This first version runs mma.sync from registers with no TMA / wgmma
// pipelining and restages the transposed operands through shared memory,
// so it reaches a fraction of that rate; the wgmma + TMA version is later
// work.

#include "common.cuh"

namespace {

constexpr int DH = 64;         // head dim (all F5-TTS configs)
constexpr int BR = 64;         // rows (queries in D, keys in E) per block and per staged tile
constexpr int NTHREADS = 128;  // 4 warps x 16 rows
constexpr int LDS = DH + 8;    // padded row-major tile row (bf16)
constexpr int LDT = BR + 8;    // padded transposed tile row (bf16)
constexpr float LOG2E_F = 1.4426950408889634f;

// Stage rows [r0, r0 + BR) of a [n, DH] matrix as bf16: row-major into rm
// (scaled by mul before rounding) and, when tr is given, transposed and
// unscaled into tr.  Rows past n are zero.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int r0, int n, float mul,
                                      __nv_bfloat16 (*rm)[LDS], __nv_bfloat16 (*tr)[LDT]) {
  for (int idx = threadIdx.x; idx < BR * DH / 8; idx += NTHREADS) {
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) load8(src + static_cast<size_t>(r0 + r) * DH + c, f);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      *reinterpret_cast<uint32_t*>(&rm[r][c + e]) = pack_bf16(f[e] * mul, f[e + 1] * mul);
    }
    if (tr != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) tr[c + e][r] = __float2bfloat16(f[e]);
    }
  }
}

// A fragments of rows [w0, w0 + 16) of a staged tile, 4 chunks of 16 columns
__device__ __forceinline__ void load_a(const __nv_bfloat16 (*t)[LDS], int w0, int g, int t4,
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + t4 * 2;
    a[kc][0] = ld_u32(&t[w0 + g][c]);
    a[kc][1] = ld_u32(&t[w0 + g + 8][c]);
    a[kc][2] = ld_u32(&t[w0 + g][c + 8]);
    a[kc][3] = ld_u32(&t[w0 + g + 8][c + 8]);
  }
}

// acc(16 x 8) += A(16 x 64) . B, B(k, col) = S[col0 + g][k] for the 8 columns
__device__ __forceinline__ void mma_row(float* acc, const uint32_t (&a)[4][4],
                                        const __nv_bfloat16* srow, int t4) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + t4 * 2;
    mma_16816(acc, a[kc], ld_u32(srow + c), ld_u32(srow + c + 8));
  }
}

// Pack C fragment j (columns 8j..8j+7) of a 16 x 64 fp32 tile into the A
// fragments of the same tile used as the left operand of the next product
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], int j, const float* c) {
  const int kc = j >> 1, hi = (j & 1) * 2;
  a[kc][hi] = pack_bf16(c[0], c[1]);
  a[kc][hi + 1] = pack_bf16(c[2], c[3]);
}

template <typename T, bool SEG>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ lens,
                    T* __restrict__ dq, int heads, int n, int seg, float qscale, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sA[BR][LDS];  // q tile, then each K tile
  __shared__ __align__(16) __nv_bfloat16 sB[BR][LDS];  // do tile, then each V tile
  __shared__ __align__(16) __nv_bfloat16 sKt[DH][LDT];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BR;
  const KeyMask km = key_mask<SEG>(lens, bh / heads, n, seg);
  const KeyTiles tiles = key_tiles(km, BR);
  const size_t base = static_cast<size_t>(bh) * n * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;

  stage(q + base, q0, n, qscale, sA, nullptr);
  stage(dout + base, q0, n, 1.f, sB, nullptr);
  __syncthreads();
  uint32_t qa[4][4], doa[4][4];
  load_a(sA, wr, g, t4, qa);
  load_a(sB, wr, g, t4, doa);

  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  const float* lrow = lse + static_cast<size_t>(bh) * n;
  const float* drow = delta + static_cast<size_t>(bh) * n;
  const float l2_lo = r_lo < n ? lrow[r_lo] * LOG2E_F : 0.f;
  const float l2_hi = r_hi < n ? lrow[r_hi] * LOG2E_F : 0.f;
  const float d_lo = r_lo < n ? drow[r_lo] : 0.f;
  const float d_hi = r_hi < n ? drow[r_hi] : 0.f;

  float acc[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const int n_tiles = tiles.count();  // every tile visited has >= 1 valid key
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = tiles.tile(it) * BR;
    __syncthreads();  // the previous tile (or the q / do fragments) is consumed
    stage(k + base, k0, n, 1.f, sA, sKt);
    stage(v + base, k0, n, 1.f, sB, nullptr);
    __syncthreads();

    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_row(s, qa, &sA[j * 8 + g][0], t4);   // log2-domain scores q.k^T
      mma_row(dp, doa, &sB[j * 8 + g][0], t4);  // do.v^T
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        const float p = km.valid(col) ? exp2f(s[e] - (e < 2 ? l2_lo : l2_hi)) : 0.f;
        ds[e] = p * (dp[e] - (e < 2 ? d_lo : d_hi));
      }
      pack_a(dsa, j, ds);
    }
#pragma unroll
    for (int d = 0; d < 8; ++d) mma_row(acc[d], dsa, &sKt[d * 8 + g][0], t4);  // ds.k
  }

#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int c = d * 8 + t4 * 2;
    if (r_lo < n) {
      T* dst = dq + base + static_cast<size_t>(r_lo) * DH + c;
      dst[0] = from_float<T>(acc[d][0] * scale);
      dst[1] = from_float<T>(acc[d][1] * scale);
    }
    if (r_hi < n) {
      T* dst = dq + base + static_cast<size_t>(r_hi) * DH + c;
      dst[0] = from_float<T>(acc[d][2] * scale);
      dst[1] = from_float<T>(acc[d][3] * scale);
    }
  }
}

template <typename T, bool SEG>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ lens,
                     T* __restrict__ dk, T* __restrict__ dv, int heads, int n, int seg,
                     float qscale, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQs[BR][LDS];  // K tile, then each prescaled q tile
  __shared__ __align__(16) __nv_bfloat16 sDO[BR][LDS];  // V tile, then each do tile
  __shared__ __align__(16) __nv_bfloat16 sQt[DH][LDT];  // raw q, transposed
  __shared__ __align__(16) __nv_bfloat16 sDOt[DH][LDT];
  __shared__ float sL2[BR], sD[BR];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BR;
  const KeyMask km = key_mask<SEG>(lens, bh / heads, n, seg);
  const size_t base = static_cast<size_t>(bh) * n * DH;

  if (!km.any(k0, k0 + BR)) {  // no valid key in this tile: its gradients are exactly 0
    for (int idx = threadIdx.x; idx < BR * DH; idx += NTHREADS) {
      const int r = idx / DH;
      if (k0 + r < n) {
        const size_t off = base + static_cast<size_t>(k0) * DH + idx;
        dk[off] = from_float<T>(0.f);
        dv[off] = from_float<T>(0.f);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wk = warp * 16;

  stage(k + base, k0, n, 1.f, sQs, nullptr);
  stage(v + base, k0, n, 1.f, sDO, nullptr);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_a(sQs, wk, g, t4, ka);
  load_a(sDO, wk, g, t4, va);

  const int r_lo = k0 + wk + g, r_hi = r_lo + 8;
  const bool valid_lo = km.valid(r_lo), valid_hi = km.valid(r_hi);
  const float* lrow = lse + static_cast<size_t>(bh) * n;
  const float* drow = delta + static_cast<size_t>(bh) * n;

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    dka[d][0] = dka[d][1] = dka[d][2] = dka[d][3] = 0.f;
    dva[d][0] = dva[d][1] = dva[d][2] = dva[d][3] = 0.f;
  }

  const int n_qt = (n + BR - 1) / BR;
  for (int it = 0; it < n_qt; ++it) {
    const int q0 = it * BR;
    __syncthreads();  // the previous tile (or the k / v fragments) is consumed
    stage(q + base, q0, n, qscale, sQs, sQt);
    stage(dout + base, q0, n, 1.f, sDO, sDOt);
    for (int i = threadIdx.x; i < BR; i += NTHREADS) {
      const bool in = q0 + i < n;
      sL2[i] = in ? lrow[q0 + i] * LOG2E_F : 0.f;
      sD[i] = in ? drow[q0 + i] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are this warp's 16 keys, columns the 64 queries
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_row(s, ka, &sQs[j * 8 + g][0], t4);   // log2-domain scores k.q^T
      mma_row(dp, va, &sDO[j * 8 + g][0], t4);  // v.do^T
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t4 * 2 + (e & 1);
        const bool ok = (e < 2 ? valid_lo : valid_hi) && q0 + qc < n;
        p[e] = ok ? exp2f(s[e] - sL2[qc]) : 0.f;
        ds[e] = p[e] * (dp[e] - sD[qc]);
      }
      pack_a(pa, j, p);
      pack_a(dsa, j, ds);
    }
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      mma_row(dva[d], pa, &sDOt[d * 8 + g][0], t4);  // p^T.do
      mma_row(dka[d], dsa, &sQt[d * 8 + g][0], t4);  // ds^T.q
    }
  }

#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int c = d * 8 + t4 * 2;
    if (r_lo < n) {
      const size_t off = base + static_cast<size_t>(r_lo) * DH + c;
      dk[off] = from_float<T>(dka[d][0] * scale);
      dk[off + 1] = from_float<T>(dka[d][1] * scale);
      dv[off] = from_float<T>(dva[d][0]);
      dv[off + 1] = from_float<T>(dva[d][1]);
    }
    if (r_hi < n) {
      const size_t off = base + static_cast<size_t>(r_hi) * DH + c;
      dk[off] = from_float<T>(dka[d][2] * scale);
      dk[off + 1] = from_float<T>(dka[d][3] * scale);
      dv[off] = from_float<T>(dva[d][2]);
      dv[off + 1] = from_float<T>(dva[d][3]);
    }
  }
}

template <bool SEG>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* lens, void* dq, int b, int h, int n, int dh,
              int dtype, int seg, float qscale, float scale, void* stream) {
  if (dh != DH || n <= 0 || b <= 0 || h <= 0 || b * h > 65535) return cudaErrorInvalidValue;
  if (SEG && (seg < 0 || seg > n)) return cudaErrorInvalidValue;
  const dim3 grid((n + BR - 1) / BR, b * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* L = static_cast<const float*>(lse);
  const float* D = static_cast<const float*>(delta);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    flash_bwd_dq_kernel<T, SEG><<<grid, NTHREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), L, D, ln, static_cast<T*>(dq), h, n, seg, qscale, scale);
  } else if (dtype == kFloat32) {
    using T = float;
    flash_bwd_dq_kernel<T, SEG><<<grid, NTHREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), L, D, ln, static_cast<T*>(dq), h, n, seg, qscale, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool SEG>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* lens, void* dk, void* dv, int b, int h, int n,
               int dh, int dtype, int seg, float qscale, float scale, void* stream) {
  if (dh != DH || n <= 0 || b <= 0 || h <= 0 || b * h > 65535) return cudaErrorInvalidValue;
  if (SEG && (seg < 0 || seg > n)) return cudaErrorInvalidValue;
  const dim3 grid((n + BR - 1) / BR, b * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* L = static_cast<const float*>(lse);
  const float* D = static_cast<const float*>(delta);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    flash_bwd_dkv_kernel<T, SEG><<<grid, NTHREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), L, D, ln, static_cast<T*>(dk), static_cast<T*>(dv), h, n,
        seg, qscale, scale);
  } else if (dtype == kFloat32) {
    using T = float;
    flash_bwd_dkv_kernel<T, SEG><<<grid, NTHREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), L, D, ln, static_cast<T*>(dk), static_cast<T*>(dv), h, n,
        seg, qscale, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

F5_EXPORT_ERROR_STRING

// Kernel D.  q, k, v, dout, dq: [b, h, n, dh] contiguous, of one dtype
// (kFloat32 or kBFloat16); lse, delta: fp32 [b, h, n]; lens: int32 [b].
// qscale = scale * log2(e).  Returns cudaGetLastError().
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* lens, void* dq, int b, int h, int n, int dh,
                                      int dtype, float qscale, float scale, void* stream) {
  return launch_dq<false>(q, k, v, dout, lse, delta, lens, dq, b, h, n, dh, dtype, 0, qscale,
                          scale, stream);
}

// Kernel E.  As kernel D, with dk, dv: [b, h, n, dh] in the inputs' dtype.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* lens, void* dk, void* dv, int b, int h, int n,
                                       int dh, int dtype, float qscale, float scale,
                                       void* stream) {
  return launch_dkv<false>(q, k, v, dout, lse, delta, lens, dk, dv, b, h, n, dh, dtype, 0,
                           qscale, scale, stream);
}

// Kernel D in the two-segment mode: lens int32 [b, 2] (len_a, len_t),
// 0 <= seg <= n.
extern "C" int flash_attention_bwd_dq_seg(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* lens, void* dq, int b, int h, int n,
                                          int dh, int dtype, int seg, float qscale, float scale,
                                          void* stream) {
  return launch_dq<true>(q, k, v, dout, lse, delta, lens, dq, b, h, n, dh, dtype, seg, qscale,
                         scale, stream);
}

// Kernel E in the two-segment mode: lens and seg as kernel D's.
extern "C" int flash_attention_bwd_dkv_seg(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* lens, void* dk, void* dv, int b, int h,
                                           int n, int dh, int dtype, int seg, float qscale,
                                           float scale, void* stream) {
  return launch_dkv<true>(q, k, v, dout, lse, delta, lens, dk, dv, b, h, n, dh, dtype, seg,
                          qscale, scale, stream);
}
