// Masked flash attention, forward, for Hopper (sm_90a): kernels A and C.
//
// Kernel A replaces the Pallas TPU kernel f5_tts_tpu/ops/flash_attention.py::
// _kernel (called through _flash / flash_attention).  Computes, per (batch,
// head),
//   o = softmax(q k^T / sqrt(dh), keys restricted to [0, lens[b])) v
// over q, k, v [b, h, n, 64]; a query row with no valid key gives 0.
//
// Kernel C (the same template with WITH_LSE) replaces _kernel_fwd_stats
// (called through _flash_fwd_stats), the forward of the training VJP: it
// also writes the natural-log logsumexp L_i = ln sum_{j valid} exp(s_ij)
// as fp32 [b, h, n], and L = -1e30 for a row with no valid key.  The
// backward kernels (flash_attention_bwd.cu) recompute p from it.
//
// Kernel F (the template with SEG) replaces _kernel_seg (called through
// _flash_seg / flash_attention_two_segment), MMDiT's joint attention over
// the concatenated [audio, text] sequence: keys are valid in
// [0, len_a) U [seg, seg + len_t), lens int32 [b, 2].  With WITH_LSE too it
// is kernel C's two-segment mode, _kernel_fwd_stats with a static `seg`.
// A row whose two segments are both empty gives o = 0 and L = -1e30 (the
// TPU kernel gives the mean of v there).
//
// Design.  One block of 4 warps per (b*h, tile of 64 query rows); each warp
// owns 16 rows.  The block loops over key tiles of 64 staged in shared
// memory (K row-major, V transposed), so any n works and shared memory stays
// at 27 KB whatever n is: the TPU kernel's whole-row [n, 64] K/V residency
// (512 KB each at n = 4096) does not fit Hopper's 227 KB.  Scores and P.V run
// on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate); the
// online softmax runs in the exp2 domain with scale*log2(e) folded into q
// before its bf16 cast, as the TPU kernel does.  The key loop visits only
// the tiles holding a valid key (common.cuh key_tiles): the prefix tiles
// and, in the two-segment mode, the tiles covering [seg, seg + len_t),
// skipping the gap between the segments; the tiles it skips contribute
// exactly 0.  Every visited tile keeps the per-column test, so a segment
// boundary inside a tile (seg need not be a multiple of 64) and the ragged
// query / key tails are masked, and no length is rejected.
//
// Bound on the H100: at dh = 64 the work is 4*n*n*dh flops per (b, h)
// against 4*n*dh*2 bytes moved, i.e. ~n/2 flops per byte: compute-bound for
// n above ~600 at the bf16 tensor-core rate.  This first version issues
// mma.sync from registers with no TMA / wgmma pipelining, so it reaches a
// fraction of that rate; the wgmma + TMA version is later work.  Kernel C
// adds n*4 bytes of L and no products, so the same bound holds for it; in
// the two-segment mode the work is 4*n*kv*dh flops for kv = len_a + len_t
// valid keys.

#include "common.cuh"

namespace {

constexpr int DH = 64;        // head dim (all F5-TTS configs)
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int NTHREADS = 128; // 4 warps x 16 query rows
constexpr int LDS = DH + 8;   // padded row (bf16): conflict-free fragment loads
constexpr float LOG2E_F = 1.4426950408889634f;
constexpr float NO_KEY_LSE = -1e30f;  // L of a row with no valid key

template <typename T, bool WITH_LSE, bool SEG>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ lens, T* __restrict__ o, float* __restrict__ lse,
                 int heads, int n, int seg, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ][LDS];
  __shared__ __align__(16) __nv_bfloat16 sK[BK][LDS];
  __shared__ __align__(16) __nv_bfloat16 sVt[DH][BK + 8];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const KeyMask km = key_mask<SEG>(lens, bh / heads, n, seg);
  const KeyTiles tiles = key_tiles(km, BK);
  const size_t base = static_cast<size_t>(bh) * n * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair

  // q tile, prescaled in fp32 by scale*log2(e), then rounded to bf16
  for (int idx = tid; idx < BQ * DH / 8; idx += NTHREADS) {
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < n) load8(q + base + static_cast<size_t>(q0 + r) * DH + c, f);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      *reinterpret_cast<uint32_t*>(&sQ[r][c + e]) = pack_bf16(f[e] * qscale, f[e + 1] * qscale);
    }
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qa[4][4];  // A fragments of this warp's 16 x 64 q rows, 4 k-chunks
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + t4 * 2;
    qa[kc][0] = ld_u32(&sQ[wr + g][c]);
    qa[kc][1] = ld_u32(&sQ[wr + g + 8][c]);
    qa[kc][2] = ld_u32(&sQ[wr + g][c + 8]);
    qa[kc][3] = ld_u32(&sQ[wr + g + 8][c + 8]);
  }

  float acc[8][4];  // o accumulators: 8 column tiles of 8 (dh = 64)
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;              // running denominators

  const int n_tiles = tiles.count();  // every tile visited has >= 1 valid key
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = tiles.tile(it) * BK;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * DH / 8; idx += NTHREADS) {
      const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
      float fk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float fv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + r < n) {
        load8(k + base + static_cast<size_t>(k0 + r) * DH + c, fk);
        load8(v + base + static_cast<size_t>(k0 + r) * DH + c, fv);
      }
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        *reinterpret_cast<uint32_t*>(&sK[r][c + e]) = pack_bf16(fk[e], fk[e + 1]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[c + e][r] = __float2bfloat16(fv[e]);
    }
    __syncthreads();

    // scores s = (q * scale * log2e) k^T: 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const int c = kc * 16 + t4 * 2;
        mma_16816(s[j], qa[kc], ld_u32(&sK[j * 8 + g][c]), ld_u32(&sK[j * 8 + g][c + 8]));
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        if (!km.valid(col)) s[j][e] = -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    // a row's 64 columns live in the 4 lanes of its quad
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);  // finite
    const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);   // 0 on the first tile

    // p = exp2(s - m): fp32 for the row sums, bf16 A fragments for P.V
    uint32_t pa[4][4];
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - mn_lo), p1 = exp2f(s[j][1] - mn_lo);
      const float p2 = exp2f(s[j][2] - mn_hi), p3 = exp2f(s[j][3] - mn_hi);
      rs_lo += p0 + p1;
      rs_hi += p2 + p3;
      const int kc = j >> 1, hi = (j & 1) * 2;
      pa[kc][hi] = pack_bf16(p0, p1);
      pa[kc][hi + 1] = pack_bf16(p2, p3);
    }
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 1);
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 2);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 1);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 2);
    l_lo = l_lo * a_lo + rs_lo;
    l_hi = l_hi * a_hi + rs_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;

#pragma unroll
    for (int d = 0; d < 8; ++d) {
      acc[d][0] *= a_lo;
      acc[d][1] *= a_lo;
      acc[d][2] *= a_hi;
      acc[d][3] *= a_hi;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const int c = kc * 16 + t4 * 2;
        mma_16816(acc[d], pa[kc], ld_u32(&sVt[d * 8 + g][c]), ld_u32(&sVt[d * 8 + g][c + 8]));
      }
    }
  }

  // o = acc / max(l, 1e-30): a row with no valid key (no tile visited) stays 0
  const float dl = fmaxf(l_lo, 1e-30f), dh_ = fmaxf(l_hi, 1e-30f);
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int c = d * 8 + t4 * 2;
    if (r_lo < n) {
      T* dst = o + base + static_cast<size_t>(r_lo) * DH + c;
      dst[0] = from_float<T>(acc[d][0] / dl);
      dst[1] = from_float<T>(acc[d][1] / dl);
    }
    if (r_hi < n) {
      T* dst = o + base + static_cast<size_t>(r_hi) * DH + c;
      dst[0] = from_float<T>(acc[d][2] / dh_);
      dst[1] = from_float<T>(acc[d][3] / dh_);
    }
  }
  if constexpr (WITH_LSE) {
    // natural-log logsumexp from the log2-domain max and sum: the four lanes
    // of a quad hold the same row values, lane t4 == 0 writes them
    if (t4 == 0) {
      float* dst = lse + static_cast<size_t>(bh) * n;
      if (r_lo < n) dst[r_lo] = l_lo > 0.f ? (m_lo + log2f(l_lo)) * (1.f / LOG2E_F) : NO_KEY_LSE;
      if (r_hi < n) dst[r_hi] = l_hi > 0.f ? (m_hi + log2f(l_hi)) * (1.f / LOG2E_F) : NO_KEY_LSE;
    }
  }
}

template <bool WITH_LSE, bool SEG>
int launch_fwd(const void* q, const void* k, const void* v, const void* lens, void* o, float* lse,
               int b, int h, int n, int dh, int dtype, int seg, float qscale, void* stream) {
  if (dh != DH || n <= 0 || b <= 0 || h <= 0 || b * h > 65535) return cudaErrorInvalidValue;
  if (SEG && (seg < 0 || seg > n)) return cudaErrorInvalidValue;
  const dim3 grid((n + BQ - 1) / BQ, b * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    flash_fwd_kernel<__nv_bfloat16, WITH_LSE, SEG><<<grid, NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
        static_cast<__nv_bfloat16*>(o), lse, h, n, seg, qscale);
  } else if (dtype == kFloat32) {
    flash_fwd_kernel<float, WITH_LSE, SEG><<<grid, NTHREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const int*>(lens), static_cast<float*>(o), lse, h, n, seg, qscale);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

F5_EXPORT_ERROR_STRING

// q, k, v, o: [b, h, n, dh] contiguous, all of one dtype (kFloat32 or
// kBFloat16); lens: int32 [b] on the device.  Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* lens,
                                   void* o, int b, int h, int n, int dh, int dtype, float qscale,
                                   void* stream) {
  return launch_fwd<false, false>(q, k, v, lens, o, nullptr, b, h, n, dh, dtype, 0, qscale,
                                  stream);
}

// Kernel C: as flash_attention_fwd, plus lse: fp32 [b, h, n] contiguous.
extern "C" int flash_attention_fwd_stats(const void* q, const void* k, const void* v,
                                         const void* lens, void* o, void* lse, int b, int h,
                                         int n, int dh, int dtype, float qscale, void* stream) {
  return launch_fwd<true, false>(q, k, v, lens, o, static_cast<float*>(lse), b, h, n, dh, dtype,
                                 0, qscale, stream);
}

// Kernel F: as flash_attention_fwd with the two-segment key mask; lens:
// int32 [b, 2] (len_a, len_t) on the device, 0 <= seg <= n.
extern "C" int flash_attention_fwd_seg(const void* q, const void* k, const void* v,
                                       const void* lens, void* o, int b, int h, int n, int dh,
                                       int dtype, int seg, float qscale, void* stream) {
  return launch_fwd<false, true>(q, k, v, lens, o, nullptr, b, h, n, dh, dtype, seg, qscale,
                                 stream);
}

// Kernel C in the two-segment mode: as flash_attention_fwd_stats, with lens
// and seg as flash_attention_fwd_seg.
extern "C" int flash_attention_fwd_stats_seg(const void* q, const void* k, const void* v,
                                             const void* lens, void* o, void* lse, int b, int h,
                                             int n, int dh, int dtype, int seg, float qscale,
                                             void* stream) {
  return launch_fwd<true, true>(q, k, v, lens, o, static_cast<float*>(lse), b, h, n, dh, dtype,
                                seg, qscale, stream);
}
