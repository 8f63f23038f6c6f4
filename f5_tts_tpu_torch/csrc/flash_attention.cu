// Masked flash attention, forward, for Hopper (sm_90a): kernels A, C and F.
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
// Bound on the H100: at dh = 64 the work is 4 n kv dh operations per
// (b, h) for kv valid keys, against 4 n dh bf16 reads and writes: ~n/2
// operations per byte, compute-bound at the bf16 tensor-core rate (989
// TFLOP/s) for n above ~600.  Kernel C adds n fp32 values of L and no
// products.
//
// Design, that of the backward kernels D and E.  A block is one to three
// warpgroups (4 warps); a warpgroup owns 64 query rows, held in registers
// as wgmma A fragments (loaded once by ldmatrix).  The key loop streams
// 64-row K and V tiles through a ring of STAGES shared-memory stages: raw
// 16-byte cp.async copies (zero-filled past n), issued STAGES - 1 tiles
// ahead, one barrier per tile.  Each tile stays row-major, as it lies in
// device memory, in the 128-byte swizzled layout wgmma reads, so K is the
// K-major right operand of S = q.k^T and V the MN-major (transposed) right
// operand of O += P.V: no transposed copy of V is written.  Both products
// run on wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulate); P is packed
// from the score accumulators into A fragments.  The online softmax keeps
// the running max of the raw scores; its row sums stay per thread until
// the epilogue.  (Variants timed on the card did not beat this loop at
// the training shape: tile j's q.k^T issued before tile j - 1's P.V so
// that the softmax runs while P.V is in the tensor cores, 128-key tiles, a
// polynomial exp2 for part of the scores; PERF.md.)  The key loop visits
// only the tiles holding a valid key (common.cuh key_tiles: the prefix
// tiles and, in the two-segment mode, the tiles covering [seg, seg +
// len_t), skipping the gap); the tiles it skips contribute exactly 0.  A tile wholly inside a valid segment skips
// the per-key test (KeyMask::all); a tile across a boundary keeps it, so
// no length and no seg is rejected.  o leaves through shared memory in
// 16-byte stores; its type is a template parameter (the kernels read bf16
// operands only: the wrapper casts fp32 inputs, and fp32 callers get an
// fp32 output).  The configurations (rows per block, stages) built are
// those timed on the card; the wrappers choose one
// (ops/flash_attention.py FWD_CONFIG).
//
// Rounding: q, k, v are bf16; the scores are the raw bf16 products q.k^T
// in fp32, and scale * log2(e) is applied in fp32 inside the exponent,
// p = exp2((s - m) * qscale), as kernels D and E recompute it from L, so
// the backward's p is the forward's own.  The TPU kernels round
// q * scale * log2(e) to bf16 before the product instead (_kernel :160,
// _kernel_fwd_stats :55).  p is rounded to bf16 for P.V, as there; the row
// sums are taken of the fp32 p.

#include "common.cuh"  // the wgmma, swizzle and ring helpers

namespace {

using bf16 = __nv_bfloat16;

constexpr int DH = 64;                 // head dim (all F5-TTS configs)
constexpr int TILE = 64;               // keys of a streamed tile
constexpr int TILE_BYTES = TILE * kSwRow;
constexpr float LOG2E_F = 1.4426950408889634f;
constexpr float NO_KEY_LSE = -1e30f;  // L of a row with no valid key

// One staged key tile [k0, k0 + TILE) for a warpgroup's 64 query rows
// (this thread: rows g and g + 8 of its warp's 16, as lo and hi): the
// scores, the online softmax (m the running max of the raw scores, l the
// running sums of this thread's columns, summed over the quad at the end),
// then O += P.V.  MASK tests each key column; a tile wholly valid skips it.
template <bool MASK>
__device__ __forceinline__ void fwd_tile(uint64_t kdesc, uint64_t vdesc, int k0,
                                         const KeyMask& km, const uint32_t (&qa)[4][4],
                                         float qscale, float (&acc)[32], float& m_lo,
                                         float& m_hi, float& l_lo, float& l_hi, int lane) {
  const int t4 = lane & 3;
  float s[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n64<0>(s, qa[kk], kdesc + 2 * kk, kk);  // q.k^T
  wg_commit();
  wg_wait<0>();
  hold(s);
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (MASK) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!km.valid(k0 + j * 8 + t4 * 2 + (e & 1))) s[4 * j + e] = -INFINITY;
      }
    }
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  // a row's 64 columns live in the 4 lanes of its quad
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  // every tile visited holds a valid key, so the new max is finite; the
  // old one is -inf on the first tile, where the rescale is exp2(-inf) = 0
  const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
  const float a_lo = fast_exp2((m_lo - mn_lo) * qscale);
  const float a_hi = fast_exp2((m_hi - mn_hi) * qscale);
  const float nb_lo = -mn_lo * qscale, nb_hi = -mn_hi * qscale;
  m_lo = mn_lo;
  m_hi = mn_hi;
  uint32_t pa[4][4];
  float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = fast_exp2(fmaf(s[4 * j + e], qscale, e < 2 ? nb_lo : nb_hi));
    rs_lo += p[0] + p[1];
    rs_hi += p[2] + p[3];
    pack_a<4>(pa, j, p);
  }
  l_lo = l_lo * a_lo + rs_lo;
  l_hi = l_hi * a_hi + rs_hi;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[4 * j] *= a_lo;
    acc[4 * j + 1] *= a_lo;
    acc[4 * j + 2] *= a_hi;
    acc[4 * j + 3] *= a_hi;
  }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n64<1>(acc, pa[kk], vdesc + 128 * kk, 1);  // P.V
  wg_commit();
  wg_wait<0>();
  hold(acc);
  hold(pa);
}

template <int WARPS, int STAGES>
struct FwdSmem {
  static constexpr int ROWS = WARPS * 16;
  static constexpr int kQ = ROWS * kSwRow;       // the q block (bytes)
  static constexpr int kStage = 2 * TILE_BYTES;  // K tile, V tile
  static constexpr int bytes = kQ + STAGES * kStage;
  static_assert(bytes >= store_rows_bytes<float, WARPS * 32>(),
                "the epilogue stages fp32 rows in place");
};

template <int WARPS, int STAGES, typename TO, bool WITH_LSE, bool SEG>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 ? 3 : 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ lens, TO* __restrict__ o,
                 float* __restrict__ lse, int heads, int n, int seg, float qscale) {
  using S = FwdSmem<WARPS, STAGES>;
  constexpr int NT = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* ring = sQ + S::kQ;  // STAGES x (K tile, V tile)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * S::ROWS;
  const KeyMask km = key_mask<SEG>(lens, bh / heads, n, seg);
  const KeyTiles tiles = key_tiles(km, TILE);
  const int n_tiles = tiles.count();  // every tile visited holds a valid key
  const size_t base = static_cast<size_t>(bh) * n * DH;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of the raw scores
  float l_lo = 0.f, l_hi = 0.f;              // running sums, this thread's columns

  if (n_tiles > 0) {
    load_rows<NT>(sQ, q + base, n, q0, S::ROWS);
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < n_tiles) {
        const int kt = tiles.tile(st) * TILE;
        load_rows<NT>(ring + st * S::kStage, k + base, n, kt, TILE);
        load_rows<NT>(ring + st * S::kStage + TILE_BYTES, v + base, n, kt, TILE);
      }
      cp_async_commit();
    }
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    uint32_t qa[4][4];
    load_a(sQ, wr, lane, qa);

    for (int it = 0; it < n_tiles; ++it) {
      // tile it has landed; every warpgroup is done with tile it - 1, whose
      // stage takes tile it + STAGES - 1
      const int nxt = it + STAGES - 1;
      if (nxt < n_tiles) {
        unsigned char* st = ring + (nxt % STAGES) * S::kStage;
        const int kt = tiles.tile(nxt) * TILE;
        load_rows<NT>(st, k + base, n, kt, TILE);
        load_rows<NT>(st + TILE_BYTES, v + base, n, kt, TILE);
      }
      cp_async_commit();
      const unsigned char* tk = ring + (it % STAGES) * S::kStage;
      const uint64_t kdesc = sw128_desc(tk), vdesc = sw128_desc(tk + TILE_BYTES);
      const int k0 = tiles.tile(it) * TILE;
      if (km.all(k0, k0 + TILE)) {
        fwd_tile<false>(kdesc, vdesc, k0, km, qa, qscale, acc, m_lo, m_hi, l_lo, l_hi, lane);
      } else {
        fwd_tile<true>(kdesc, vdesc, k0, km, qa, qscale, acc, m_lo, m_hi, l_lo, l_hi, lane);
      }
      cp_async_wait<STAGES - 2>();
      fence_proxy_async();
      __syncthreads();
    }
    cp_async_wait<0>();  // only empty groups can remain
  }
  // the quad's four partial row sums; a row with no valid key keeps l = 0
  // and acc = 0, so o = 0
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f, inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[4 * j] *= inv_lo;
    acc[4 * j + 1] *= inv_lo;
    acc[4 * j + 2] *= inv_hi;
    acc[4 * j + 3] *= inv_hi;
  }
  if constexpr (WITH_LSE) {
    // natural-log logsumexp from the raw-score max and the sum: the four
    // lanes of a quad hold the same row values, lane t4 == 0 writes them
    const int r_lo = q0 + wr + (lane >> 2), r_hi = r_lo + 8;
    if ((lane & 3) == 0) {
      float* dst = lse + static_cast<size_t>(bh) * n;
      if (r_lo < n) {
        dst[r_lo] = l_lo > 0.f ? (m_lo * qscale + log2f(l_lo)) * (1.f / LOG2E_F) : NO_KEY_LSE;
      }
      if (r_hi < n) {
        dst[r_hi] = l_hi > 0.f ? (m_hi * qscale + log2f(l_hi)) * (1.f / LOG2E_F) : NO_KEY_LSE;
      }
    }
  }
  // the tiles were last read before the loop's last barrier
  store_rows<TO, NT>(o + base + static_cast<size_t>(q0) * DH, min(S::ROWS, n - q0), smem, acc,
                     1.f, lane);
}

struct FwdArgs {
  const bf16 *q, *k, *v;
  const int* lens;
  void* o;
  float* lse;
  int b, h, n, seg;
  float qscale;
  cudaStream_t st;
};

template <int WARPS, int STAGES, typename TO, bool WITH_LSE, bool SEG>
int launch_cfg(const FwdArgs& a) {
  constexpr int bytes = FwdSmem<WARPS, STAGES>::bytes + 1024;
  auto kern = flash_fwd_kernel<WARPS, STAGES, TO, WITH_LSE, SEG>;
  if (int err = static_cast<int>(
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))) {
    return err;
  }
  const dim3 grid((a.n + WARPS * 16 - 1) / (WARPS * 16), a.b * a.h);
  kern<<<grid, WARPS * 32, bytes, a.st>>>(a.q, a.k, a.v, a.lens, static_cast<TO*>(a.o), a.lse,
                                           a.h, a.n, a.seg, a.qscale);
  return static_cast<int>(cudaGetLastError());
}

// The configurations built, (rows per block, ring stages):
// (64, 2), (64, 3), (128, 2), (128, 3), (192, 2)
template <typename TO, bool WITH_LSE, bool SEG>
int dispatch(const FwdArgs& a, int rows, int stages) {
  if (rows == 64 && stages == 2) return launch_cfg<4, 2, TO, WITH_LSE, SEG>(a);
  if (rows == 64 && stages == 3) return launch_cfg<4, 3, TO, WITH_LSE, SEG>(a);
  if (rows == 128 && stages == 2) return launch_cfg<8, 2, TO, WITH_LSE, SEG>(a);
  if (rows == 128 && stages == 3) return launch_cfg<8, 3, TO, WITH_LSE, SEG>(a);
  if (rows == 192 && stages == 2) return launch_cfg<12, 2, TO, WITH_LSE, SEG>(a);
  return cudaErrorInvalidValue;
}

template <bool WITH_LSE, bool SEG>
int launch_fwd(const void* q, const void* k, const void* v, const void* lens, void* o, float* lse,
               int b, int h, int n, int dh, int out_dtype, int seg, int rows, int stages,
               float qscale, void* stream) {
  if (dh != DH || n <= 0 || b <= 0 || h <= 0 || b * h > 65535) return cudaErrorInvalidValue;
  if (SEG && (seg < 0 || seg > n)) return cudaErrorInvalidValue;
  const FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const int*>(lens), o, lse, b, h, n,
                  SEG ? seg : 0, qscale, static_cast<cudaStream_t>(stream)};
  if (out_dtype == kBFloat16) return dispatch<bf16, WITH_LSE, SEG>(a, rows, stages);
  if (out_dtype == kFloat32) return dispatch<float, WITH_LSE, SEG>(a, rows, stages);
  return cudaErrorInvalidValue;
}

}  // namespace

F5_EXPORT_ERROR_STRING

// Kernel A.  q, k, v: bf16 [b, h, n, dh] contiguous; o: [b, h, n, dh] of
// out_dtype (kFloat32 or kBFloat16); lens: int32 [b] on the device.
// (rows, stages): a built configuration, (64, 2), (64, 3), (128, 2),
// (128, 3) or (192, 2).  qscale = scale * log2(e).  Returns
// cudaGetLastError() (or the error of the shared-memory attribute).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* lens,
                                   void* o, int b, int h, int n, int dh, int out_dtype, int rows,
                                   int stages, float qscale, void* stream) {
  return launch_fwd<false, false>(q, k, v, lens, o, nullptr, b, h, n, dh, out_dtype, 0, rows,
                                  stages, qscale, stream);
}

// Kernel C: as flash_attention_fwd, plus lse: fp32 [b, h, n] contiguous.
extern "C" int flash_attention_fwd_stats(const void* q, const void* k, const void* v,
                                         const void* lens, void* o, void* lse, int b, int h,
                                         int n, int dh, int out_dtype, int rows, int stages,
                                         float qscale, void* stream) {
  return launch_fwd<true, false>(q, k, v, lens, o, static_cast<float*>(lse), b, h, n, dh,
                                 out_dtype, 0, rows, stages, qscale, stream);
}

// Kernel F: as flash_attention_fwd with the two-segment key mask; lens:
// int32 [b, 2] (len_a, len_t) on the device, 0 <= seg <= n.
extern "C" int flash_attention_fwd_seg(const void* q, const void* k, const void* v,
                                       const void* lens, void* o, int b, int h, int n, int dh,
                                       int out_dtype, int seg, int rows, int stages, float qscale,
                                       void* stream) {
  return launch_fwd<false, true>(q, k, v, lens, o, nullptr, b, h, n, dh, out_dtype, seg, rows,
                                 stages, qscale, stream);
}

// Kernel C in the two-segment mode: as flash_attention_fwd_stats, with lens
// and seg as flash_attention_fwd_seg.
extern "C" int flash_attention_fwd_stats_seg(const void* q, const void* k, const void* v,
                                             const void* lens, void* o, void* lse, int b, int h,
                                             int n, int dh, int out_dtype, int seg, int rows,
                                             int stages, float qscale, void* stream) {
  return launch_fwd<true, true>(q, k, v, lens, o, static_cast<float*>(lse), b, h, n, dh,
                                out_dtype, seg, rows, stages, qscale, stream);
}
