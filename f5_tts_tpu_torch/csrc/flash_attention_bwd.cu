// Masked flash attention, backward, for Hopper (sm_90a): kernels D and E.
//
// Replace the two Pallas TPU kernels of f5_tts_tpu/ops/flash_attention.py::
// _flash_bwd, the backward of the training VJP (flash_attention_trainable,
// flash_attention_with_stats):
//   kernel D (_kernel_dq):  dq_i = scale * sum_j ds_ij k_j
//   kernel E (_kernel_dkv): dv_j = sum_i p_ij do_i,  dk_j = scale * sum_i ds_ij q_i
// with p_ij = exp(s_ij - L_i) recomputed from the forward's natural-log
// logsumexp L (kernel C) and 0 on masked keys, ds_ij = p_ij (do_i . v_j -
// D_i), D_i the caller's rowsum(do_i * o_i) (minus the logsumexp cotangent,
// for flash_attention_with_stats).  Keys are valid only in [0, lens[b]);
// every query row is computed, padded ones included.  The SEG instances are
// the TPU kernels' two-segment mode (static `seg`, MMDiT's joint attention):
// lens int32 [b, 2] = (len_a, len_t), keys valid in [0, len_a) U [seg,
// seg + len_t) (common.cuh KeyMask).
//
// Bound on the H100: per (b, h), with kv valid keys, D does 6 n kv dh
// operations (q.k^T, do.v^T, ds.k) and E 8 n kv dh (k.q^T, v.do^T, p^T.do,
// ds^T.q) against ~5-6 n dh bf16 reads and writes: ~n operations per byte,
// compute-bound at the bf16 tensor-core rate (989 TFLOP/s) for n above a
// few hundred.
//
// Design.  As in the TPU kernels the two halves are separate launches: D
// walks key tiles for a fixed block of query rows, E walks query tiles for
// a fixed block of key rows, so each output tile has one owner, nothing is
// atomic, and two calls on the same inputs give bitwise-equal gradients.
// A block is one or two warpgroups (4 warps); a warpgroup owns 64 rows.
// 64-row tiles of the streamed operands (K and V in D; q, do and their 64
// entries each of L and D in E) go through a ring of STAGES shared-memory
// stages.  Every product runs on wgmma.mma_async (m64nNk16, bf16 in, fp32
// accumulate): the left operand from registers (q and do in D, k and v in
// E, loaded once by ldmatrix; p and ds packed from the score accumulators),
// the right operand straight from the staged tile through a shared-memory
// descriptor.  The score products are two commit groups, so p is computed
// while do.v^T is still in the tensor cores (and, in E, ds while p^T.do
// is).  E takes its query tile 32 columns at a time (m64n32 score products)
// to stay within 168 registers, three blocks to an SM.  What each part
// fixes of the first version (64 rows x 4 warps on mma.sync, transposed
// restaging, synchronous loads):
//  - every tile stays row-major, as it lies in device memory, in the
//    128-byte swizzled layout wgmma reads (16-byte chunk c of row r at
//    chunk c ^ (r % 8)).  The same tile is the K-major operand of the score
//    products (k.q^T reads q's rows along dh) and the transposed (MN-major)
//    operand of the products that reduce over its rows (ds.k in D; p^T.do
//    and ds^T.q in E).  No transposed copy is written, so the 8-way bank
//    conflict of its 2-byte stores is gone, with its shared memory;
//  - tiles are raw 16-byte cp.async copies (zero-filled past n), issued
//    STAGES - 1 tiles ahead, with one barrier per tile: tile j + 1 is in
//    flight while tile j is in the tensor cores;
//  - the kernels take bf16 operands only (the wrapper casts fp32 inputs);
//    the output type is a template parameter, so fp32 callers get fp32
//    gradients without a cast of a bf16 result;
//  - a key tile (D), or a warpgroup's 64 key rows (E), that lies wholly
//    inside a valid segment skips the per-key test (KeyMask::all); boundary
//    tiles keep it.  D visits only tiles holding a valid key (key_tiles: the
//    gap between the segments is skipped), E writes exact zeros for a key
//    block with no valid key and returns;
//  - the gradients leave through shared memory in 16-byte coalesced
//    stores, where the first version stored one element at a time;
//  - the configurations (rows per block, stages) built are those timed on
//    the card; the wrappers choose one (ops/flash_attention.py DQ_CONFIG,
//    DKV_CONFIG).
// Rounding: q, k, v, do are bf16; the scores are the raw bf16 products
// q.k^T in fp32, and scale * log2(e) is applied in fp32 inside the
// exponent, p = exp2(s * qscale - L log2 e), in both kernels, so D and E
// use the same p.  The TPU kernels round q * scale * log2(e) to bf16
// before the product instead (_kernel_dq :90, _kernel_dkv :131); on bf16
// inputs the product here is exact where theirs rounds twice.  p and ds are
// rounded to bf16 for the products, as there.

#include "common.cuh"  // the wgmma, swizzle and ring helpers

namespace {

using bf16 = __nv_bfloat16;

constexpr int DH = 64;                 // head dim (all F5-TTS configs)
constexpr int TILE = 64;               // rows of a streamed tile
constexpr int ROWB = DH * 2;           // bytes of a tile row: one 128-byte swizzle row
constexpr int TILE_BYTES = TILE * ROWB;
constexpr int ECW = 32;                // E: query columns per score product
constexpr float LOG2E_F = 1.4426950408889634f;

// TILE entries [r0, r0 + TILE) of two fp32 rows (L, D) by 4-byte cp.async
template <int NT>
__device__ __forceinline__ void load_vec2(float* sl, float* sd, const float* __restrict__ l,
                                          const float* __restrict__ d, int n, int r0) {
  for (int i = threadIdx.x; i < 2 * TILE; i += NT) {
    const int r = i & (TILE - 1);
    const bool in = r0 + r < n;
    const float* src = i < TILE ? l : d;
    cp_async4((i < TILE ? sl : sd) + r, in ? src + r0 + r : src, in ? 4 : 0);
  }
}

// Kernel D's work on one staged key tile [k0, k0 + TILE) for a warpgroup's
// 64 query rows (this thread: rows g and g + 8 of its warp's 16).  MASK
// tests each key column; a tile wholly valid skips it.
template <bool MASK>
__device__ __forceinline__ void dq_tile(uint64_t kdesc, uint64_t vdesc, int k0, const KeyMask& km,
                                        const uint32_t (&qa)[4][4], const uint32_t (&doa)[4][4],
                                        float nl2_lo, float nl2_hi, float d_lo, float d_hi,
                                        float qscale, float (&acc)[32], int lane) {
  const int t4 = lane & 3;
  float s[32], dp[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n64<0>(s, qa[kk], kdesc + 2 * kk, kk);    // q.k^T
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n64<0>(dp, doa[kk], vdesc + 2 * kk, kk);  // do.v^T
  wg_commit();
  wg_wait<1>();  // the scores are in: p (in place) while do.v^T runs
  hold(s);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& p = s[4 * j + e];
      p = fast_exp2(fmaf(p, qscale, e < 2 ? nl2_lo : nl2_hi));
      if (MASK && !km.valid(k0 + j * 8 + t4 * 2 + (e & 1))) p = 0.f;
    }
  }
  wg_wait<0>();
  hold(dp);
  uint32_t dsa[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[e] = s[4 * j + e] * (dp[4 * j + e] - (e < 2 ? d_lo : d_hi));
    pack_a<4>(dsa, j, ds);
  }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n64<1>(acc, dsa[kk], kdesc + 128 * kk, 1);  // ds.k
  wg_commit();
  wg_wait<0>();
  hold(acc);
  hold(dsa);
}

// Kernel E's work on one staged query tile for a warpgroup's 64 key rows
// (transposed scores: rows are keys, columns queries), ECW queries at a
// time.  MASK zeroes p on this thread's invalid key rows; a warpgroup
// whose rows are all valid skips it.
template <bool MASK>
__device__ __forceinline__ void dkv_tile(uint64_t qdesc, uint64_t dodesc, const float* sl,
                                         const float* sd, const uint32_t (&ka)[4][4],
                                         const uint32_t (&va)[4][4], bool valid_lo,
                                         bool valid_hi, float qscale, float (&dka)[32],
                                         float (&dva)[32], int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int c0 = 0; c0 < TILE; c0 += ECW) {
    float s[ECW / 2], dp[ECW / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n32(s, ka[kk], qdesc + c0 * 8 + 2 * kk, kk);    // k.q^T
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n32(dp, va[kk], dodesc + c0 * 8 + 2 * kk, kk);  // v.do^T
    wg_commit();
    wg_wait<1>();  // the scores are in: p (in place) while v.do^T runs
    hold(s);
    uint32_t pa[ECW / 16][4], dsa[ECW / 16][4];
#pragma unroll
    for (int j = 0; j < ECW / 8; ++j) {
      const float2 L = *reinterpret_cast<const float2*>(sl + c0 + j * 8 + t4 * 2);
      const float nl2[2] = {-L.x * LOG2E_F, -L.y * LOG2E_F};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& p = s[4 * j + e];
        p = fast_exp2(fmaf(p, qscale, nl2[e & 1]));
        if (MASK && !(e < 2 ? valid_lo : valid_hi)) p = 0.f;
      }
      pack_a<ECW / 16>(pa, j, &s[4 * j]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < ECW / 16; ++kk) {
      wgmma_n64<1>(dva, pa[kk], dodesc + (c0 + 16 * kk) * 8, 1);  // p^T.do
    }
    wg_commit();
    wg_wait<1>();  // v.do^T is in: ds while p^T.do runs
    hold(dp);
#pragma unroll
    for (int j = 0; j < ECW / 8; ++j) {
      const float2 D = *reinterpret_cast<const float2*>(sd + c0 + j * 8 + t4 * 2);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = s[4 * j + e] * (dp[4 * j + e] - (e & 1 ? D.y : D.x));
      pack_a<ECW / 16>(dsa, j, ds);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < ECW / 16; ++kk) {
      wgmma_n64<1>(dka, dsa[kk], qdesc + (c0 + 16 * kk) * 8, 1);  // ds^T.q
    }
    wg_commit();
    wg_wait<0>();
    hold(dva);
    hold(dka);
    hold(pa);
    hold(dsa);
  }
}

template <int WARPS, int STAGES>
struct DqSmem {
  static constexpr int ROWS = WARPS * 16;
  static constexpr int kRows = ROWS * ROWB;  // the q or do block (bytes)
  static constexpr int kStage = 2 * TILE_BYTES;  // K tile, V tile
  static constexpr int bytes = 2 * kRows + STAGES * kStage;
  static_assert(bytes >= ROWS * (DH + 4) * 4, "the epilogue stages fp32 rows in place");
};

template <int WARPS, int STAGES, typename TO, bool SEG>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 ? 3 : 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ lens, TO* __restrict__ dq, int heads, int n, int seg,
                    float qscale, float scale) {
  using S = DqSmem<WARPS, STAGES>;
  constexpr int NT = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sDO = sQ + S::kRows;
  unsigned char* ring = sDO + S::kRows;  // STAGES x (K tile, V tile)

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

  if (n_tiles > 0) {
    load_rows<NT>(sQ, q + base, n, q0, S::ROWS);
    load_rows<NT>(sDO, dout + base, n, q0, S::ROWS);
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < n_tiles) {
        const int kt = tiles.tile(st) * TILE;
        load_rows<NT>(ring + st * S::kStage, k + base, n, kt, TILE);
        load_rows<NT>(ring + st * S::kStage + TILE_BYTES, v + base, n, kt, TILE);
      }
      cp_async_commit();
    }
    const int r_lo = q0 + wr + (lane >> 2), r_hi = r_lo + 8;
    const float* lrow = lse + static_cast<size_t>(bh) * n;
    const float* drow = delta + static_cast<size_t>(bh) * n;
    const float nl2_lo = r_lo < n ? -lrow[r_lo] * LOG2E_F : 0.f;
    const float nl2_hi = r_hi < n ? -lrow[r_hi] * LOG2E_F : 0.f;
    const float d_lo = r_lo < n ? drow[r_lo] : 0.f;
    const float d_hi = r_hi < n ? drow[r_hi] : 0.f;
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    uint32_t qa[4][4], doa[4][4];
    load_a(sQ, wr, lane, qa);
    load_a(sDO, wr, lane, doa);

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
        dq_tile<false>(kdesc, vdesc, k0, km, qa, doa, nl2_lo, nl2_hi, d_lo, d_hi, qscale, acc,
                       lane);
      } else {
        dq_tile<true>(kdesc, vdesc, k0, km, qa, doa, nl2_lo, nl2_hi, d_lo, d_hi, qscale, acc,
                      lane);
      }
      cp_async_wait<STAGES - 2>();
      fence_proxy_async();
      __syncthreads();
    }
    cp_async_wait<0>();  // only empty groups can remain
  }
  // the tiles were last read before the loop's last barrier
  store_rows<TO, NT>(dq + base + static_cast<size_t>(q0) * DH, min(S::ROWS, n - q0), smem, acc,
                     scale, lane);
}

template <int WARPS, int STAGES>
struct DkvSmem {
  static constexpr int ROWS = WARPS * 16;
  static constexpr int kRows = ROWS * ROWB;      // the K or V block (bytes)
  static constexpr int kStage = 2 * TILE_BYTES;  // q tile, do tile
  static constexpr int kVec = 2 * TILE * 4;      // L and D of a stage
  static constexpr int bytes = 2 * kRows + STAGES * (kStage + kVec);
  static_assert(bytes >= ROWS * (DH + 4) * 4, "the epilogue stages fp32 rows in place");
};

template <int WARPS, int STAGES, typename TO, bool SEG>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 ? 3 : 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lens, TO* __restrict__ dk, TO* __restrict__ dv,
                     int heads, int n, int seg, float qscale, float scale) {
  using S = DkvSmem<WARPS, STAGES>;
  constexpr int NT = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = sK + S::kRows;
  unsigned char* ring = sV + S::kRows;  // STAGES x (q tile, do tile)
  float* vec = reinterpret_cast<float*>(ring + STAGES * S::kStage);  // STAGES x (L, D)

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * S::ROWS;
  const int rows = min(S::ROWS, n - k0);
  const KeyMask km = key_mask<SEG>(lens, bh / heads, n, seg);
  const size_t base = static_cast<size_t>(bh) * n * DH;
  TO* dk_blk = dk + base + static_cast<size_t>(k0) * DH;
  TO* dv_blk = dv + base + static_cast<size_t>(k0) * DH;

  if (!km.any(k0, k0 + S::ROWS)) {  // no valid key in this block: its gradients are exactly 0
    const int chunks = rows * DH * static_cast<int>(sizeof(TO)) / 16;
    for (int i = threadIdx.x; i < chunks; i += NT) {
      reinterpret_cast<uint4*>(dk_blk)[i] = make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<uint4*>(dv_blk)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const float* lrow = lse + static_cast<size_t>(bh) * n;
  const float* drow = delta + static_cast<size_t>(bh) * n;
  auto load_stage = [&](int st, int r0) {
    unsigned char* t = ring + st * S::kStage;
    load_rows<NT>(t, q + base, n, r0, TILE);
    load_rows<NT>(t + TILE_BYTES, dout + base, n, r0, TILE);
    load_vec2<NT>(vec + st * 2 * TILE, vec + st * 2 * TILE + TILE, lrow, drow, n, r0);
  };

  const int n_qt = (n + TILE - 1) / TILE;
  load_rows<NT>(sK, k + base, n, k0, S::ROWS);
  load_rows<NT>(sV, v + base, n, k0, S::ROWS);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_qt) load_stage(st, st * TILE);
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int r_lo = k0 + wr + (lane >> 2);
  const bool valid_lo = km.valid(r_lo), valid_hi = km.valid(r_lo + 8);
  const int wg0 = k0 + (threadIdx.x >> 7) * 64;  // this warpgroup's first key row
  const bool wg_all = km.all(wg0, wg0 + 64);
  cp_async_wait<STAGES - 2>();
  fence_proxy_async();
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_a(sK, wr, lane, ka);
  load_a(sV, wr, lane, va);

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

  // query rows past n are zero in q and do, with L = D = 0: p = 1 there
  // but ds = 0 and do = 0, so they add nothing
  for (int it = 0; it < n_qt; ++it) {
    const int nxt = it + STAGES - 1;
    if (nxt < n_qt) load_stage(nxt % STAGES, nxt * TILE);
    cp_async_commit();
    const int st = it % STAGES;
    const unsigned char* tq = ring + st * S::kStage;
    const uint64_t qdesc = sw128_desc(tq), dodesc = sw128_desc(tq + TILE_BYTES);
    const float* sl = vec + st * 2 * TILE;
    if (wg_all) {
      dkv_tile<false>(qdesc, dodesc, sl, sl + TILE, ka, va, valid_lo, valid_hi, qscale, dka, dva,
                      lane);
    } else {
      dkv_tile<true>(qdesc, dodesc, sl, sl + TILE, ka, va, valid_lo, valid_hi, qscale, dka, dva,
                     lane);
    }
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
  }
  cp_async_wait<0>();  // only empty groups can remain
  // the tiles were last read before the loop's last barrier
  store_rows<TO, NT>(dk_blk, rows, smem, dka, scale, lane);
  __syncthreads();
  store_rows<TO, NT>(dv_blk, rows, smem, dva, 1.f, lane);
}

template <typename Kern>
int prepare(Kern kern, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* lens;
  int b, h, n, seg;
  float qscale, scale;
  cudaStream_t st;
};

template <int WARPS, int STAGES, typename TO, bool SEG>
int launch_dq_cfg(const BwdArgs& a, void* dq) {
  constexpr int bytes = DqSmem<WARPS, STAGES>::bytes + 1024;
  auto kern = flash_bwd_dq_kernel<WARPS, STAGES, TO, SEG>;
  if (int err = prepare(kern, bytes)) return err;
  const dim3 grid((a.n + WARPS * 16 - 1) / (WARPS * 16), a.b * a.h);
  kern<<<grid, WARPS * 32, bytes, a.st>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.lens,
                                           static_cast<TO*>(dq), a.h, a.n, a.seg, a.qscale,
                                           a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int WARPS, int STAGES, typename TO, bool SEG>
int launch_dkv_cfg(const BwdArgs& a, void* dk, void* dv) {
  constexpr int bytes = DkvSmem<WARPS, STAGES>::bytes + 1024;
  auto kern = flash_bwd_dkv_kernel<WARPS, STAGES, TO, SEG>;
  if (int err = prepare(kern, bytes)) return err;
  const dim3 grid((a.n + WARPS * 16 - 1) / (WARPS * 16), a.b * a.h);
  kern<<<grid, WARPS * 32, bytes, a.st>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.lens,
                                           static_cast<TO*>(dk), static_cast<TO*>(dv), a.h, a.n,
                                           a.seg, a.qscale, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The configurations built, (rows per block, ring stages):
// (64, 2), (128, 2), (64, 3) for both kernels
template <typename TO, bool SEG>
int dispatch_dq(const BwdArgs& a, void* dq, int rows, int stages) {
  if (rows == 64 && stages == 2) return launch_dq_cfg<4, 2, TO, SEG>(a, dq);
  if (rows == 128 && stages == 2) return launch_dq_cfg<8, 2, TO, SEG>(a, dq);
  if (rows == 64 && stages == 3) return launch_dq_cfg<4, 3, TO, SEG>(a, dq);
  return cudaErrorInvalidValue;
}

template <typename TO, bool SEG>
int dispatch_dkv(const BwdArgs& a, void* dk, void* dv, int rows, int stages) {
  if (rows == 64 && stages == 2) return launch_dkv_cfg<4, 2, TO, SEG>(a, dk, dv);
  if (rows == 128 && stages == 2) return launch_dkv_cfg<8, 2, TO, SEG>(a, dk, dv);
  if (rows == 64 && stages == 3) return launch_dkv_cfg<4, 3, TO, SEG>(a, dk, dv);
  return cudaErrorInvalidValue;
}

template <bool SEG>
int check_and_pack(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* lens, int b, int h, int n,
                   int dh, int seg, float qscale, float scale, void* stream, BwdArgs* a) {
  if (dh != DH || n <= 0 || b <= 0 || h <= 0 || b * h > 65535) return cudaErrorInvalidValue;
  if (SEG && (seg < 0 || seg > n)) return cudaErrorInvalidValue;
  *a = BwdArgs{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const int*>(lens), b, h, n, SEG ? seg : 0, qscale, scale,
               static_cast<cudaStream_t>(stream)};
  return 0;
}

template <bool SEG>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* lens, void* dq, int b, int h, int n, int dh,
              int out_dtype, int seg, int rows, int stages, float qscale, float scale,
              void* stream) {
  BwdArgs a;
  if (int err = check_and_pack<SEG>(q, k, v, dout, lse, delta, lens, b, h, n, dh, seg, qscale,
                                    scale, stream, &a)) {
    return err;
  }
  if (out_dtype == kBFloat16) return dispatch_dq<bf16, SEG>(a, dq, rows, stages);
  if (out_dtype == kFloat32) return dispatch_dq<float, SEG>(a, dq, rows, stages);
  return cudaErrorInvalidValue;
}

template <bool SEG>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* lens, void* dk, void* dv, int b, int h, int n,
               int dh, int out_dtype, int seg, int rows, int stages, float qscale, float scale,
               void* stream) {
  BwdArgs a;
  if (int err = check_and_pack<SEG>(q, k, v, dout, lse, delta, lens, b, h, n, dh, seg, qscale,
                                    scale, stream, &a)) {
    return err;
  }
  if (out_dtype == kBFloat16) return dispatch_dkv<bf16, SEG>(a, dk, dv, rows, stages);
  if (out_dtype == kFloat32) return dispatch_dkv<float, SEG>(a, dk, dv, rows, stages);
  return cudaErrorInvalidValue;
}

}  // namespace

F5_EXPORT_ERROR_STRING

// Kernel D.  q, k, v, dout: bf16 [b, h, n, dh] contiguous; dq: [b, h, n, dh]
// of out_dtype (kFloat32 or kBFloat16); lse, delta: fp32 [b, h, n]; lens:
// int32 [b].  (rows, stages): a built configuration, (64, 2), (128, 2) or
// (64, 3).  qscale = scale * log2(e).  Returns cudaGetLastError() (or the
// error of the shared-memory attribute).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* lens, void* dq, int b, int h, int n, int dh,
                                      int out_dtype, int rows, int stages, float qscale,
                                      float scale, void* stream) {
  return launch_dq<false>(q, k, v, dout, lse, delta, lens, dq, b, h, n, dh, out_dtype, 0, rows,
                          stages, qscale, scale, stream);
}

// Kernel E.  As kernel D, with dk, dv: [b, h, n, dh] of out_dtype.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* lens, void* dk, void* dv, int b, int h, int n,
                                       int dh, int out_dtype, int rows, int stages, float qscale,
                                       float scale, void* stream) {
  return launch_dkv<false>(q, k, v, dout, lse, delta, lens, dk, dv, b, h, n, dh, out_dtype, 0,
                           rows, stages, qscale, scale, stream);
}

// Kernel D in the two-segment mode: lens int32 [b, 2] (len_a, len_t),
// 0 <= seg <= n.
extern "C" int flash_attention_bwd_dq_seg(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* lens, void* dq, int b, int h, int n,
                                          int dh, int out_dtype, int seg, int rows, int stages,
                                          float qscale, float scale, void* stream) {
  return launch_dq<true>(q, k, v, dout, lse, delta, lens, dq, b, h, n, dh, out_dtype, seg, rows,
                         stages, qscale, scale, stream);
}

// Kernel E in the two-segment mode: lens and seg as kernel D's.
extern "C" int flash_attention_bwd_dkv_seg(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* lens, void* dk, void* dv, int b, int h,
                                           int n, int dh, int out_dtype, int seg, int rows,
                                           int stages, float qscale, float scale,
                                           void* stream) {
  return launch_dkv<true>(q, k, v, dout, lse, delta, lens, dk, dv, b, h, n, dh, out_dtype, seg,
                          rows, stages, qscale, scale, stream);
}
