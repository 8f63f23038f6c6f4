// Warp-specialised masked flash attention, forward, for Hopper (sm_90a):
// kernel H, an experiment beside kernel A.
//
// Replaces the Pallas TPU kernel scripts/exp_pipelined_flash.py::_kernel_pipe
// (:24), called through _flash_pipe (:64): the experiment that issues key
// tile j+1's q k^T before tile j's online softmax and p v, so that the
// matrix unit works while the vector unit does the softmax.  The function is
// kernel A's (row 1 of the kernel table): o = softmax(q k^T / sqrt(64),
// keys in [0, lens[b])) v over bf16 q, k, v [b, h, n, 64], any n; a row
// with no valid key gives 0.  Neither this kernel nor its driver
// (f5_tts_tpu_torch/scripts/exp_pipelined_flash.py) is on the serving path.
//
// Bound on the H100: 4 n kv dh operations per (b, h) for kv valid keys
// against 4 n dh bf16 reads and writes: compute-bound at the bf16
// tensor-core rate (989 TFLOP/s) for n above ~600.  At dh = 64 a score
// costs 256 tensor-core operations and one exp2, and an SM's 16 exp2 per
// clock match its ~4096 bf16 operations per clock: the softmax has to run
// under the products, not between them.
//
// Design: one block of three warpgroups per 128 query rows.
//  - Warpgroup 0 is the producer.  It gives up its registers (setmaxnreg
//    to 24) and one thread issues every copy by TMA through rank-3 tensor
//    maps of [b h, n, 64] (a key tile past n arrives as zeros, never as the
//    next head's rows): q's two 64-row boxes once, then K and V tiles of BK
//    keys through a ring of two stages, K one tile ahead of V.  Each operand
//    of a stage has a full barrier (the expected bytes), so q.K_j^T can
//    start before V_j lands, and an empty barrier that the consumers'
//    eight warps arrive at once the products reading it are done; the
//    producer waits on it before refilling the stage.
//  - Warpgroups 1 and 2 are consumers (setmaxnreg to 240), 64 query rows
//    each.  A consumer reads its q rows once by ldmatrix, multiplies them by
//    scale * log2(e) in fp32 and rounds to bf16 (_kernel_pipe :29), and
//    keeps them as wgmma A fragments.  S = q.K^T is a register-A wgmma
//    m64nBKk16 with K as the K-major operand; O += P.V takes P packed from
//    the score accumulators and V as the MN-major operand, row-major as it
//    lies in memory.
//  - The experiment's overlap, made real (wgmma is asynchronous): in its
//    turn a consumer issues the next tile's scores S_{j+1}, runs S_j's
//    softmax while S_{j+1} is in the tensor cores, then waits for it,
//    packs P_j, rescales O and issues P_j.V_j in a second turn.  S_j and
//    S_{j+1} live in two register arrays that swap roles each tile (the
//    key loop is unrolled by two).  Every wgmma group is retired in the
//    step that issues it: ptxas serialises every wgmma of the kernel
//    (C7520, C7511, C7515) when a group stays in flight across a loop's
//    back edge or a branch.  FA3's order (S_{j+1} issued with P_j.V_j in
//    one turn, S_{j+1}'s softmax under P_j.V_j) timed slower at both
//    shapes measured (PERF.md).
//  - Ping-pong: the consumers take turns to issue, ordered by two named
//    barriers, so one consumer's products queue behind the other's and
//    their softmaxes are staggered.  No block-wide barrier is taken after
//    the roles split, and no barrier is waited on while a group is in
//    flight.
//  - The exp2 unit bounds the softmax: one 8-column block of scores in
//    kCubicEvery takes exp2 as a cubic on the FMA pipe (exp2_cubic).
//  - Only tiles holding a valid key are visited (ceil(kv_len / BK), agreed
//    by producer and consumers from lens); only the tile across kv_len
//    tests each key.  kv_len = 0: no copy is issued, no barrier is waited
//    on, the rows are written as zeros.
//  - Epilogue: O / max(l, 1e-30) in bf16, staged in the consumer's half of
//    the q tile (read into registers long before) and stored by TMA; rows
//    past n are not written.
// Rounding (the TPU kernel's): q * scale * log2(e) rounded to bf16; the
// scores in the log2 domain in fp32, p = exp2(s - m) by ex2.approx or the
// cubic (relative error 7.5e-5); p rounded to bf16 for P.V.
// Instances BK in {64, 128}, 128 query rows per block.  A third stage timed
// no faster at either BK (PERF.md), so the ring has two.

#include "common.cuh"

namespace {

constexpr int BQ = 128;       // query rows per block: two consumers of 64
constexpr int NT = 384;       // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int S = 2;          // stages of the K and V ring
constexpr int BAR_TURN = 1;   // named barriers 1, 2: consumer c's turn to issue
constexpr int BAR_STORE = 3;  // 3, 4: consumer c's output rows staged
// One 8-column block of scores in kCubicEvery takes its exp2 on the FMA pipe
// (exp2_cubic) rather than the exp2 unit, whose 16 results per SM clock
// bound the softmax at dh = 64: 1/16 (one block per 128-key tile, none at
// 64-key tiles) timed fastest on the H100 (none, 1/4 and 1/8 timed;
// PERF.md).
constexpr int kCubicEvery = 16;

// 2^x for x <= 0 without the exp2 unit: x = r + f with r = round(x) (the
// 1.5 * 2^23 trick puts r in the low mantissa bits of t), 2^f by a cubic on
// [-0.5, 0.5] (relative error 7.5e-5, against bf16's 3.9e-3 for p), and r
// added to the exponent.  Below -126 (a masked key's -inf) it gives 0, as
// ex2.approx.ftz does.
__device__ __forceinline__ float exp2_cubic(float x) {
  const float xc = fmaxf(x, -126.f);
  const float t = xc + 12582912.f;
  const float f = xc - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05517202f, f, 0.24260995f), f, 0.69326079f), f, 0.99992814f);
  const float y = __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
  return x < -126.f ? 0.f : y;
}

struct Bars {
  uint64_t q_full;
  uint64_t k_full[S], v_full[S];    // the producer's arrival + the tile's bytes
  uint64_t k_empty[S], v_empty[S];  // one arrival per consumer warp
};

template <int BK>
struct Layout {
  static constexpr int kQ = BQ * kSwRow;       // the q tile, later the output staging
  static constexpr int kTile = BK * kSwRow;    // one K or V tile
  static constexpr int bytes = kQ + 2 * S * kTile;
};

struct Params {
  CUtensorMap tq, tk, tv, to;  // [b h, n, 64]: q and o in 64-row boxes, k and v in BK-row boxes
  const int* lens;
  int heads, n;
  float qscale;
};

// One consumer warpgroup's state and steps.  Every method is inlined: a
// wgmma pipeline must not cross a call.  Every wgmma group is retired in
// the step that issues it, and every branch and mbarrier spin falls where
// no group is in flight (a predicated arrival and the turn's bar.arrive
// may): ptxas serialises every wgmma of the kernel (C7520) when a group
// stays in flight across a loop's back edge or a branch it cannot prove
// warp-uniform.
template <int BK>
struct Consumer {
  static constexpr int NS = BK / 2;   // score accumulators per thread
  static constexpr int KC = BK / 16;  // k steps of P.V
  using L = Layout<BK>;

  float acc[32];
  float sa[NS], sb[NS];  // S_j and S_{j+1}, by turns
  uint32_t qa[4][4];
  uint32_t pa[KC][4];
  float m_lo, m_hi, l_lo, l_hi;
  float qs;  // scale * log2(e)
  unsigned char* ring;
  Bars* bars;
  int n_tiles, kv_len, c, lane;

  __device__ __forceinline__ uint64_t kdesc(int t) const {
    return sw128_desc(ring + (t % S) * L::kTile);
  }
  __device__ __forceinline__ uint64_t vdesc(int t) const {
    return sw128_desc(ring + (S + t % S) * L::kTile);
  }
  __device__ __forceinline__ void land_k(int t) {
    mbar_wait(&bars->k_full[t % S], (t / S) & 1);
  }
  __device__ __forceinline__ void land_v(int t) {
    mbar_wait(&bars->v_full[t % S], (t / S) & 1);
  }
  __device__ __forceinline__ void release(uint64_t* bar) const {
    if (lane == 0) mbar_arrive(bar);
  }
  // consumer c's turn to issue: c = 0 goes first (consumer 1 arrives once
  // before its first turn and not after its last)
  __device__ __forceinline__ void turn_begin() const { named_bar_sync(BAR_TURN + c, CONSUMERS); }
  __device__ __forceinline__ void turn_end() const {
    named_bar_arrive(BAR_TURN + 1 - c, CONSUMERS);
  }

  __device__ __forceinline__ void issue_scores(float (&s)[NS], int t) {
    const uint64_t d = kdesc(t);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (BK == 128) {
        wgmma_n128(s, qa[kk], d + 2 * kk, kk);
      } else {
        wgmma_n64<0>(s, qa[kk], d + 2 * kk, kk);
      }
    }
    wg_commit();
  }
  __device__ __forceinline__ void issue_pv(int t) {
    const uint64_t d = vdesc(t);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) wgmma_n64<1>(acc, pa[kk], d + 128 * kk, 1);
    wg_commit();
  }

  // online softmax of a landed score tile in place (p = exp2(s - m), fp32);
  // returns the rescale factors of the rows' earlier sums.  MASK tests each
  // key against kv_len (the tile across it); every tile visited holds a
  // valid key in every row, so the new max is finite.
  template <bool MASK>
  __device__ __forceinline__ void softmax(float (&s)[NS], int k0, float& a_lo, float& a_hi) {
    const int t4 = lane & 3;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      if constexpr (MASK) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + j * 8 + t4 * 2 + (e & 1) >= kv_len) s[4 * j + e] = -INFINITY;
        }
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    a_lo = fast_exp2(m_lo - mn_lo);  // 0 on the first tile (m = -inf)
    a_hi = fast_exp2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const bool fma_pipe = j % kCubicEvery == kCubicEvery - 1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * j + e] - (e < 2 ? mn_lo : mn_hi);
        s[4 * j + e] = fma_pipe ? exp2_cubic(x) : fast_exp2(x);
      }
      rs_lo += s[4 * j] + s[4 * j + 1];
      rs_hi += s[4 * j + 2] + s[4 * j + 3];
    }
    l_lo = l_lo * a_lo + rs_lo;  // this thread's columns; the quad is summed at the end
    l_hi = l_hi * a_hi + rs_hi;
  }
  // tile k0's softmax, the per-key test only on the tile across kv_len
  __device__ __forceinline__ void softmax_any(float (&s)[NS], int k0, float& a_lo, float& a_hi) {
    if (k0 + BK <= kv_len) {
      softmax<false>(s, k0, a_lo, a_hi);
    } else {
      softmax<true>(s, k0, a_lo, a_hi);
    }
  }
  // P (bf16 A fragments) from the softmaxed tile; O rescaled
  __device__ __forceinline__ void pack_rescale(const float (&s)[NS], float a_lo, float a_hi) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) pack_a<KC>(pa, i, &s[4 * i]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[4 * i] *= a_lo;
      acc[4 * i + 1] *= a_lo;
      acc[4 * i + 2] *= a_hi;
      acc[4 * i + 3] *= a_hi;
    }
  }

  // Tile j: S_{j+1} issued in this consumer's turn, S_j's softmax while it
  // is in the tensor cores, then P_j.V_j in a second turn.  On entry S_j
  // has landed in cur, nothing in flight; j + 1 < n, so every key of tile
  // j is valid.
  __device__ __forceinline__ void step(float (&cur)[NS], float (&nxt)[NS], int j) {
    land_k(j + 1);
    turn_begin();
    wg_fence();
    issue_scores(nxt, j + 1);
    turn_end();
    float a_lo, a_hi;
    softmax<false>(cur, j * BK, a_lo, a_hi);  // under S_{j+1}
    wg_wait<0>();
    hold(nxt);
    release(&bars->k_empty[(j + 1) % S]);
    pack_rescale(cur, a_lo, a_hi);
    land_v(j);
    turn_begin();
    wg_fence();
    issue_pv(j);
    turn_end();
    wg_wait<0>();
    hold(acc);
    hold(pa);
    release(&bars->v_empty[j % S]);
  }

  // the last tile j, which may lie across kv_len: its softmax, then P_j.V_j
  __device__ __forceinline__ void last(float (&cur)[NS], int j) {
    float a_lo, a_hi;
    softmax_any(cur, j * BK, a_lo, a_hi);
    pack_rescale(cur, a_lo, a_hi);
    last_pv(j);
  }

  // P_j.V_j of the last tile, then consumer 0 hands over its last turn
  __device__ __forceinline__ void last_pv(int j) {
    land_v(j);
    turn_begin();
    wg_fence();
    issue_pv(j);
    wg_wait<0>();
    hold(acc);
    hold(pa);
    if (c == 0) turn_end();
  }

  __device__ __forceinline__ void run(const unsigned char* sq) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) sa[i] = sb[i] = 0.f;
    m_lo = m_hi = -INFINITY;
    l_lo = l_hi = 0.f;
    const int n = n_tiles;
    if (n == 0) return;
    if (c == 1) named_bar_arrive(BAR_TURN, CONSUMERS);  // consumer 0 issues first
    mbar_wait(&bars->q_full, 0);
    load_a(sq, ((threadIdx.x >> 5) & 3) * 16, lane, qa);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t r = qa[kc][e];  // bf16 pair: the low half is the first column
        qa[kc][e] = pack_bf16(__uint_as_float(r << 16) * qs,  // _kernel_pipe :29
                              __uint_as_float(r & 0xFFFF0000u) * qs);
      }
    }
    land_k(0);
    turn_begin();
    wg_fence();
    issue_scores(sa, 0);
    turn_end();
    wg_wait<0>();
    hold(sa);
    release(&bars->k_empty[0]);
    int j = 0;
    for (; j + 2 < n; j += 2) {  // S_j in sa, then in sb
      step(sa, sb, j);
      step(sb, sa, j + 1);
    }
    if (j + 1 < n) {
      step(sa, sb, j);
      last(sb, j + 1);
    } else {
      last(sa, j);
    }
  }
};

template <int BK>
__global__ void __launch_bounds__(NT, 1) flash_pipe_kernel(const __grid_constant__ Params p) {
  using L = Layout<BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Bars bars;
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sq = smem;
  unsigned char* ring = smem + L::kQ;  // S K tiles, then S V tiles

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kv_len = min(max(p.lens[bh / p.heads], 0), p.n);
  const int n_tiles = (kv_len + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(&bars.q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&bars.k_full[s], 1);
      mbar_init(&bars.v_full[s], 1);
      mbar_init(&bars.k_empty[s], CONSUMERS / 32);
      mbar_init(&bars.v_empty[s], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      tma_prefetch(&p.tk);
      tma_prefetch(&p.tv);
      mbar_expect_tx(&bars.q_full, L::kQ);
      tma_load_3d(sq, &p.tq, 0, q0, bh, &bars.q_full);
      tma_load_3d(sq + L::kQ / 2, &p.tq, 0, q0 + BQ / 2, bh, &bars.q_full);
      // K_0, then K_{t+1} before V_t: the consumers want the next scores'
      // keys before the current values
      auto load = [&](uint64_t* full, uint64_t* empty, const CUtensorMap* map, int t, int base) {
        const int s = t % S;
        mbar_wait(&empty[s], ((t / S) & 1) ^ 1);  // passes at once on a stage's first use
        mbar_expect_tx(&full[s], L::kTile);
        tma_load_3d(ring + (base + s) * L::kTile, map, 0, t * BK, bh, &full[s]);
      };
      load(bars.k_full, bars.k_empty, &p.tk, 0, 0);
      for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) load(bars.k_full, bars.k_empty, &p.tk, t + 1, 0);
        load(bars.v_full, bars.v_empty, &p.tv, t, S);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<240>();
    Consumer<BK> cons;
    cons.ring = ring;
    cons.bars = &bars;
    cons.n_tiles = n_tiles;
    cons.kv_len = kv_len;
    cons.c = wg - 1;
    cons.lane = threadIdx.x & 31;
    cons.qs = p.qscale;
    unsigned char* half = sq + cons.c * (L::kQ / 2);  // this consumer's 64 rows
    cons.run(half);

    // epilogue: the quad's partial row sums, O / max(l, 1e-30) as bf16
    // into the swizzled half (this consumer alone read it, long ago), then
    // one TMA store that stops at row n
    float l_lo = cons.l_lo, l_hi = cons.l_hi;
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    const int lane = threadIdx.x & 31, r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(half + swz(r, j) + 4 * (lane & 3)) =
          pack_bf16(cons.acc[4 * j] * inv_lo, cons.acc[4 * j + 1] * inv_lo);
      *reinterpret_cast<uint32_t*>(half + swz(r + 8, j) + 4 * (lane & 3)) =
          pack_bf16(cons.acc[4 * j + 2] * inv_hi, cons.acc[4 * j + 3] * inv_hi);
    }
    fence_proxy_async();  // the staging's generic writes before the TMA store reads them
    named_bar_sync(BAR_STORE + cons.c, 128);
    const int r0 = q0 + cons.c * (BQ / 2);
    if ((threadIdx.x & 127) == 0 && r0 < p.n) {
      tma_store_3d(&p.to, half, 0, r0, bh);
      bulk_commit();
      bulk_wait();
    }
  }
}

template <int BK>
int launch_pipe(Params& p, int b, int h, const void* q, const void* k, const void* v, void* o,
                cudaStream_t st) {
  constexpr int bytes = Layout<BK>::bytes + 1024;  // + the swizzle atom alignment
  auto kern = flash_pipe_kernel<BK>;
  static bool ready = false;
  if (!ready) {
    if (int err = static_cast<int>(
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))) {
      return err;
    }
    ready = true;
  }
  const long long mats = static_cast<long long>(b) * h;
  if (int err = make_tmap_rows64(&p.tq, q, mats, p.n, BQ / 2)) return err;
  if (int err = make_tmap_rows64(&p.tk, k, mats, p.n, BK)) return err;
  if (int err = make_tmap_rows64(&p.tv, v, mats, p.n, BK)) return err;
  if (int err = make_tmap_rows64(&p.to, o, mats, p.n, BQ / 2)) return err;
  const dim3 grid((p.n + BQ - 1) / BQ, b * h);
  kern<<<grid, NT, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A barrier whose phase never completes: the bounded mbar_wait must trap
__global__ void mbar_wait_probe_kernel() {
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  mbar_wait(&bar, 0);
}

}  // namespace

F5_EXPORT_ERROR_STRING

// q, k, v, o: bf16 [b, h, n, 64] contiguous, 16-byte aligned; lens: int32
// [b] on the device.  (block_q, block_k) in {128} x {64, 128}.  qscale =
// scale * log2(e).  Returns the tensor-map encoder's error, the
// shared-memory attribute's, or cudaGetLastError().
extern "C" int flash_attention_pipelined(const void* q, const void* k, const void* v,
                                         const void* lens, void* o, int b, int h, int n,
                                         int block_q, int block_k, float qscale, void* stream) {
  if (n <= 0 || b <= 0 || h <= 0 || b * h > 65535 || block_q != BQ) return cudaErrorInvalidValue;
  Params p{};
  p.lens = static_cast<const int*>(lens);
  p.heads = h;
  p.n = n;
  p.qscale = qscale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_k == 64) return launch_pipe<64>(p, b, h, q, k, v, o, st);
  if (block_k == 128) return launch_pipe<128>(p, b, h, q, k, v, o, st);
  return cudaErrorInvalidValue;
}

// One block waits on an mbarrier that no one arrives at: the bounded wait
// (common.cuh mbar_wait) traps after ~2 s.  Run it in a process of its own:
// the trap ends the context.
extern "C" int mbar_wait_probe(void* stream) {
  mbar_wait_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
