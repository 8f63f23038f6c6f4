// LayerNorm + AdaLN modulate fused into a bf16 matrix product's operand
// load, for Hopper (sm_90a): kernel I, an experiment.
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
// Design: kernel G's structure (a persistent cooperative kernel, a row
// phase, a grid barrier, then common.cuh ring_loop over 128 x 256 tiles),
// with the transform on the A side.
//  1. Row statistics: each warp takes whole rows and computes their fp32
//     mean and rstd over all of K (two passes over the row) into a
//     scratch, so each row's statistics are computed once, not once per
//     column block as the TPU kernel does; a tile reads its 128 rows'
//     statistics into shared memory.
//  2. Main loop over k in steps of 64: the raw x tile (128 x 64 bf16), the
//     w tile (64 x 256 bf16, as four [64 k][64 n] tiles) and the 64 values
//     of scale1p and shift stream through a ring of 4 stages by TMA (by
//     cp.async where K or N is not a multiple of 8), the x and w tiles in
//     the 128-byte-swizzled layout.  w [K, N] is N-contiguous, which wgmma
//     reads as an MN-major (transposed) B operand.  Each warpgroup reads
//     its 64 rows of the x tile into A fragments by ldmatrix, normalises
//     and modulates them in fp32, rounds to bf16 and issues
//     wgmma.mma_async m64n256k16 with A from registers; tile t + 1's
//     fragments are prepared while tile t's products run.  No K-sized
//     panel: any K.
//  3. Epilogue: + bias in fp32, one rounding to bf16, staged through
//     shared memory and written with 16-byte stores.
//
// Bound on the H100: at the experiment's shape M = 2048, K = 1024,
// N = 3072, 12.9 GFLOP take 13.0 us at the bf16 tensor-core rate; the
// bytes (4.2 MB of x, 6.3 MB of w, 12.6 MB of output) take 6.9 us: the
// products bound it.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                   // rows per tile: two warpgroups of 64
constexpr int BN = 256;                   // columns per tile: one wgmma n256
constexpr int BKE = 64;                   // k per stage: one swizzle row of bf16
constexpr int STAGES = 4;
constexpr int NT = 256;
constexpr int X_BYTES = BM * kSwRow;      // x tile [128][64]
constexpr int W_SUB = BKE * kSwRow;       // one [64 k][64 n] tile of w
constexpr int SC_OFF = X_BYTES + 4 * W_SUB;  // scale1p [64], then shift [64], fp32
constexpr int TX_BYTES = SC_OFF + 2 * BKE * 4;  // bytes a stage receives
constexpr int STAGE_BYTES = (TX_BYTES + 1023) / 1024 * 1024;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + the swizzle atom alignment
constexpr int SLD = BN + 8;               // staged output row, elements
constexpr float LN_EPS = 1e-6f;
static_assert(BM * SLD * 2 <= STAGES * STAGE_BYTES, "the output is staged over the ring");

struct Args {
  CUtensorMap tx;   // x [M, K] in [128][64] boxes
  CUtensorMap tw;   // w [K, N] in [64][64] boxes
  CUtensorMap tsc;  // scale1p as [1, K] in [1][64] boxes
  CUtensorMap tsh;  // shift, likewise
  const bf16* x;
  const bf16* w;
  const float* bias;
  const float* sc;
  const float* sh;
  bf16* out;
  float2* stats;    // [M] (mean, rstd) scratch
  unsigned* sync;   // [0]: the grid barrier
  int M, N, K;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Phase 1: a warp per row, over the grid's warps; two passes over the row,
// each keeping several 16-byte loads in flight
template <bool VEC>
__device__ __forceinline__ void row_stats_phase(const Args& a) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (NT / 32);
  for (int r = blockIdx.x * (NT / 32) + (threadIdx.x >> 5); r < a.M; r += warps) {
    const bf16* row = a.x + static_cast<size_t>(r) * a.K;
    if constexpr (VEC) {
      if (a.K <= 256 * kRowHold) {  // the row read once; both passes over registers
        uint4 raw[kRowHold];
        load_row_bf16(row, a.K, lane, raw);
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kRowHold; ++i) {
          float v[8];
          unpack8(raw[i], v);
#pragma unroll
          for (int e = 0; e < 8; ++e) s += v[e];
        }
        const float mean = warp_sum(s) / a.K;
        float s2 = 0.f;
#pragma unroll
        for (int i = 0; i < kRowHold; ++i) {
          if (lane * 8 + 256 * i < a.K) {
            float v[8];
            unpack8(raw[i], v);
#pragma unroll
            for (int e = 0; e < 8; ++e) s2 += (v[e] - mean) * (v[e] - mean);
          }
        }
        const float rstd = rsqrtf(warp_sum(s2) / a.K + LN_EPS);  // every lane shuffles
        if (lane == 0) a.stats[r] = make_float2(mean, rstd);
        continue;
      }
    }
    float s = 0.f;
    if constexpr (VEC) {
#pragma unroll 4
      for (int c = lane * 8; c < a.K; c += 256) {
        float v[8];
        load8(row + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[e];
      }
    } else {
      for (int c = lane; c < a.K; c += 32) s += __bfloat162float(row[c]);
    }
    const float mean = warp_sum(s) / a.K;
    float s2 = 0.f;
    if constexpr (VEC) {
#pragma unroll 4
      for (int c = lane * 8; c < a.K; c += 256) {
        float v[8];
        load8(row + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s2 += (v[e] - mean) * (v[e] - mean);
      }
    } else {
      for (int c = lane; c < a.K; c += 32) {
        const float d = __bfloat162float(row[c]) - mean;
        s2 += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(s2) / a.K + LN_EPS);
    if (lane == 0) a.stats[r] = make_float2(mean, rstd);
  }
}

// (x - mean) * rstd * scale1p + shift of a bf16 pair, as a bf16 pair
__device__ __forceinline__ uint32_t modulate(uint32_t xv, float mean, float rstd, float2 sc,
                                             float2 sh) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
  return pack_bf16((f.x - mean) * rstd * sc.x + sh.x, (f.y - mean) * rstd * sc.y + sh.y);
}

struct Shared {
  uint64_t full[STAGES];  // TMA barriers of the ring's stages
  float mean[BM], rstd[BM];
  float bias[BN];
};

// The k loop's operations (common.cuh ring_loop) for one 128 x 256 tile
template <bool TMA>
struct LnOp {
  float acc[128];
  uint32_t a0[4][4], a1[4][4];  // A fragments of tiles t (even) and t + 1 (odd)
  unsigned char* smem;
  Shared* sh;
  const Args* a;
  int m0, n0, w0, lane;

  __device__ __forceinline__ void load(int t, int s) {
    unsigned char* st = smem + s * STAGE_BYTES;
    const int k0 = t * BKE;
    if constexpr (TMA) {
      uint64_t* bar = sh->full + s;  // two arrivals: one thread of each warpgroup issues
      if (threadIdx.x == 0) {         // x, scale1p, shift
        mbar_expect_tx(bar, SC_OFF - 4 * W_SUB + 2 * BKE * 4);
        tma_load_2d(st, &a->tx, k0, m0, bar);
        tma_load_2d(st + SC_OFF, &a->tsc, k0, 0, bar);
        tma_load_2d(st + SC_OFF + BKE * 4, &a->tsh, k0, 0, bar);
      } else if (threadIdx.x == 128) {  // w
        mbar_expect_tx(bar, 4 * W_SUB);
#pragma unroll
        for (int j = 0; j < 4; ++j) tma_load_2d(st + X_BYTES + j * W_SUB, &a->tw, n0 + 64 * j, k0, bar);
      }
    } else {
      load_tile128<BM, NT, false>(st, reinterpret_cast<const unsigned char*>(a->x),
                                  static_cast<size_t>(a->K) * 2, a->M, m0, a->K * 2, k0 * 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        load_tile128<BKE, NT, false>(st + X_BYTES + j * W_SUB,
                                     reinterpret_cast<const unsigned char*>(a->w),
                                     static_cast<size_t>(a->N) * 2, a->K, k0, a->N * 2,
                                     (n0 + 64 * j) * 2);
      }
      if (threadIdx.x < 2 * BKE) {  // scale1p, then shift; zeros past K
        const int e = threadIdx.x & (BKE - 1), gk = k0 + e;
        const float* src = threadIdx.x < BKE ? a->sc : a->sh;
        cp_async4(st + SC_OFF + threadIdx.x * 4, src + (gk < a->K ? gk : 0), gk < a->K ? 4 : 0);
      }
    }
  }

  // tile t's normalised A fragments (this warp's 16 rows x 64 k) from the raw x tile
  __device__ __forceinline__ void prep_into(uint32_t (&f)[4][4], const unsigned char* st) {
    load_a(st, w0, lane, f);
    const int r = w0 + (lane >> 2), t4 = lane & 3;
    const float mean_lo = sh->mean[r], rstd_lo = sh->rstd[r];
    const float mean_hi = sh->mean[r + 8], rstd_hi = sh->rstd[r + 8];
    const float* ssc = reinterpret_cast<const float*>(st + SC_OFF);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = kc * 16 + h * 8 + 2 * t4;
        const float2 s2 = *reinterpret_cast<const float2*>(ssc + c);
        const float2 h2 = *reinterpret_cast<const float2*>(ssc + BKE + c);
        f[kc][2 * h] = modulate(f[kc][2 * h], mean_lo, rstd_lo, s2, h2);
        f[kc][2 * h + 1] = modulate(f[kc][2 * h + 1], mean_hi, rstd_hi, s2, h2);
      }
    }
  }
  __device__ __forceinline__ void prep(int t, int s) {
    const unsigned char* st = smem + s * STAGE_BYTES;
    if (t & 1) {
      prep_into(a1, st);
    } else {
      prep_into(a0, st);
    }
  }

  __device__ __forceinline__ void mma(int t, int s) {
    const uint64_t bd = sw128_desc_mn(smem + s * STAGE_BYTES + X_BYTES, W_SUB);
    wg_fence();
    if (t & 1) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_bf16_n256_t(acc, a1[kk], bd + 128 * kk, 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_bf16_n256_t(acc, a0[kk], bd + 128 * kk, 1);
    }
    wg_commit();
    wg_wait<1>();
  }
};

template <bool TMA>
__global__ void __launch_bounds__(NT, 1) fused_ln_matmul_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared sh;
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, t4 = lane & 3;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(sh.full + s, TMA ? 2 : 1);
    mbar_init_fence();
    if (TMA) {
      tma_prefetch(&a.tx);
      tma_prefetch(&a.tw);
      tma_prefetch(&a.tsc);
      tma_prefetch(&a.tsh);
    }
  }
  row_stats_phase<TMA>(a);
  grid_barrier(a.sync);

  const int tiles_n = cdiv(a.N, BN), tiles = cdiv(a.M, BM) * tiles_n;
  int base = 0;  // tiles this block has run through the ring
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    if (tid < BM) {
      const float2 st = m0 + tid < a.M ? __ldcg(a.stats + m0 + tid) : make_float2(0.f, 0.f);
      sh.mean[tid] = st.x;
      sh.rstd[tid] = st.y;
    }
    sh.bias[tid] = n0 + tid < a.N ? a.bias[n0 + tid] : 0.f;
    __syncthreads();

    LnOp<TMA> op;
#pragma unroll
    for (int i = 0; i < 128; ++i) op.acc[i] = 0.f;
    op.smem = smem;
    op.sh = &sh;
    op.a = &a;
    op.m0 = m0;
    op.n0 = n0;
    op.w0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16;  // this warp's 16 rows of the tile
    op.lane = lane;
    ring_loop<STAGES, TMA>(cdiv(a.K, BKE), op, sh.full, base);
    float(&acc)[128] = op.acc;
    hold(acc);

    // epilogue: + bias in fp32, one rounding to bf16
    __syncthreads();  // both warpgroups are done with the ring, which stages the tile
    bf16* so = reinterpret_cast<bf16*>(smem);
    const int r0 = op.w0 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 b2 = *reinterpret_cast<const float2*>(sh.bias + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<uint32_t*>(so + (r0 + 8 * h) * SLD + c) =
            pack_bf16(acc[4 * j + 2 * h] + b2.x, acc[4 * j + 2 * h + 1] + b2.y);
      }
    }
    __syncthreads();
    flush_tile<bf16, NT>(a.out + static_cast<size_t>(m0) * a.N + n0, a.N, min(BM, a.M - m0),
                         min(BN, a.N - n0), so, SLD, BN);
    fence_proxy_async();  // the staging's generic accesses before the next TMA writes
    __syncthreads();  // the staged tile is read before the next tile's copies land
  }
}

template <bool TMA>
int launch(Args& a, cudaStream_t st) {
  auto kern = fused_ln_matmul_kernel<TMA>;
  static int resident = 0;  // blocks of this instance the card holds at once
  if (resident == 0) {
    if (int err = static_cast<int>(
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES))) {
      return err;
    }
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (int err = static_cast<int>(
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, SMEM_BYTES))) {
      return err;
    }
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  if (TMA) {
    int err = make_tmap(&a.tx, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.M, a.K, a.K, BM, BKE,
                        true);
    if (!err) {
      err = make_tmap(&a.tw, a.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.K, a.N, a.N, BKE, 64,
                      true);
    }
    if (!err) {
      err = make_tmap(&a.tsc, a.sc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 1, a.K, a.K, 1, BKE,
                      false);
    }
    if (!err) {
      err = make_tmap(&a.tsh, a.sh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 1, a.K, a.K, 1, BKE,
                      false);
    }
    if (err) return err;
  }
  const int tiles = cdiv(a.M, BM) * cdiv(a.N, BN);
  const int grid = max(1, min(resident, max(tiles, cdiv(a.M, NT / 32))));
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                                      dim3(grid), dim3(NT), params, SMEM_BYTES,
                                                      st));
}

}  // namespace

F5_EXPORT_ERROR_STRING

// x: bf16 [M, K], w: bf16 [K, N], bias: fp32 [N], scale1p, shift: fp32 [K],
// out: bf16 [M, N]; stats: fp32 [M, 2] scratch; sync: uint32 [1], zeroed
// once and left so; all contiguous and 16-byte aligned on the device.  Any
// M, N, K.  Returns the launch's error code.
extern "C" int fused_ln_matmul(const void* x, const void* w, const void* bias,
                               const void* scale1p, const void* shift, void* out, void* stats,
                               void* sync, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.sc = static_cast<const float*>(scale1p);
  a.sh = static_cast<const float*>(shift);
  a.out = static_cast<bf16*>(out);
  a.stats = static_cast<float2*>(stats);
  a.sync = static_cast<unsigned*>(sync);
  a.M = M;
  a.N = N;
  a.K = K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 8 == 0 && N % 8 == 0) return launch<true>(a, st);
  return launch<false>(a, st);
}
