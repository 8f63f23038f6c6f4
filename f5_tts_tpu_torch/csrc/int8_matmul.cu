// W8A8 int8 matrix product for Hopper (sm_90a): kernel G, in two instances
// of one kernel.
//
// Replaces the Pallas TPU kernel f5_tts_tpu/ops/quant.py::_kernel (:35),
// called through int8_matmul (:67), and the whole quantized branch of
// f5_tts_tpu/models/layers.py::linear (:52-65) around it.
//
// * The TPU kernel's own function (int8_matmul below): for x_q int8 [m, k]
//   (per-row quantized activations), w_q int8 [n, k] (per-output-channel
//   quantized weights, nn.Linear's layout; the TPU kernel takes [k, n]),
//   x_scale fp32 [m], w_scale fp32 [n],
//     out[i, j] = float(sum_k x_q[i, k] w_q[j, k]) * x_scale[i] * w_scale[j]
//   as fp32 [m, n].
// * The serving linear (int8_linear): x in the compute dtype TX (bf16, or
//   fp32) [m, k], bias TX [n] or none, out TX [m, n]:
//     x_q, x_scale = quantize_rows(x)   (ops/quant.py, in TX)
//     out = TX(int8_matmul(x_q, x_scale, w_q, w_scale)) + bias   (in TX)
//   in one launch.
//
// The int32 sum is exact (|sum| <= 127^2 k < 2^31 for k <= 133,143, which
// the wrapper checks) and order-free; the epilogue converts it with one
// rounding and multiplies by the two scales in the TPU kernel's order, so
// both instances are bitwise their plain versions.  quantize_rows rounds as
// the plain version does: the row max in TX (exact), the scale
// max(amax, 1e-8) / 127 by true division (__fdiv_rn; PyTorch's CUDA
// division by a Python scalar multiplies by 1/127 instead, which the plain
// version avoids by dividing by a tensor) rounded to TX, x / scale by true
// division rounded to TX (div_rn below), then rint (half to even) and a
// clip to +-127.  The bitwise claim is for finite x.  The row max
// propagates NaN as torch.amax does, so a row holding a NaN gets a NaN
// scale and a NaN output row on both sides (its int8 values are -127 here,
// whatever the cast of NaN to int8 gives there); rows holding an infinity
// are not covered.
//
// Design.  A persistent kernel of 256 threads (two consumer warpgroups).
// 1. Row quantization (serving instance): each warp takes whole rows of x,
//    reads a row once (into registers up to k = 4096), finds its max and
//    writes its int8 values and scale to a scratch the wrapper allocates, so
//    every row is read once and quantized once, not once per column block.
//    A grid-wide barrier (the launch is cooperative, so every block is
//    resident) separates this from
// 2. the product: 128 x 256 output tiles, split along k where there are
//    fewer tiles than SMs (the wrapper chooses the split count), handed out
//    to the blocks in turn.  Both int8 operands are K-major, the only order
//    wgmma takes for 8-bit types, and come by TMA (one thread issues a
//    tile's two boxes) into a ring of 4 stages of 128-byte-swizzled k tiles
//    (16 KB of x_q, 32 KB of w_q), 3 tiles ahead of the tensor cores; each
//    warpgroup issues wgmma.mma_async m64n256k32.s32.s8.s8 with both
//    operands from shared memory (common.cuh ring_loop, the loop kernel I
//    runs too).  A k that is not a multiple of 16 leaves rows unaligned for
//    TMA: that instance gathers the tiles byte by byte (cp.async).  A split
//    writes its int32 partial tile to a workspace (by TMA, through shared
//    memory), and the last split of a tile to arrive (a per-tile counter
//    the wrapper allocates zeroed, which that split resets to 0) adds the
//    others' partials to its own: int32 sums, exact in any order.
// 3. Epilogue: scales (and, in the serving instance, the rounding to TX and
//    the bias in TX), staged through shared memory and written with 16-byte
//    stores.
// Any m, n, k: rows and columns past the edges arrive as zeros and are
// masked on the store.
//
// Bound on the H100, serving shapes of F5TTS_v1_Base at m = 1024 (2 x the
// 512-frame bucket): (k, n) = (1024, 3072) qkv, (1024, 1024) out,
// (1024, 4096) ff in, (4096, 1024) ff out.  At (4096, 1024): 8.6 GOP take
// 4.3 us at 1,979 TOP/s; bf16 x in (8.4 MB), int8 w (4.2 MB) and bf16 out
// (2.1 MB) take 4.4 us at 3.35 TB/s.  A 128 x 256 x 128 tile step needs
// 48 KB from L2 for 4.2 M multiply-adds, ~47 bytes per SM clock at the
// int8 peak, so the k loop is bound by L2 as much as by the tensor cores.

#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;             // output rows per tile: two warpgroups of 64
constexpr int BN = 256;             // output columns per tile: one wgmma n256
constexpr int BK = 128;             // k per stage: one 128-byte swizzle row of int8
constexpr int STAGES = 4;
constexpr int NT = 256;
constexpr int A_BYTES = BM * BK;    // x_q tile
constexpr int B_BYTES = BN * BK;    // w_q tile
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + the swizzle atom alignment
constexpr int SLD = BN + 8;         // staged output row, elements (conflict-free pairs)
static_assert(BM * SLD * 4 <= STAGES * STAGE_BYTES, "the output is staged over the ring");

struct Args {
  CUtensorMap tx;    // x_q [m, k] in [128][128] boxes (TMA instances)
  CUtensorMap tw;    // w_q [n, k] in [256][128] boxes
  CUtensorMap tp;    // the partial tiles as int32 [tiles * splits * 128, 256] in [128][32] boxes
  const void* x;     // TX [m, k]: the serving instance's activations, else null
  int8_t* xq;        // int8 [m, k]: the TPU instance's input, the serving one's scratch
  float* xs;         // fp32 [m]: likewise
  const int8_t* wq;  // int8 [n, k]
  const float* ws;   // fp32 [n]
  const void* bias;  // TX [n] or null
  void* out;         // TX [m, n]
  int4* part;        // int32 partial tiles [tiles, splits, BM * BN] when splits > 1
  unsigned* sync;    // [0]: the grid barrier; [1 + tile]: arrivals at a split tile
  int m, n, k, splits;
  int quantize;      // run phase 1 (row quantization)
  int gemm;          // run phase 2 (the product); both: a grid barrier between
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename TX>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(TX) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// max(a, b), NaN where either is, as torch.amax and torch.clamp give it
// (fmaxf would drop the NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// quantize_rows' scale of a row: max(amax, 1e-8) / 127, each step in TX
template <typename TX>
__device__ __forceinline__ float row_scale(float amax) {
  return round_to<TX>(__fdiv_rn(round_to<TX>(max_nan(amax, 1e-8f)), 127.f));
}

// x / s rounded as the IEEE division rounds it, from y = RN(1 / s) (one
// correctly rounded reciprocal per row): the first correction brings the
// quotient within one ulp of x / s, and the second rounds it correctly
// (Markstein's theorem).  Branch-free, with no slow path: exact for the
// normal scales and the quotients (|x / s| <= ~128) of quantize_rows, and
// 0 for x = 0 (__fdiv_rn costs ~2x as much here, and a zero dividend takes
// its slow path; measured on the H100).
__device__ __forceinline__ float div_rn(float x, float s, float y) {
  const float q0 = __fmul_rn(x, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, x), y, q0);
  return __fmaf_rn(__fmaf_rn(-q1, s, x), y, q1);
}

// one value: clip(rint(TX(x / scale)), -127, 127), as its int8 byte
template <typename TX>
__device__ __forceinline__ uint32_t quant(float x, float s, float y) {
  const float q = fminf(fmaxf(rintf(round_to<TX>(div_rn(x, s, y))), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu;
}

// Phase 1: a warp per row, over the grid's warps; each pass keeps several
// 16-byte loads of the row in flight
template <typename TX, bool VEC>
__device__ __forceinline__ void quantize_rows_phase(const Args& a) {
  const TX* x = static_cast<const TX*>(a.x);
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (NT / 32);
  for (int r = blockIdx.x * (NT / 32) + (threadIdx.x >> 5); r < a.m; r += warps) {
    const TX* row = x + static_cast<size_t>(r) * a.k;
    int8_t* qrow = a.xq + static_cast<size_t>(r) * a.k;
    if constexpr (VEC && sizeof(TX) == 2) {
      if (a.k <= 256 * kRowHold) {  // the row read once, into registers
        uint4 raw[kRowHold];
        load_row_bf16(row, a.k, lane, raw);
        float amax = 0.f;
#pragma unroll
        for (int i = 0; i < kRowHold; ++i) {
          float v[8];
          unpack8(raw[i], v);
#pragma unroll
          for (int e = 0; e < 8; ++e) amax = max_nan(amax, fabsf(v[e]));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        }
        const float s = row_scale<TX>(amax), y = __frcp_rn(s);
#pragma unroll
        for (int i = 0; i < kRowHold; ++i) {
          const int c = lane * 8 + 256 * i;
          if (c < a.k) {
            float v[8];
            unpack8(raw[i], v);
            uint32_t w[2] = {0u, 0u};
#pragma unroll
            for (int e = 0; e < 8; ++e) w[e >> 2] |= quant<TX>(v[e], s, y) << (8 * (e & 3));
            *reinterpret_cast<uint2*>(qrow + c) = make_uint2(w[0], w[1]);
          }
        }
        if (lane == 0) a.xs[r] = s;
        continue;
      }
    }
    float amax = 0.f;
    if constexpr (VEC) {  // k % 16 == 0: 16-byte aligned rows, 8 values a load
#pragma unroll 4
      for (int c = lane * 8; c < a.k; c += 256) {
        float v[8];
        load8(row + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = max_nan(amax, fabsf(v[e]));
      }
    } else {
      for (int c = lane; c < a.k; c += 32) amax = max_nan(amax, fabsf(to_float(row[c])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    }
    const float s = row_scale<TX>(amax), y = __frcp_rn(s);
    if constexpr (VEC) {
#pragma unroll 4
      for (int c = lane * 8; c < a.k; c += 256) {
        float v[8];
        load8(row + c, v);
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e >> 2] |= quant<TX>(v[e], s, y) << (8 * (e & 3));
        *reinterpret_cast<uint2*>(qrow + c) = make_uint2(w[0], w[1]);
      }
    } else {
      for (int c = lane; c < a.k; c += 32) {
        qrow[c] = static_cast<int8_t>(quant<TX>(to_float(row[c]), s, y));
      }
    }
    if (lane == 0) a.xs[r] = s;
  }
}

// the pair (v0, v1) of the product as TX, + the bias pair in TX (each sum
// rounded once to TX, as TX(product) + bias rounds it), into p
template <typename TX>
__device__ __forceinline__ void store_pair(TX* p, float v0, float v1, bool has_bias, float2 b) {
  if constexpr (sizeof(TX) == 2) {
    __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
    if (has_bias) y = __hadd2(y, __floats2bfloat162_rn(b.x, b.y));  // b is exactly bf16
    *reinterpret_cast<__nv_bfloat162*>(p) = y;
  } else {
    *reinterpret_cast<float2*>(p) = has_bias ? make_float2(v0 + b.x, v1 + b.y) : make_float2(v0, v1);
  }
}

// Phase 2's k loop for one unit: both operands from the ring, by descriptor
template <bool TMA>
struct GemmOp {
  int acc[128];
  unsigned char* smem;
  uint64_t* full;
  const Args* a;
  int m0, n0, ks0, wg;

  __device__ __forceinline__ void load(int t, int s) {
    unsigned char* st = smem + s * STAGE_BYTES;
    const int kb = (ks0 + t) * BK;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(full + s, STAGE_BYTES);
        tma_load_2d(st, &a->tx, kb, m0, full + s);
        tma_load_2d(st + A_BYTES, &a->tw, kb, n0, full + s);
      }
    } else {
      load_tile128<BM, NT, false>(st, reinterpret_cast<const unsigned char*>(a->xq), a->k, a->m,
                                  m0, a->k, kb);
      load_tile128<BN, NT, false>(st + A_BYTES, reinterpret_cast<const unsigned char*>(a->wq),
                                  a->k, a->n, n0, a->k, kb);
    }
  }
  __device__ __forceinline__ void prep(int, int) {}
  __device__ __forceinline__ void mma(int, int s) {
    const unsigned char* st = smem + s * STAGE_BYTES;
    const uint64_t ad = sw128_desc(st + wg * 64 * BK), bd = sw128_desc(st + A_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8_n256(acc, ad + 2 * kk, bd + 2 * kk, 1);
    wg_commit();
    wg_wait<1>();
  }
};

struct Shared {
  uint64_t full[STAGES];  // TMA barriers of the ring's stages
  uint64_t fix;           // TMA barrier of the split partials' reads
  float xs[BM];           // the unit's row scales
  float ws[BN];           // its column scales
  float bias[BN];         // its bias (TX), as floats
  int last;               // this split finishes the tile
};

// Phase 2 for one (tile, split) unit
template <typename TX, bool TMA>
__device__ __forceinline__ void gemm_unit(const Args& a, unsigned char* smem, Shared& sh,
                                          int& base, int& fixes, int tile, int sp) {
  const int tiles_n = cdiv(a.n, BN);
  const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
  const int nk = cdiv(a.k, BK), per = cdiv(nk, a.splits);
  const int ks0 = sp * per, ks1 = min(nk, ks0 + per);
  const int tid = threadIdx.x, wg = tid >> 7;
  const TX* bias = static_cast<const TX*>(a.bias);

  // the epilogue's row and column vectors, loaded now and staged after the
  // loop (their latency hides under it)
  const float xs_v = tid < BM && m0 + tid < a.m ? __ldcg(a.xs + m0 + tid) : 0.f;
  const float ws_v = n0 + tid < a.n ? a.ws[n0 + tid] : 0.f;
  const float b_v = bias != nullptr && n0 + tid < a.n ? to_float(bias[n0 + tid]) : 0.f;
  const int rows = min(BM, a.m - m0);

  GemmOp<TMA> op;
#pragma unroll
  for (int i = 0; i < 128; ++i) op.acc[i] = 0;
  op.smem = smem;
  op.full = sh.full;
  op.a = &a;
  op.m0 = m0;
  op.n0 = n0;
  op.ks0 = ks0;
  op.wg = wg;
  ring_loop<STAGES, TMA>(ks1 - ks0, op, sh.full, base);
  int(&acc)[128] = op.acc;
  hold(acc);

  // this thread's accumulator rows r0 and r0 + 8 of the tile, columns
  // 8 j + 2 t4 and + 1 (the wgmma layout)
  const int lane = tid & 31, t4 = lane & 3;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  if (a.splits > 1) {  // publish this split's partial; the last to arrive finishes the tile
    __syncthreads();  // both warpgroups are done with the ring, which stages the partial
    if constexpr (TMA) {
      // through shared memory in the tensor map's eight 128-byte-swizzled
      // [128][32] boxes, out by TMA
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        unsigned char* box = smem + (j >> 2) * BM * 128;
        const int chunk = 2 * (j & 3) + (t4 >> 1), off = 8 * (t4 & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<int2*>(box + swz(r0 + 8 * h, chunk) + off) =
              make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        const int row0 = (tile * a.splits + sp) * BM;
#pragma unroll
        for (int b = 0; b < BN / 32; ++b) tma_store_2d(&a.tp, smem + b * BM * 128, 32 * b, row0);
        bulk_commit();
        bulk_wait();
        fence_proxy_async();
      }
    } else {
      int* mine = reinterpret_cast<int*>(a.part) + (static_cast<size_t>(tile) * a.splits + sp) * BM * BN;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r0 + 8 * h < rows) {  // the valid rows only
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            *reinterpret_cast<int2*>(mine + (r0 + 8 * h) * BN + 8 * j + 2 * t4) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const bool last = atomicAdd(a.sync + 1 + tile, 1u) == static_cast<unsigned>(a.splits - 1);
      if (last) atomicExch(a.sync + 1 + tile, 0u);
      sh.last = last;
    }
    __syncthreads();
    if (!sh.last) return;
    __threadfence();
    for (int o = 0; o < a.splits; ++o) {
      if (o == sp) continue;
      if constexpr (TMA) {
        if (tid == 0) {
          fence_proxy_async();
          mbar_expect_tx(&sh.fix, BM * BN * 4);
          const int row0 = (tile * a.splits + o) * BM;
#pragma unroll
          for (int b = 0; b < BN / 32; ++b) {
            tma_load_2d(smem + b * BM * 128, &a.tp, 32 * b, row0, &sh.fix);
          }
        }
        mbar_wait(&sh.fix, fixes & 1);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const unsigned char* box = smem + (j >> 2) * BM * 128;
          const int chunk = 2 * (j & 3) + (t4 >> 1), off = 8 * (t4 & 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int2 v = *reinterpret_cast<const int2*>(box + swz(r0 + 8 * h, chunk) + off);
            acc[4 * j + 2 * h] += v.x;
            acc[4 * j + 2 * h + 1] += v.y;
          }
        }
        fence_proxy_async();  // these reads before the next partial's TMA writes
        __syncthreads();
        ++fixes;
      } else {
        const int* other = reinterpret_cast<const int*>(a.part) +
                           (static_cast<size_t>(tile) * a.splits + o) * BM * BN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (r0 + 8 * h < rows) {
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              const int2 v = __ldcg(reinterpret_cast<const int2*>(other + (r0 + 8 * h) * BN +
                                                                  8 * j + 2 * t4));
              acc[4 * j + 2 * h] += v.x;
              acc[4 * j + 2 * h + 1] += v.y;
            }
          }
        }
      }
    }
  }

  // epilogue: float(acc) * x_scale * w_scale in the TPU kernel's order
  if (tid < BM) sh.xs[tid] = xs_v;
  sh.ws[tid] = ws_v;
  sh.bias[tid] = b_v;
  __syncthreads();  // both warpgroups are done with the ring, which stages the tile
  TX* so = reinterpret_cast<TX*>(smem);
  const bool has_bias = bias != nullptr;
  const float sx[2] = {sh.xs[r0], sh.xs[r0 + 8]};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + 2 * t4;
    const float2 w2 = *reinterpret_cast<const float2*>(sh.ws + c);
    const float2 b2 = *reinterpret_cast<const float2*>(sh.bias + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sx[h]), w2.x);
      const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sx[h]), w2.y);
      store_pair<TX>(so + (r0 + 8 * h) * SLD + c, v0, v1, has_bias, b2);
    }
  }
  __syncthreads();
  flush_tile<TX, NT>(static_cast<TX*>(a.out) + static_cast<size_t>(m0) * a.n + n0, a.n,
                     min(BM, a.m - m0), min(BN, a.n - n0), so, SLD, BN);
  fence_proxy_async();  // the staging's generic accesses before the next TMA writes
  __syncthreads();  // the staged tile is read before the next unit's copies land
}

template <typename TX, bool TMA>
__global__ void __launch_bounds__(NT, 1) int8_gemm_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared sh;
  unsigned char* smem = aligned_smem(smem_raw);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(sh.full + s, 1);
    mbar_init(&sh.fix, 1);
    mbar_init_fence();
    if (TMA && a.gemm) {
      tma_prefetch(&a.tx);
      tma_prefetch(&a.tw);
      if (a.splits > 1) tma_prefetch(&a.tp);
    }
  }
  if (a.quantize) {
    quantize_rows_phase<TX, TMA>(a);
    if (!a.gemm) return;
    grid_barrier(a.sync);
  }
  __syncthreads();
  const int tiles = cdiv(a.m, BM) * cdiv(a.n, BN);
  int base = 0;   // tiles this block has run through the ring
  int fixes = 0;  // partials it has read through sh.fix (the barrier's phases)
  for (int u = blockIdx.x; u < tiles * a.splits; u += gridDim.x) {
    gemm_unit<TX, TMA>(a, smem, sh, base, fixes, u / a.splits, u % a.splits);
  }
}

// Launch one instance: a grid of at most the resident blocks, cooperative
// when phase 1 and phase 2 meet at the grid barrier.
template <typename TX, bool TMA>
int launch(Args& a, cudaStream_t st) {
  auto kern = int8_gemm_kernel<TX, TMA>;
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
  if (TMA && a.gemm) {
    if (int err = make_tmap(&a.tx, a.xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.m, a.k, a.k, BM, BK,
                            true)) {
      return err;
    }
    if (int err = make_tmap(&a.tw, a.wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.n, a.k, a.k, BN, BK,
                            true)) {
      return err;
    }
    const long long slots = static_cast<long long>(cdiv(a.m, BM)) * cdiv(a.n, BN) * a.splits;
    if (a.splits > 1) {
      if (int err = make_tmap(&a.tp, a.part, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, slots * BM, BN, BN,
                              BM, 32, true)) {
        return err;
      }
    }
  }
  const int units = a.gemm ? cdiv(a.m, BM) * cdiv(a.n, BN) * a.splits : 0;
  const int want = a.quantize ? max(units, cdiv(a.m, NT / 32)) : units;
  const int grid = max(1, min(resident, want));
  if (a.quantize && a.gemm) {
    void* params[] = {&a};
    return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                                        dim3(grid), dim3(NT), params, SMEM_BYTES,
                                                        st));
  }
  kern<<<grid, NT, SMEM_BYTES, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// TMA wherever the rows are 16-byte multiples (and the pointers aligned,
// which the wrappers check); byte gathers by cp.async otherwise
template <typename TX>
int dispatch(Args& a, cudaStream_t st) {
  return a.k % 16 == 0 ? launch<TX, true>(a, st) : launch<TX, false>(a, st);
}

bool valid(int m, int n, int k, int splits) {
  return m > 0 && n > 0 && k > 0 && splits >= 1 && splits <= cdiv(k, BK) &&
         static_cast<long long>(cdiv(m, BM)) * cdiv(n, BN) * splits < (1LL << 31);
}

// the split count with none of its k ranges empty: ceil(steps / per)
// splits of per = ceil(steps / splits) steps each
int balanced(int k, int splits) {
  const int steps = cdiv(k, BK);
  return cdiv(steps, cdiv(steps, splits));
}

}  // namespace

F5_EXPORT_ERROR_STRING

// The TPU kernel's function.  x_q: int8 [m, k], x_scale: fp32 [m], w_q:
// int8 [n, k], w_scale: fp32 [n], out: fp32 [m, n]; part: int32
// [tiles, splits, 128 * 256] scratch when splits > 1 (tiles = ceil(m / 128)
// ceil(n / 256)); sync: uint32 [1 + tiles], zeroed once and left so; all
// contiguous and 16-byte aligned on the device.  1 <= splits <= ceil(k /
// 128), lowered where a split would be empty.  Returns cudaGetLastError().
extern "C" int int8_matmul(const void* x_q, const void* x_scale, const void* w_q,
                           const void* w_scale, void* out, void* part, void* sync, int m, int n,
                           int k, int splits, void* stream) {
  if (!valid(m, n, k, splits)) return cudaErrorInvalidValue;
  Args a{};
  a.xq = static_cast<int8_t*>(const_cast<void*>(x_q));
  a.xs = static_cast<float*>(const_cast<void*>(x_scale));
  a.wq = static_cast<const int8_t*>(w_q);
  a.ws = static_cast<const float*>(w_scale);
  a.out = out;
  a.part = static_cast<int4*>(part);
  a.sync = static_cast<unsigned*>(sync);
  a.m = m;
  a.n = n;
  a.k = k;
  a.splits = balanced(k, splits);
  a.gemm = 1;
  return dispatch<float>(a, static_cast<cudaStream_t>(stream));
}

// The serving linear.  x: [m, k] of x_dtype (kBFloat16 or kFloat32); bias:
// [n] of x_dtype or null; out: [m, n] of x_dtype; x_q int8 [m, k] and
// x_scale fp32 [m] receive the quantized rows; the rest as int8_matmul.
// phases: 3 runs both phases in one cooperative launch; 1 only the row
// quantization; 2 only the product, from the x_q and x_scale given.
extern "C" int int8_linear(const void* x, int x_dtype, void* x_q, void* x_scale, const void* w_q,
                           const void* w_scale, const void* bias, void* out, void* part,
                           void* sync, int m, int n, int k, int splits, int phases,
                           void* stream) {
  if (!valid(m, n, k, splits) || phases < 1 || phases > 3) return cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.xq = static_cast<int8_t*>(x_q);
  a.xs = static_cast<float*>(x_scale);
  a.wq = static_cast<const int8_t*>(w_q);
  a.ws = static_cast<const float*>(w_scale);
  a.bias = bias;
  a.out = out;
  a.part = static_cast<int4*>(part);
  a.sync = static_cast<unsigned*>(sync);
  a.m = m;
  a.n = n;
  a.k = k;
  a.splits = balanced(k, splits);
  a.quantize = phases & 1;
  a.gemm = (phases >> 1) & 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBFloat16) return dispatch<bf16>(a, st);
  if (x_dtype == kFloat32) return dispatch<float>(a, st);
  return cudaErrorInvalidValue;
}
