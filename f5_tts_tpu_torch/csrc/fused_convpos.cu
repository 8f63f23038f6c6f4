// Fused ConvPositionEmbedding, forward only, for Hopper (sm_90a): kernel B.
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
// Bound on the H100: 2 convs x 31 taps x 64 inputs = 3968 multiply-adds per
// output element against 4 bytes in and out (bf16): compute-bound at the
// bf16 tensor-core rate.
//
// Design.  A grouped conv's output group depends only on its input group,
// so the chain is separable per (batch row, group).  Each conv is an
// implicit GEMM with k = 31 taps x 64 input channels:
//   out[r, o] = sum_t sum_c x[r + t - 15, c] W_t[o, c],
// one wgmma.mma_async m64n64k16 chain per tap (bf16 in, fp32 accumulate).
// A block takes one (tile of ROWS output rows, group, batch row) and is one
// warpgroup (4 warps) per 64 rows of conv1's output: conv1 computes the
// ROWS + 30 rows that conv2 reads (rounded up to 64), conv2 the ROWS
// output rows, on ROWS / 64 of the warpgroups.  The x tile, with its 30-row
// halo on each side, and conv1's result stay in shared memory as bf16 in
// the 128-byte-swizzled layout, so the intermediate never reaches device
// memory.  The left operand is the x (or intermediate) rows shifted by the
// tap, read into registers by ldmatrix: every lane gives its own row
// address, so a window that starts on any row reads as well as an aligned
// one (a shared-memory descriptor of a 128-byte-swizzled tile would have to
// start on a whole 8-row swizzle group).  The right operand is the tap's
// weight tile W_t [c_out][c_in] (K-major, 8 KB in bf16) through a
// descriptor.  Both convs' 62 taps exceed shared memory, so they stream
// through a ring of STAGES stages by raw 16-byte cp.async, issued
// STAGES - 1 taps ahead with one barrier per tap; conv2's first taps load
// while conv1's last ones run.  The weights arrive in the kernel's
// tap-major layout [parts][groups][31][c_out][c_in] bf16, made once per
// engine (ops/fused_convpos.py).  Mish and the masks run in the fp32
// epilogue of each conv, with the JAX formulation of softplus; the output
// leaves through shared memory in 16-byte stores.  A row tile that lies
// wholly past len writes zeros and returns.
//
// The fp32 instance (SPLIT) keeps fp32-class accuracy with three bf16
// products on the same tiles: x, the intermediate and the weights are each
// split into a bf16 high part and a bf16 low part (the rounding error of the
// high part), and each tap accumulates hi.hi + hi.lo + lo.hi in fp32; the
// dropped lo.lo term is ~2^-16 of the product.
//
// The configurations (output rows per block, ring stages) built are those
// timed on the card; the wrapper chooses one (ops/fused_convpos.py CONFIG).

#include "common.cuh"  // the wgmma, swizzle and ring helpers

namespace {

using bf16 = __nv_bfloat16;

constexpr int KS = 31;            // taps
constexpr int HALF = KS / 2;      // 15
constexpr int DG = 64;            // channels per group
constexpr int TAP = DG * DG;      // weights of one tap (elements)
constexpr int TAP_BYTES = TAP * 2;

template <int ROWS, int STAGES, bool SPLIT>
struct Conv {
  static constexpr int M1 = (ROWS + 2 * HALF + 63) / 64;  // conv1 row tiles = warpgroups
  static constexpr int M2 = ROWS / 64;                    // conv2 row tiles
  static constexpr int NT = M1 * 128;
  static constexpr int IR = M1 * 64;                      // intermediate rows computed
  static constexpr int XR = IR + 2 * HALF;                // x rows staged
  static constexpr int P = SPLIT ? 2 : 1;                 // bf16 parts (hi, lo)
  static constexpr int kX = ((XR * kSwRow + 1023) / 1024) * 1024;  // one part of the x tile
  static constexpr int kI = IR * kSwRow;                  // one part of the intermediate
  static constexpr int kStage = P * TAP_BYTES;
  static constexpr int bytes = P * (kX + kI) + STAGES * kStage;
  static_assert(ROWS % 64 == 0, "output rows come in 64-row tiles");
  static_assert(P * (kX + kI) >= store_rows_bytes<float, NT>(),
                "the output is staged over the x tile and the intermediate");
};

__device__ __forceinline__ float mish(float x) {
  // softplus as logaddexp(x, 0), the JAX formulation
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

// tap u of the 62 (conv1's 31, then conv2's) into a ring stage: the tap's
// [c_out][c_in] tile of each part
template <int NT, int P>
__device__ __forceinline__ void load_tap(unsigned char* st, const bf16* __restrict__ w1t,
                                         const bf16* __restrict__ w2t, size_t part_stride,
                                         int g, int u) {
  const bf16* src = (u < KS ? w1t : w2t) + (static_cast<size_t>(g) * KS + u % KS) * TAP;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    for (int idx = threadIdx.x; idx < DG * 8; idx += NT) {
      const int r = idx >> 3, c = idx & 7;
      cp_async16(st + p * TAP_BYTES + swz(r, c), src + p * part_stride + r * DG + c * 8, 16);
    }
  }
}

// x rows [r0 - 30, r0 - 30 + XR) of group g into the swizzled tile(s);
// logical rows outside [0, L) read as 0.  bf16 by cp.async; fp32 split into
// its bf16 high and low parts by plain loads and stores.
template <typename T, int NT, int XR, int KX>
__device__ __forceinline__ void load_x(unsigned char* xs, const T* __restrict__ x, size_t row_base,
                                       int r0, int L, int d, int ch0) {
  for (int idx = threadIdx.x; idx < XR * 8; idx += NT) {
    const int s = idx >> 3, c = idx & 7;
    const int row = r0 - 2 * HALF + s;
    const bool in = row >= 0 && row < L;
    const T* src = x + (row_base + (in ? row : 0)) * d + ch0 + c * 8;
    if constexpr (sizeof(T) == 2) {
      cp_async16(xs + swz(s, c), in ? src : x, in ? 16 : 0);
    } else {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (in) load8(src, f);
      uint4 hi, lo;
      uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = f[2 * e], b = f[2 * e + 1];
        const float ah = __bfloat162float(__float2bfloat16(a));
        const float bh = __bfloat162float(__float2bfloat16(b));
        h[e] = pack_bf16(ah, bh);
        l[e] = pack_bf16(a - ah, b - bh);
      }
      *reinterpret_cast<uint4*>(xs + swz(s, c)) = hi;
      *reinterpret_cast<uint4*>(xs + KX + swz(s, c)) = lo;
    }
  }
}

// One tap for a warpgroup's 64 rows: acc += A(rows [row0, row0 + 16) of
// this warp, shifted by the tap) . W_t^T, A from `a` (and its low part at
// a + part bytes in the SPLIT instance), W_t from the stage at wdesc
template <bool SPLIT>
__device__ __forceinline__ void conv_tap(const unsigned char* a, int part, int row0,
                                         uint64_t wdesc, float (&acc)[32], int lane) {
  uint32_t ah[4][4];
  load_a(a, row0, lane, ah);
  if constexpr (SPLIT) {
    uint32_t al[4][4];
    load_a(a + part, row0, lane, al);
    constexpr uint64_t LO = TAP_BYTES >> 4;  // the stage's low part, in descriptor units
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64<0>(acc, ah[kk], wdesc + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64<0>(acc, ah[kk], wdesc + LO + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64<0>(acc, al[kk], wdesc + 2 * kk, 1);
    wg_commit();
    wg_wait<0>();
    hold(al);
  } else {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64<0>(acc, ah[kk], wdesc + 2 * kk, 1);
    wg_commit();
    wg_wait<0>();
  }
  hold(acc);
  hold(ah);
}

template <typename T, int ROWS, int STAGES>
__global__ void __launch_bounds__(Conv<ROWS, STAGES, sizeof(T) == 4>::NT, 1)
convpos_fwd_kernel(const T* __restrict__ x, const bf16* __restrict__ w1t,
                   const T* __restrict__ b1, const bf16* __restrict__ w2t,
                   const T* __restrict__ b2, const int* __restrict__ lens, T* __restrict__ out,
                   int n, int d) {
  constexpr bool SPLIT = sizeof(T) == 4;
  using C = Conv<ROWS, STAGES, SPLIT>;
  constexpr int NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* xs = smem;                      // P x [XR][64] x rows r0-30 ..
  unsigned char* is = xs + C::P * C::kX;         // P x [IR][64] conv1 rows r0-15 ..
  unsigned char* ring = is + C::P * C::kI;       // STAGES x P weight taps

  const int r0 = blockIdx.x * ROWS;
  const int g = blockIdx.y;
  const int bi = blockIdx.z;
  const int L = min(max(lens[bi], 0), n);
  const size_t row_base = static_cast<size_t>(bi) * n;
  const int ch0 = g * DG;
  const int rows = min(ROWS, n - r0);
  T* dst = out + (row_base + r0) * d + ch0;

  if (r0 >= L) {  // every output row of the tile is masked
    constexpr int CPR = DG * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < rows * CPR; i += NT) {
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(
          dst + static_cast<size_t>(i / CPR) * d) + (i % CPR) * 16) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const size_t part_stride = static_cast<size_t>(d / DG) * KS * TAP;  // hi -> lo weights
  constexpr int U = 2 * KS;
  load_x<T, NT, C::XR, C::kX>(xs, x, row_base, r0, L, d, ch0);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    load_tap<NT, C::P>(ring + st * C::kStage, w1t, w2t, part_stride, g, st);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  fence_proxy_async();
  __syncthreads();

  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;  // this warp's first row
  const int wg = threadIdx.x >> 7;
  const int t4 = lane & 3, ra = wr + (lane >> 2);  // this thread's rows ra, ra + 8
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int u = 0; u < U; ++u) {
    // tap u has landed; every warpgroup is done with tap u - 1, whose stage
    // takes tap u + STAGES - 1
    const int nxt = u + STAGES - 1;
    if (nxt < U) load_tap<NT, C::P>(ring + (nxt % STAGES) * C::kStage, w1t, w2t, part_stride, g, nxt);
    cp_async_commit();
    const uint64_t wdesc = sw128_desc(ring + (u % STAGES) * C::kStage);
    if (u < KS) {
      conv_tap<SPLIT>(xs, C::kX, wr + u, wdesc, acc, lane);  // conv1: x rows shifted by u
    } else if (wg < C::M2) {
      conv_tap<SPLIT>(is, C::kI, wr + u - KS, wdesc, acc, lane);  // conv2
    }
    if (u == KS - 1) {
      // conv1's epilogue: intermediate row i is logical row r0 - 15 + i,
      // zero outside [0, L), rounded to T, stored as the bf16 part(s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = ra + 8 * h, row = r0 - HALF + i;
        const bool in = row >= 0 && row < L;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int o = j * 8 + t4 * 2;
          float v0 = 0.f, v1 = 0.f;
          if (in) {
            v0 = to_float(from_float<T>(mish(acc[4 * j + 2 * h] + to_float(b1[ch0 + o]))));
            v1 = to_float(from_float<T>(mish(acc[4 * j + 2 * h + 1] + to_float(b1[ch0 + o + 1]))));
          }
          unsigned char* p = is + swz(i, j) + t4 * 4;
          *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
          if constexpr (SPLIT) {
            const float h0 = __bfloat162float(__float2bfloat16(v0));
            const float h1 = __bfloat162float(__float2bfloat16(v1));
            *reinterpret_cast<uint32_t*>(p + C::kI) = pack_bf16(v0 - h0, v1 - h1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    cp_async_wait<STAGES - 2>();  // the barrier also publishes the intermediate
    fence_proxy_async();
    __syncthreads();
  }
  cp_async_wait<0>();  // only empty groups can remain

  // conv2's epilogue: output row i is logical row r0 + i, zero from L on
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = r0 + ra + 8 * h < L;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& a = acc[4 * j + 2 * h + e];
        a = in ? mish(a + to_float(b2[ch0 + j * 8 + t4 * 2 + e])) : 0.f;
      }
    }
  }
  // the tiles were last read before the loop's last barrier
  store_rows<T, NT>(dst, rows, smem, acc, 1.f, lane, d);
}

template <typename T, int ROWS, int STAGES>
int launch_cfg(const void* x, const void* w1t, const void* b1, const void* w2t, const void* b2,
               const void* lens, void* out, int b, int n, int d, int groups, cudaStream_t st) {
  using C = Conv<ROWS, STAGES, sizeof(T) == 4>;
  constexpr int bytes = C::bytes + 1024;
  auto kern = convpos_fwd_kernel<T, ROWS, STAGES>;
  if (int err = static_cast<int>(
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))) {
    return err;
  }
  const dim3 grid((n + ROWS - 1) / ROWS, groups, b);
  kern<<<grid, C::NT, bytes, st>>>(static_cast<const T*>(x), static_cast<const bf16*>(w1t),
                                   static_cast<const T*>(b1), static_cast<const bf16*>(w2t),
                                   static_cast<const T*>(b2), static_cast<const int*>(lens),
                                   static_cast<T*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}

// The configurations built, (output rows per block, ring stages):
// (64, 4), (128, 4), (128, 6), (192, 4)
template <typename T>
int dispatch(const void* x, const void* w1t, const void* b1, const void* w2t, const void* b2,
             const void* lens, void* out, int b, int n, int d, int groups, int rows, int stages,
             cudaStream_t st) {
  if (rows == 64 && stages == 4)
    return launch_cfg<T, 64, 4>(x, w1t, b1, w2t, b2, lens, out, b, n, d, groups, st);
  if (rows == 128 && stages == 4)
    return launch_cfg<T, 128, 4>(x, w1t, b1, w2t, b2, lens, out, b, n, d, groups, st);
  if (rows == 128 && stages == 6)
    return launch_cfg<T, 128, 6>(x, w1t, b1, w2t, b2, lens, out, b, n, d, groups, st);
  if (rows == 192 && stages == 4)
    return launch_cfg<T, 192, 4>(x, w1t, b1, w2t, b2, lens, out, b, n, d, groups, st);
  return cudaErrorInvalidValue;
}

}  // namespace

F5_EXPORT_ERROR_STRING

// x, out: [b, n, d] contiguous, 16-byte aligned; b1, b2: [d]; all of one
// dtype (kFloat32 or kBFloat16).  w1t, w2t: the tap-major weights
// [parts][groups][31][64 c_out][64 c_in] bf16, one part (bf16 x) or two
// (fp32 x: the high and the low bf16 parts).  lens: int32 [b].  d must be
// 64 * groups.  (rows, stages): a built configuration, (64, 4), (128, 4),
// (128, 6) or (192, 4).  Returns cudaGetLastError() (or the error of the
// shared-memory attribute).
extern "C" int fused_convpos_fwd(const void* x, const void* w1t, const void* b1, const void* w2t,
                                 const void* b2, const void* lens, void* out, int b, int n, int d,
                                 int groups, int dtype, int rows, int stages, void* stream) {
  if (groups <= 0 || d != groups * DG || n <= 0 || b <= 0 || b > 65535 || groups > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    return dispatch<bf16>(x, w1t, b1, w2t, b2, lens, out, b, n, d, groups, rows, stages, st);
  }
  if (dtype == kFloat32) {
    return dispatch<float>(x, w1t, b1, w2t, b2, lens, out, b, n, d, groups, rows, stages, st);
  }
  return cudaErrorInvalidValue;
}
