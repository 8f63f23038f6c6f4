// Software-pipelined masked flash attention, forward, for Hopper (sm_90a):
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
// Design.  Kernel A stages each 64-key tile with plain loads into
// registers and shared memory and overlaps nothing (csrc/flash_attention.cu).
// Here, per block of WARPS x 16 query rows:
//  - K and V tiles are double-buffered in shared memory and filled with
//    16-byte cp.async copies (zero-filled past n), issued one iteration
//    ahead: while tile j is used, K_{j+2} and V_{j+1} are in flight;
//  - tile j+1's scores q K_{j+1}^T (mma.sync) are issued before tile j's
//    online softmax and p V_j, so a warp's tensor-core work and its exp2 /
//    shuffle work are independent instructions the scheduler can overlap;
//  - V stays row-major (a raw copy cannot transpose it): its B fragments
//    for p V come from ldmatrix.trans, where kernel A transposes V while
//    staging it.
// The numerics are kernel A's: q prescaled by scale*log2(e) in fp32, then
// rounded to bf16; exp2-domain online softmax in fp32; p rounded to bf16.
// Instances (WARPS, BK) in {(4, 64), (8, 64), (4, 32)}: 64 or 128 query rows
// per block, 64 or 32 keys per tile.
//
// Bound on the H100: as kernel A, 4 n kv dh flops per (b, h) for kv valid
// keys against 4 n dh bf16 reads and writes: compute-bound at the bf16
// tensor-core rate for n above ~600.

#include "common.cuh"

namespace {

constexpr int DH = 64;
constexpr int LDS = DH + 8;  // padded bf16 row: conflict-free fragment and ldmatrix reads

template <int WARPS, int BK>
struct PipeSmem {
  static constexpr int BQ = WARPS * 16;
  static constexpr int kQ = BQ * LDS;   // elements
  static constexpr int kKV = BK * LDS;  // one K or V tile
  static constexpr int bytes = (kQ + 4 * kKV) * 2;
};

// BK key rows [k0, k0 + BK) x 64 of one (b, h) into s [BK][LDS]; zeros past n
template <int WARPS, int BK>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* s, const __nv_bfloat16* __restrict__ g,
                                             int n, int k0, int tid) {
#pragma unroll
  for (int idx = tid; idx < BK * (DH / 8); idx += WARPS * 32) {
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    const bool in = k0 + r < n;
    cp_async16(s + r * LDS + c, in ? g + static_cast<size_t>(k0 + r) * DH + c : g, in ? 16 : 0);
  }
}

// scores of one staged K tile [NJ * 8][LDS]: 16 query rows x NJ * 8 keys
// per warp, in the log2 domain (q carries scale * log2 e)
template <int NJ>
__device__ __forceinline__ void tile_scores(const __nv_bfloat16* tk, const uint32_t (&qa)[4][4],
                                            float (&s)[NJ][4], int g, int t4) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const int c = kc * 16 + t4 * 2;
      mma_16816(s[j], qa[kc], ld_u32(&tk[(j * 8 + g) * LDS + c]),
                ld_u32(&tk[(j * 8 + g) * LDS + c + 8]));
    }
  }
}

template <int WARPS, int BK>
__global__ void __launch_bounds__(WARPS * 32)
flash_pipe_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
                  __nv_bfloat16* __restrict__ o, int heads, int n, float qscale) {
  using S = PipeSmem<WARPS, BK>;
  constexpr int NT = WARPS * 32;
  constexpr int NJ = BK / 8;    // score column tiles of 8
  constexpr int NKC = BK / 16;  // k-chunks of 16 keys for p V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + S::kQ;       // [2][BK][LDS]
  __nv_bfloat16* sV = sK + 2 * S::kKV;  // [2][BK][LDS]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * S::BQ;
  const int kv_len = min(max(lens[bh / heads], 0), n);
  const int n_tiles = (kv_len + BK - 1) / BK;
  const size_t base = static_cast<size_t>(bh) * n * DH;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // prologue: K_0, V_0 and K_1 in flight while q is staged
  if (n_tiles > 0) {
    load_kv_tile<WARPS, BK>(sK, kb, n, 0, tid);
    load_kv_tile<WARPS, BK>(sV, vb, n, 0, tid);
  }
  if (n_tiles > 1) load_kv_tile<WARPS, BK>(sK + S::kKV, kb, n, BK, tid);
  cp_async_commit();
  for (int idx = tid; idx < S::BQ * DH / 8; idx += NT) {
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < n) load8(q + base + static_cast<size_t>(q0 + r) * DH + c, f);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      *reinterpret_cast<uint32_t*>(&sQ[r * LDS + c + e]) =
          pack_bf16(f[e] * qscale, f[e + 1] * qscale);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qa[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + t4 * 2;
    qa[kc][0] = ld_u32(&sQ[(wr + g) * LDS + c]);
    qa[kc][1] = ld_u32(&sQ[(wr + g + 8) * LDS + c]);
    qa[kc][2] = ld_u32(&sQ[(wr + g) * LDS + c + 8]);
    qa[kc][3] = ld_u32(&sQ[(wr + g + 8) * LDS + c + 8]);
  }

  float acc[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float s_cur[NJ][4], s_next[NJ][4];
  if (n_tiles > 0) tile_scores<NJ>(sK, qa, s_cur, g, t4);

  for (int it = 0; it < n_tiles; ++it) {
    // K_{it+1} and V_it landed; every warp is done with K_it and V_{it-1}
    cp_async_wait<0>();
    __syncthreads();
    if (it + 2 < n_tiles) {
      load_kv_tile<WARPS, BK>(sK + (it & 1) * S::kKV, kb, n, (it + 2) * BK, tid);
    }
    if (it + 1 < n_tiles) {
      load_kv_tile<WARPS, BK>(sV + ((it + 1) & 1) * S::kKV, vb, n, (it + 1) * BK, tid);
    }
    cp_async_commit();
    if (it + 1 < n_tiles) {  // issued before the softmax
      tile_scores<NJ>(sK + ((it + 1) & 1) * S::kKV, qa, s_next, g, t4);
    }

    const int k0 = it * BK;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + j * 8 + t4 * 2 + (e & 1) >= kv_len) s_cur[j][e] = -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s_cur[j][0], s_cur[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s_cur[j][2], s_cur[j][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);  // finite: a valid key
    const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);

    uint32_t pa[NKC][4];
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p0 = exp2f(s_cur[j][0] - mn_lo), p1 = exp2f(s_cur[j][1] - mn_lo);
      const float p2 = exp2f(s_cur[j][2] - mn_hi), p3 = exp2f(s_cur[j][3] - mn_hi);
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

    const __nv_bfloat16* tv = sV + (it & 1) * S::kKV;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      acc[d][0] *= a_lo;
      acc[d][1] *= a_lo;
      acc[d][2] *= a_hi;
      acc[d][3] *= a_hi;
    }
    // B fragments of V [keys][dh] by ldmatrix.trans: matrix i of lane l's
    // address is keys kc*16 + (i & 1)*8 + l % 8, columns (2 dp + i / 2) * 8
    const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &tv[(kc * 16 + (mi & 1) * 8 + rr) * LDS + (2 * dp + (mi >> 1)) * 8]);
        mma_16816(acc[2 * dp], pa[kc], b[0], b[1]);
        mma_16816(acc[2 * dp + 1], pa[kc], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s_cur[j][0] = s_next[j][0];
      s_cur[j][1] = s_next[j][1];
      s_cur[j][2] = s_next[j][2];
      s_cur[j][3] = s_next[j][3];
    }
  }

  const float dl = fmaxf(l_lo, 1e-30f), dh_ = fmaxf(l_hi, 1e-30f);
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int c = d * 8 + t4 * 2;
    if (r_lo < n) {
      *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(r_lo) * DH + c) =
          pack_bf16(acc[d][0] / dl, acc[d][1] / dl);
    }
    if (r_hi < n) {
      *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(r_hi) * DH + c) =
          pack_bf16(acc[d][2] / dh_, acc[d][3] / dh_);
    }
  }
}

template <int WARPS, int BK>
int launch_pipe(const void* q, const void* k, const void* v, const void* lens, void* o, int b,
                int h, int n, float qscale, cudaStream_t st) {
  using S = PipeSmem<WARPS, BK>;
  auto kern = flash_pipe_kernel<WARPS, BK>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + S::BQ - 1) / S::BQ, b * h);
  kern<<<grid, WARPS * 32, S::bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(o), h, n, qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

F5_EXPORT_ERROR_STRING

// q, k, v, o: bf16 [b, h, n, 64] contiguous; lens: int32 [b] on the device.
// (block_q, block_k) in {(64, 64), (128, 64), (64, 32)}.  Returns
// cudaGetLastError() (or the error of the shared-memory attribute).
extern "C" int flash_attention_pipelined(const void* q, const void* k, const void* v,
                                         const void* lens, void* o, int b, int h, int n,
                                         int block_q, int block_k, float qscale, void* stream) {
  if (n <= 0 || b <= 0 || h <= 0 || b * h > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_q == 64 && block_k == 64) {
    return launch_pipe<4, 64>(q, k, v, lens, o, b, h, n, qscale, st);
  }
  if (block_q == 128 && block_k == 64) {
    return launch_pipe<8, 64>(q, k, v, lens, o, b, h, n, qscale, st);
  }
  if (block_q == 64 && block_k == 32) {
    return launch_pipe<4, 32>(q, k, v, lens, o, b, h, n, qscale, st);
  }
  return cudaErrorInvalidValue;
}
