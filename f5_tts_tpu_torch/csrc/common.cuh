// Shared helpers of the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// element types the wrappers pass as an int code
enum DtypeCode : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive elements as floats (16-byte aligned source)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): A holds (row g | g+8, cols 2t, 2t+1
// | 2t+8, 2t+9); B holds (k rows 2t, 2t+1 | 2t+8, 2t+9, column g), so a B
// stored as S[n][k] is read with one 32-bit load per register; D holds
// (row g | g+8, cols 2t, 2t+1).
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared (sm_80+); ``src_bytes`` < 16
// zero-fills the rest of the 16 bytes, so 0 gives a zero chunk (the source
// address must still be a valid one).  Commit / wait group the copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
// 4-byte asynchronous copy global -> shared (fp32 rows whose start need not
// be 16-byte aligned); ``src_bytes`` 0 writes a zero
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Four 8x8 b16 matrices from shared memory: lane l gives the row address of
// matrix l / 8, row l % 8, and register i receives row g, columns 2t, 2t+1
// of matrix i (g = lane / 4, t = lane % 4).  From a row-major [rows][k]
// tile, matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) in the order (0, 0),
// (8, 0), (0, 8), (8, 8) are the A fragment of mma_16816 and of wgmma with
// A in registers.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Four 8x8 b16 matrices from shared memory, transposed: lane l gives the
// row address of matrix l / 8, row l % 8, and register i receives matrix i
// transposed, i.e. (M[2t][g], M[2t+1][g]) for g = lane / 4, t = lane % 4.
// From a row-major [k][n] tile that is mma_16816's B fragment (k rows 2t,
// 2t+1, column g): ldmatrix.trans reads B straight from a row-major layout.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Key-column mask of the flash-attention kernels: keys valid in
// [0, a) U [s0, s1).  The single-prefix mode reads lens int32 [b] and has an
// empty second segment; the two-segment mode (MMDiT's joint [audio, text]
// sequence, the TPU kernels' static `seg`) reads lens int32 [b, 2] as
// (len_a, len_t) and puts the second segment at [seg, seg + len_t).  Every
// bound is clamped to [0, n], so a column at or past n is never valid.
struct KeyMask {
  int a, s0, s1;
  __device__ __forceinline__ bool valid(int col) const {
    return col < a || (col >= s0 && col < s1);
  }
  // does [c0, c1) hold a valid key?
  __device__ __forceinline__ bool any(int c0, int c1) const {
    return c0 < a || (s0 < s1 && c0 < s1 && c1 > s0);
  }
  // is every key of [c0, c1) (0 <= c0 < c1) valid?  When s0 <= a the two
  // segments join into [0, max(a, s1)).
  __device__ __forceinline__ bool all(int c0, int c1) const {
    return c1 <= a || (c1 <= s1 && (c0 >= s0 || s0 <= a));
  }
};

template <bool SEG>
__device__ __forceinline__ KeyMask key_mask(const int* __restrict__ lens, int b, int n, int seg) {
  KeyMask m;
  if constexpr (SEG) {
    m.a = min(max(lens[2 * b], 0), n);
    const int lt = min(max(lens[2 * b + 1], 0), n);
    m.s0 = min(max(seg, 0), n);
    m.s1 = min(m.s0 + lt, n);
  } else {
    m.a = min(max(lens[b], 0), n);
    m.s0 = m.s1 = 0;
  }
  return m;
}

// The key tiles of width bk that hold a valid key, in order: [0, t1) (the
// first segment) and [t2, t3) (the tiles covering the second segment that
// the first range has not visited).  Tiles wholly inside the gap [a, s0)
// are skipped; a tile that straddles a boundary is visited once and keeps
// its per-column test.
struct KeyTiles {
  int t1, t2, t3;
  __device__ __forceinline__ int count() const { return t1 + t3 - t2; }
  __device__ __forceinline__ int tile(int i) const { return i < t1 ? i : t2 + (i - t1); }
};

__device__ __forceinline__ KeyTiles key_tiles(const KeyMask& m, int bk) {
  KeyTiles t;
  t.t1 = (m.a + bk - 1) / bk;
  if (m.s1 > m.s0) {
    t.t2 = max(t.t1, m.s0 / bk);
    t.t3 = max(t.t2, (m.s1 + bk - 1) / bk);
  } else {
    t.t2 = t.t3 = t.t1;
  }
  return t;
}

#define F5_EXPORT_ERROR_STRING                                 \
  extern "C" const char* cuda_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));   \
  }
