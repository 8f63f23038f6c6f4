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

// ---------------------------------------------------------------------------
// wgmma operands in 128-byte-swizzled shared-memory tiles (sm_90a).  A tile
// row is 64 bf16 (128 bytes, one swizzle row); 16-byte chunk c of row r
// lies at chunk c ^ (r % 8), and a tile starts on a 1024-byte boundary (one
// swizzle atom of 8 rows).  The same tile is a K-major operand (its rows
// are the M or N axis, its columns the k axis) and an MN-major one (its
// rows are the k axis).

constexpr int kSwCols = 64;    // bf16 per tile row
constexpr int kSwRow = 128;    // bytes per tile row

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return r * kSwRow + ((c ^ (r & 7)) << 4); }

// rows [r0, r0 + rows) of a bf16 [n, 64] matrix into the swizzled tile s by
// 16-byte cp.async, zeros past n
template <int NT>
__device__ __forceinline__ void load_rows(unsigned char* s, const __nv_bfloat16* __restrict__ g,
                                          int n, int r0, int rows) {
  for (int idx = threadIdx.x; idx < rows * (kSwCols / 8); idx += NT) {
    const int r = idx >> 3, c = idx & 7;
    const bool in = r0 + r < n;
    cp_async16(s + swz(r, c), in ? g + static_cast<size_t>(r0 + r) * kSwCols + c * 8 : g,
               in ? 16 : 0);
  }
}

// A fragments (mma / wgmma register layout) of rows [w0, w0 + 16) x 64 of
// a swizzled tile, one 16-column step per kc.  w0 is any row: each lane
// gives its own row address, so a window shifted by any row count reads
// as well as an aligned one.
__device__ __forceinline__ void load_a(const unsigned char* t, int w0, int lane,
                                       uint32_t (&a)[4][4]) {
  const int row = w0 + (lane & 7) + ((lane >> 3) & 1) * 8, hi = lane >> 4;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) ldmatrix_x4(a[kc], t + swz(row, kc * 2 + hi));
}

// Pack accumulator block j (columns 8j..8j+7, the four values at c) into
// the A fragments of the same tile used as the left operand of the next
// product (the accumulator and A layouts put the same (row, column) in the
// same thread)
template <int KC>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KC][4], int j, const float* c) {
  const int kc = j >> 1, hi = (j & 1) * 2;
  a[kc][hi] = pack_bf16(c[0], c[1]);
  a[kc][hi + 1] = pack_bf16(c[2], c[3]);
}

// wgmma descriptor of a 128-byte-swizzled operand at p (1024-byte aligned
// swizzle atoms of 8 rows): stride between 8-row groups 1024 bytes.  As
// K-major B (tile rows are the n axis) a 16-column k step adds 32 bytes;
// as MN-major B (tile rows are the k axis, trans-b) a 16-row k step adds
// 2048.  Offsets are added in 16-byte units to the low field.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// keep the compiler from touching registers an in-flight wgmma reads or writes
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int KC>
__device__ __forceinline__ void hold(uint32_t (&a)[KC][4]) {
#pragma unroll
  for (int i = 0; i < KC; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
  }
}
// generic-proxy writes (cp.async) made visible to wgmma's async-proxy reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d(64 x 64) (+)= a(64 x 16, registers) . B(16 x 64, descriptor);
// TRANS_B: B is MN-major (its tile rows are the k axis)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

// d(64 x 32) (+)= a(64 x 16, registers) . B(16 x 32, K-major descriptor)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The block's [warps x 16, 64] fp32 accumulators (a warp's 16 rows each, in
// the wgmma layout), times mul, as TO through shared memory into rows
// [0, rows) of dst (row stride ld elements) with 16-byte stores.  The
// caller makes sure no thread still reads ``smem`` and no copy into it is
// in flight.
template <typename TO, int NT>
__device__ __forceinline__ void store_rows(TO* __restrict__ dst, int rows, unsigned char* smem,
                                           const float (&acc)[32], float mul, int lane,
                                           int ld = kSwCols) {
  constexpr int LDO = kSwCols + 16 / static_cast<int>(sizeof(TO));  // padded row, 16-byte multiple
  constexpr int CPR = kSwCols * static_cast<int>(sizeof(TO)) / 16;  // 16-byte chunks per row
  TO* so = reinterpret_cast<TO*>(smem);
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2), c = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      TO* p = so + (r + h * 8) * LDO + j * 8 + c;
      p[0] = from_float<TO>(acc[4 * j + 2 * h] * mul);
      p[1] = from_float<TO>(acc[4 * j + 2 * h + 1] * mul);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * CPR; idx += NT) {
    const int rr = idx / CPR, cc = idx % CPR;
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(dst + static_cast<size_t>(rr) * ld) +
                              cc * 16) =
        *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(so + rr * LDO) +
                                        cc * 16);
  }
}
// bytes store_rows stages for a block of NT threads
template <typename TO, int NT>
constexpr int store_rows_bytes() {
  return NT / 32 * 16 * (kSwCols + 16 / static_cast<int>(sizeof(TO))) * static_cast<int>(sizeof(TO));
}

// dynamic shared memory, its start rounded up to the 1024 bytes a swizzle
// atom needs (the launch asks for 1024 bytes more)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return raw + ((1024 - (a & 1023)) & 1023);
}

#define F5_EXPORT_ERROR_STRING                                 \
  extern "C" const char* cuda_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));   \
  }
