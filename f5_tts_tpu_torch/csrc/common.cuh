// Shared helpers of the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda.h>  // CUtensorMap (the driver's encoder is fetched at run time, not linked)
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

// A row of bf16 in the lane-strided chunks a warp reads it by: chunk i of
// this lane holds values [lane * 8 + 256 i, + 8); up to H chunks (rows of
// up to 256 H values) are loaded at once, all in flight together, so the
// row costs one memory round trip; values past k are zeros.
constexpr int kRowHold = 16;  // chunks a lane holds: rows up to 4096 bf16
__device__ __forceinline__ void load_row_bf16(const __nv_bfloat16* row, int k, int lane,
                                              uint4 (&raw)[kRowHold]) {
#pragma unroll
  for (int i = 0; i < kRowHold; ++i) {
    const int c = lane * 8 + 256 * i;
    raw[i] = c < k ? *reinterpret_cast<const uint4*>(row + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}
__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
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

// ---------------------------------------------------------------------------
// The GEMM kernels G (int8_matmul.cu) and I (fused_ln_matmul.cu) share one
// main loop: 128-row blocks of two consumer warpgroups (64 rows each), one
// 256-column wgmma per k step, both operands' k tiles streamed through a
// ring of 128-byte-swizzled shared-memory stages.

// wgmma descriptor of an MN-major operand made of 128-byte-swizzled
// [k rows][64 bf16] tiles placed lbo bytes apart along the MN axis (a
// 256-wide operand spans four); 8-row k groups 1024 bytes apart, as
// sw128_desc.  A 16-row k step adds 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* p, int lbo) {
  return (sw128_desc(p) & ~(static_cast<uint64_t>(0x3FFF) << 16)) |
         (static_cast<uint64_t>(lbo >> 4) << 16);
}

template <int N>
__device__ __forceinline__ void hold(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d(64 x 256) s32 (+)= A(64 x 32 s8) . B(32 x 256 s8), both K-major
// 128-byte-swizzled tiles through descriptors (8-bit operands are K-major only)
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t adesc, uint64_t bdesc,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

// d(64 x 256) f32 (+)= a(64 x 16 bf16, registers) . B(16 x 256 bf16,
// MN-major descriptor: its tile rows are the k axis)
__device__ __forceinline__ void wgmma_bf16_n256_t(float (&d)[128], const uint32_t (&a)[4],
                                                  uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(accumulate));
}

// Rows [r0, r0 + ROWS) x bytes [c0, c0 + 128) of a row-major byte matrix
// (rows_total rows of ld bytes, the first `cols` of each holding data) into
// the 128-byte-swizzled tile s, zeros past either edge.  VEC: ld, c0 and
// cols are multiples of 16, so a 16-byte chunk lies wholly inside or
// wholly past the edge and goes by cp.async; otherwise it is gathered byte
// by byte (through L2) and stored in place.
template <int ROWS, int NT, bool VEC>
__device__ __forceinline__ void load_tile128(unsigned char* s, const unsigned char* __restrict__ g,
                                             size_t ld, int rows_total, int r0, int cols, int c0) {
  for (int idx = threadIdx.x; idx < ROWS * 8; idx += NT) {
    const int r = idx >> 3, c = idx & 7;
    const int gr = r0 + r, gc = c0 + c * 16;
    if constexpr (VEC) {
      const bool in = gr < rows_total && gc < cols;
      cp_async16(s + swz(r, c), in ? g + static_cast<size_t>(gr) * ld + gc : g, in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gr < rows_total) {
        const unsigned char* src = g + static_cast<size_t>(gr) * ld;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          if (gc + e < cols) w[e >> 2] |= static_cast<uint32_t>(__ldcg(src + gc + e)) << (8 * (e & 3));
        }
      }
      *reinterpret_cast<uint4*>(s + swz(r, c)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// TMA: tile copies by the Tensor Memory Accelerator, completion counted on
// an mbarrier in shared memory.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the issuing thread's arrival, announcing `bytes` of copies to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// until phase `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
// box (c0, c1) (c0 along the contiguous axis, in elements) of the tensor
// map into shared memory at dst; elements past the tensor's edges arrive
// as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// fetch a tensor map's 128 bytes ahead of its first copy
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// box (c0, c1) of the tensor map from shared memory at src; the part of
// the box past the tensor's edges is not written.  Commit, then wait until
// the writes are done (bulk_wait), before the source is reused or the data
// is signalled to another block.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Host: the tensor map of a row-major [rows][cols] matrix of esize-byte
// elements (row stride ld elements; base and ld * esize multiples of 16),
// copied in boxes of [box_rows][box_cols], 128-byte swizzled (box_cols *
// esize == 128) or not.  Returns 0 or a CUDA error code.
static inline int make_tmap(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                            int esize, long long rows, long long cols, long long ld, int box_rows,
                            int box_cols, bool swizzle) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * esize)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// All blocks of a cooperative grid meet here.  Block 0 adds
// 2^31 - (blocks - 1), every other block 1, so the top bit of the word
// flips once all have arrived and its other bits return to what they
// were: the word needs no reset between launches (cooperative_groups'
// grid sync).  Writes before it, by either proxy, are visible after it.
// A grid that is not resident would wait forever; the spin traps after
// ~2 s instead.
__device__ __forceinline__ void grid_barrier(unsigned* word) {
  __threadfence();
  asm volatile("fence.proxy.async;\n" ::: "memory");  // for TMA reads of what this block wrote
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    const unsigned old = atomicAdd(word, add);
    for (long spins = 0; ((old ^ *reinterpret_cast<volatile unsigned*>(word)) & 0x80000000u) == 0;
         ++spins) {
      __nanosleep(64);
      if (spins > (1L << 25)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// The k loop of G and I over a unit's tiles [0, n), in a ring of S stages,
// S - 1 tiles issued ahead of the one in the tensor cores, one barrier per
// tile.  `base` counts the tiles this block has run through the ring
// before (tile t uses stage (base + t) % S, whose TMA barrier full[stage]
// then completes its ((base + t) / S)-th phase); it advances by n.  TMA:
// the tiles come by TMA (one thread issues them), else by cp.async from
// every thread.  `op` supplies (each __forceinline__: a wgmma pipeline
// must not cross a call)
//   load(t, s)  issues tile t's copies into stage s;
//   prep(t, s)  readies tile t's register operand from stage s (I
//               normalises its A fragments; G has none) while tile t - 1's
//               wgmma group is in the tensor cores;
//   mma(t, s)   issues tile t's wgmma group, then waits until only that
//               group is in flight (wg_wait<1>), so tile t - 1's stage and
//               registers are free once the barrier after it passes.
// Returns with every wgmma and copy done; the caller synchronises before
// reusing the ring.
template <int S, bool TMA, class Op>
__device__ __forceinline__ void ring_loop(int n, Op& op, uint64_t* full, int& base) {
  static_assert(S >= 3, "the ring keeps a tile in the tensor cores and one landed");
  auto land = [&](int t) {  // tile t has landed, for every thread
    if constexpr (TMA) {
      mbar_wait(full + (base + t) % S, ((base + t) / S) & 1);
    } else {
      cp_async_wait<S - 3>();
      fence_proxy_async();
      __syncthreads();
    }
  };
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n) op.load(t, (base + t) % S);
    if constexpr (!TMA) cp_async_commit();
  }
  if constexpr (TMA) {
    if (n > 0) land(0);
  } else {
    cp_async_wait<S - 2>();
    fence_proxy_async();
    __syncthreads();
  }
  if (n > 0) op.prep(0, base % S);
  for (int i = 0; i < n; ++i) {
    op.mma(i, (base + i) % S);
    if constexpr (TMA) {
      fence_proxy_async();  // generic reads of stage i - 1 before its refill
      __syncthreads();      // every warpgroup is done with tile i - 1
      if (i + S - 1 < n) op.load(i + S - 1, (base + i + S - 1) % S);
      if (i + 1 < n) land(i + 1);
    } else {
      land(i + 1);  // and every warpgroup is done with tile i - 1
      if (i + S - 1 < n) op.load(i + S - 1, (base + i + S - 1) % S);
      cp_async_commit();
    }
    if (i + 1 < n) op.prep(i + 1, (base + i + 1) % S);
  }
  wg_wait<0>();
  if constexpr (!TMA) cp_async_wait<0>();
  base += n;
}

// rows x cols elements of a staged tile s (row stride sld elements, `width`
// columns staged) to dst (row stride ld elements), by 16-byte chunks where
// the row stride keeps them aligned, else element by element
template <typename TO, int NT>
__device__ __forceinline__ void flush_tile(TO* __restrict__ dst, size_t ld, int rows, int cols,
                                           const TO* s, int sld, int width) {
  constexpr int CH = 16 / static_cast<int>(sizeof(TO));
  const bool vec = ld % CH == 0;
  const int cpr = width / CH;
  for (int idx = threadIdx.x; idx < rows * cpr; idx += NT) {
    const int r = idx / cpr, c = (idx % cpr) * CH;
    if (c >= cols) continue;
    TO* d = dst + static_cast<size_t>(r) * ld + c;
    const TO* src = s + r * sld + c;
    if (vec && c + CH <= cols) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < CH && c + e < cols; ++e) d[e] = src[e];
    }
  }
}

#define F5_EXPORT_ERROR_STRING                                 \
  extern "C" const char* cuda_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));   \
  }
