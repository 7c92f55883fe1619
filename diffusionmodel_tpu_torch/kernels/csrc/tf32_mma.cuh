// 3xTF32 tensor-core products and cp.async staging for Hopper (sm_90a),
// shared by the flash-attention forward (flash_attn.cu) and backward
// (flash_attn_bwd.cu).
//
// A product of fp32 operands at about fp32 accuracy from three TF32
// mma.sync products: each operand x is split into hi = tf32(x) and lo =
// x - hi, and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b (mma3). Fragments
// follow mma.sync.m16n8k8's layout; g = lane / 4, t = lane % 4.
// Shared-memory tiles hold fp32 rows pitch(D) floats apart and are filled
// by cp.async (stage), with ragged rows zero-filled.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Floats per shared-memory row: D + 4 puts the 8 rows a fragment load
// touches on 8 distinct groups of 4 banks.
__host__ __device__ constexpr int pitch(int d) { return d + 4; }

// --- 3xTF32 tensor-core products -------------------------------------------

// x = hi + lo: hi rounded to TF32 (nearest, ties away), lo = x - hi exact;
// the tensor core reads lo's top 19 bits (round toward zero), so the pair
// carries x to 2^-21 relative.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An m16k8 A fragment and a k8n8 B fragment, each as hi and lo halves.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at fp32 accuracy: the two cross terms, then hi * hi.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// acc += tile: the tensor cores truncate as they accumulate, so a sum over a
// whole sequence kept in their accumulator drifts toward zero (3-4e-5 of
// max |reference| at M = 4096 on an H100, 10x the fp32 kernels' error).
// Each streamed tile's products go to a fragment that starts at zero and
// is added here with fp32 adds, which round to nearest.
template <int N>
__device__ __forceinline__ void add_tile(float (&acc)[N][4],
                                         const float (&tile)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += tile[j][e];
}

// Fragments from shared memory (row pitch P floats); g = lane / 4,
// t = lane % 4. A of a row-major [rows, k] block, `s` at (g, t):
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
template <int P>
__device__ __forceinline__ FragA load_a(const float* s) {
  FragA f;
  split(s[0], f.hi[0], f.lo[0]);
  split(s[8 * P], f.hi[1], f.lo[1]);
  split(s[4], f.hi[2], f.lo[2]);
  split(s[8 * P + 4], f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = S[n][k] of a row-major streamed tile S (rows are the n index),
// `s` at S(g, t): b0 (k = t, n = g), b1 (k = t+4, n = g).
__device__ __forceinline__ FragB load_bt(const float* s) {
  FragB f;
  split(s[0], f.hi[0], f.lo[0]);
  split(s[4], f.hi[1], f.lo[1]);
  return f;
}

// B[k][n] = S[k][n] with the k index renumbered as in acc_to_a
// (k = t -> row 2t, k = t+4 -> row 2t+1), `s` at S(2t, g).
template <int P>
__device__ __forceinline__ FragB load_b(const float* s) {
  FragB f;
  split(s[0], f.hi[0], f.lo[0]);
  split(s[P], f.hi[1], f.lo[1]);
  return f;
}

// An m16n8 accumulator (rows g, g+8; columns 2t, 2t+1) as the A fragment of
// the next product, its columns renumbered (2t -> k = t, 2t+1 -> k = t+4).
__device__ __forceinline__ FragA acc_to_a(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// 2^x by the SFU (ex2.approx.ftz: ~2 ulp; results below 2^-126 flush to
// 0, where p is negligible), without exp2f's denormal handling.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --- cp.async staging --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; with full = false nothing is read and
// the destination is zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group (the newest) is in flight.
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of a [*, D] operand (row stride `stride` floats,
// `src` already at the head's first column) into shared-memory rows of
// pitch(D); rows at or past `limit` are zero-filled.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long stride, int r0, int limit) {
  constexpr int C4 = D / 4, P = pitch(D);
#pragma unroll
  for (int step = 0; step < (ROWS * C4 + NT - 1) / NT; ++step) {
    const int i = threadIdx.x + step * NT;
    if (ROWS * C4 % NT != 0 && i >= ROWS * C4) break;
    const int r = i / C4, c = 4 * (i % C4);
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * P + c, ok ? src + (r0 + r) * stride + c : src, ok);
  }
}

// Blocks above 48 KB of dynamic shared memory must ask for it first.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

}  // namespace
