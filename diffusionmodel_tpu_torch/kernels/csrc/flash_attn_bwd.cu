// Flash-attention backward for Hopper (sm_90a): two passes on the tensor
// cores, 3xTF32 at fp32 accuracy.
//
//   s = q k^T / sqrt(D),  p = exp(s - L),  Delta = rowsum(do * o),
//   ds = p * (do v^T - Delta),
//   dq = ds k / sqrt(D),  dk = ds^T q / sqrt(D),  dv = p^T do
//
// q, do, o [B,N,H,D], k, v [B,M,H,D], L (the forward's logsumexp) [B,H,N].
// Both passes recompute p from L tile by tile, so no [N, M] matrix ever
// reaches device memory, and each output row is owned by exactly one block:
// no atomics, and a gradient is the same bit for bit from run to run.
//
// Replaces: the dQ pass the Pallas kernel _flash_dq_kernel
// (diffusionmodel_tpu/kernels/flash_attn.py:152, launched at :268), the
// dK/dV pass _flash_dkv_kernel (:182, launched at :285), both inside
// _flash_core_bwd (:255).
//
// Bound: operations. The dQ pass does 3 products of 2*B*H*N*M*D flops
// (q k^T, do v^T, ds k), the dK/dV pass 4 (k q^T, v do^T, p^T do, ds^T q),
// against each input read once and each output written once: at the SD
// site (2, 4096, 4096, 8, 40) about 1000 flops per byte. Every product is
// formed at fp32 accuracy from three TF32 tensor-core products, so the
// least time is 3x the flops over the H100's 495 TFLOP/s dense TF32 rate
// (0.390 ms dQ, 0.521 ms dK/dV at that site; 0.962 / 1.282 ms at the 67
// TFLOP/s fp32 CUDA-core rate). What the design does about it:
//
//   - Products: mma.sync.m16n8k8 tf32 with fp32 accumulators. Each fp32
//     operand x is split into hi = tf32(x), rounded to nearest with ties
//     away (the bits of cvt.rna.tf32.f32, which has no SASS instruction and
//     is emulated with NaN checks; an integer add and a mask suffice), and
//     lo = x - hi, exact in fp32, which the tensor core reads as TF32 by
//     dropping its low 13 bits. A product is lo*hi + hi*lo + hi*hi: about
//     fp32 accuracy, where one TF32 product misses the 1e-4 tolerance by
//     5-50x on peaked softmaxes. The split happens in registers as a
//     fragment is loaded; shared memory holds fp32. mma.sync and not
//     wgmma: TF32 wgmma takes both operands K-major from shared memory with
//     no transpose, which dq = ds k and dk = ds^T q would need.
//   - Sums: the tensor cores truncate as they accumulate, so each streamed
//     tile's contribution to dq, dk and dv is summed from zero and added to
//     the running sum with fp32 adds (add_tile).
//   - Tiling: a block owns 16 rows per warp and row group (FLASH_BWD_*_TILES
//     below) of the output it writes; the other operand streams through
//     shared-memory tiles of 16-64 rows. s and dp (or s^T and dp^T in the
//     dK/dV pass, so that p and ds come out as rows of the k tile the block
//     owns) accumulate as m16n8 fragments over D/8 k-steps, D = 40 in five
//     steps with no padding. p and ds stay in registers and become the A
//     fragments of the second products: an accumulator holds columns
//     (2t, 2t+1) where a tf32 A fragment wants (t, t+4), so the k8 index is
//     renumbered (t <- 2t, t+4 <- 2t+1) and the B rows loaded in the same
//     order.
//   - Memory: the owned rows are staged once; the streamed tiles (and, in
//     the dK/dV pass, their L and Delta) by cp.async, double-buffered, so
//     the next tile is in flight while the current one is multiplied. Rows
//     past the end are zero-filled through cp.async's src-size operand and
//     their p masked to 0. Shared-memory rows are D + 4 floats apart, which
//     makes every fragment load free of bank conflicts. Budget: at D = 40,
//     68 KB (dQ) and 45 KB (dK/dV); at D = 160, 2 x 128 owned rows + 2 x 2
//     x 16 streamed rows, 210 KB of the 227 KB a block may use (dQ).
//   - Operands are read in place through their [B,N,H,D] strides; outputs
//     are written contiguous [B,N,H,D].

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

// dQ pass. Replaces _flash_dq_kernel, which walks the K/V tiles of one q
// tile along the TPU grid's sequential axis, carries dq in VMEM scratch and
// recomputes Delta on every tile. Here a block of W warps owns (batch*head,
// 16 MT W q rows) and loops over the K/V tiles of C rows; it owns its q
// rows whole, so it computes Delta once per row and writes it as [B,H,N]
// for the dK/dV pass.
template <int D, int C, int W, int MT, int MINB>
__global__ void __launch_bounds__(32 * W, MINB)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ o,
             const float* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ dq, float* __restrict__ delta, int heads,
             int n, int m, long long q_sb, long long q_sn, long long k_sb,
             long long k_sn, long long v_sb, long long v_sn, long long o_sb,
             long long o_sn, long long do_sb, long long do_sn,
             long long dq_sb, long long dq_sn, float sl2, float scale) {
  // MT m16 row groups per warp share every B fragment they load
  constexpr int P = pitch(D), R = 16 * MT * W, NT = 32 * W, TPR = NT / R;
  static_assert(TPR == 1 || TPR == 2, "one or two threads per row");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;              // [R][P]
  float* dos = qs + R * P;       // [R][P]
  float* kvs = dos + R * P;      // 2 stages of k [C][P], v [C][P]
  float* dls = kvs + 4 * C * P;  // [R] Delta of the owned rows

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;
  const float* ob = o + b * o_sb + (long long)h * D;
  const float* db = dout + b * do_sb + (long long)h * D;

  auto stage_kv = [&](int tile) {
    float* dst = kvs + (tile & 1) * 2 * C * P;
    stage<D, C, NT>(dst, kb, k_sn, tile * C, m);
    stage<D, C, NT>(dst + C * P, vb, v_sn, tile * C, m);
  };
  stage<D, R, NT>(qs, qb, q_sn, row0, n);
  stage<D, R, NT>(dos, db, do_sn, row0, n);
  cp_commit();
  stage_kv(0);
  cp_commit();

  // Delta = rowsum(do * o): TPR threads per owned row, D / TPR values each,
  // summed in a fixed order, while the first tiles are in flight.
  {
    const int r = threadIdx.x / TPR, part = threadIdx.x % TPR,
              row = row0 + r;
    float sum = 0.f;
    if (row < n) {
      const float4* op = reinterpret_cast<const float4*>(
          ob + row * o_sn + part * (D / TPR));
      const float4* dp = reinterpret_cast<const float4*>(
          db + row * do_sn + part * (D / TPR));
#pragma unroll
      for (int i = 0; i < D / (4 * TPR); ++i) {
        const float4 x = op[i], y = dp[i];
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      }
    }
    if constexpr (TPR == 2) sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (part == 0) {
      dls[r] = sum;
      if (row < n) delta[(long long)bh * n + row] = sum;
    }
  }
  __syncthreads();

  // this thread's rows: ra[i] and ra[i] + 8 of each row group i
  int ra[MT];
  float la[MT], lb[MT], dla[MT], dlb[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    ra[i] = (warp * MT + i) * 16 + g;
    const int r = row0 + ra[i];
    la[i] = r < n ? lse[(long long)bh * n + r] * kLog2e : 0.f;
    lb[i] = r + 8 < n ? lse[(long long)bh * n + r + 8] * kLog2e : 0.f;
    dla[i] = dls[ra[i]];
    dlb[i] = dls[ra[i] + 8];
  }

  float acc[MT][D / 8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) zero(acc[i]);
  const int tiles = (m + C - 1) / C;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) stage_kv(it + 1);
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    const float* ks = kvs + (it & 1) * 2 * C * P;
    const float* vs = ks + C * P;
    const int kn = min(C, m - it * C);

    float s[MT][C / 8][4], dp[MT][C / 8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      zero(s[i]);
      zero(dp[i]);
    }
#pragma unroll
    for (int kd = 0; kd < D / 8; ++kd) {
      FragA aq[MT], ad[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        aq[i] = load_a<P>(qs + ra[i] * P + t + 8 * kd);
        ad[i] = load_a<P>(dos + ra[i] * P + t + 8 * kd);
      }
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const int at = (8 * j + g) * P + 8 * kd + t;
        const FragB bk = load_bt(ks + at), bv = load_bt(vs + at);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma3(s[i][j], aq[i], bk);
          mma3(dp[i][j], ad[i], bv);
        }
      }
    }
    // p = 2^(s sqrt(D)^-1 log2 e - L log2 e), masked past the tile's end;
    // ds = p (dp - Delta), kept in s
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo_row = e < 2;
          const float p =
              8 * j + 2 * t + (e & 1) < kn
                  ? exp2_approx(fmaf(s[i][j][e], sl2,
                                     -(lo_row ? la[i] : lb[i])))
                  : 0.f;
          s[i][j][e] = p * (dp[i][j][e] - (lo_row ? dla[i] : dlb[i]));
        }
    // dq += ds k
    float part[MT][D / 8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) zero(part[i]);
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      FragA a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) a[i] = acc_to_a(s[i][j]);
      const float* kr = ks + (8 * j + 2 * t) * P + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const FragB bk = load_b<P>(kr + 8 * nd);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma3(part[i][nd], a[i], bk);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) add_tile(acc[i], part[i]);
    __syncthreads();  // this stage is consumed before it is refilled
  }

  float* out = dq + b * dq_sb + (long long)h * D + 2 * t;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + ra[i] + 8 * half;
      if (row >= n) continue;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(out + row * dq_sn + 8 * nd) =
            make_float2(acc[i][nd][2 * half] * scale,
                        acc[i][nd][2 * half + 1] * scale);
    }
}

// One streamed q tile of the dK/dV pass for this thread's k rows: s^T =
// k q^T and (DK) dp^T = v do^T over D/8 k-steps, p^T (and ds^T), then
// (DV) dv += p^T do into tv and (DK) dk += ds^T q into tk. Columns are q
// rows, so L and Delta index columns (2t, 2t+1) of each n8 block.
template <int D, int C, bool DV, bool DK>
__device__ __forceinline__ void dkv_tile(
    const float* ka, const float* va, const float* qs, const float* dos,
    const float* ls, const float* dls, int qn, int g, int t, float sl2,
    float (&tv)[D / 8][4], float (&tk)[D / 8][4]) {
  constexpr int P = pitch(D);
  float st[C / 8][4], dpt[DK ? C / 8 : 1][4];
  zero(st);
  if constexpr (DK) zero(dpt);
#pragma unroll
  for (int kd = 0; kd < D / 8; ++kd) {
    const FragA ak = load_a<P>(ka + 8 * kd);
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      mma3(st[j], ak, load_bt(qs + (8 * j + g) * P + 8 * kd + t));
    if constexpr (DK) {
      const FragA av = load_a<P>(va + 8 * kd);
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
        mma3(dpt[j], av, load_bt(dos + (8 * j + g) * P + 8 * kd + t));
    }
  }
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const int c0 = 8 * j + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(ls + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool odd = e & 1;
      const float p =
          c0 + odd < qn
              ? exp2_approx(fmaf(st[j][e], sl2, -(odd ? l.y : l.x) * kLog2e))
              : 0.f;
      if constexpr (DK) {
        const float2 dl = *reinterpret_cast<const float2*>(dls + c0);
        dpt[j][e] = p * (dpt[j][e] - (odd ? dl.y : dl.x));
      }
      st[j][e] = p;
    }
  }
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const int at = (8 * j + 2 * t) * P + g;
    if constexpr (DV) {
      const FragA ap = acc_to_a(st[j]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        mma3(tv[nd], ap, load_b<P>(dos + at + 8 * nd));
    }
    if constexpr (DK) {
      const FragA ads = acc_to_a(dpt[j]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        mma3(tk[nd], ads, load_b<P>(qs + at + 8 * nd));
    }
  }
}

// dK/dV pass. Replaces _flash_dkv_kernel, which walks the q tiles of one k
// tile along the TPU grid's sequential axis and carries dk and dv in VMEM
// scratch. Here a block owns (batch*head, 64 k rows) and loops over the q
// tiles of C rows, staging q, do, L and the dQ pass's Delta. It computes
// the transposed scores s^T = k q^T, so p and ds are rows of its own k
// tile. With ROLES, 8 warps: warps 0-3 accumulate dv and warps 4-7 dk for
// the same 16-row groups (s^T is formed by both); without, 4 warps that
// accumulate both.
template <int D, int C, bool ROLES, int MINB>
__global__ void __launch_bounds__(ROLES ? 256 : 128, MINB)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int heads,
              int n, int m, long long q_sb, long long q_sn, long long k_sb,
              long long k_sn, long long v_sb, long long v_sn,
              long long do_sb, long long do_sn, long long dk_sb,
              long long dk_sn, long long dv_sb, long long dv_sn, float sl2,
              float scale) {
  constexpr int P = pitch(D), R = 64, NT = ROLES ? 256 : 128;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;              // [R][P]
  float* vs = ks + R * P;        // [R][P]
  float* qds = vs + R * P;       // 2 stages of q [C][P], do [C][P]
  float* lds = qds + 4 * C * P;  // 2 stages of L [C], Delta [C]

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  const bool dk_warp = ROLES && warp >= 4;
  const float* qb = q + b * q_sb + (long long)h * D;
  const float* db = dout + b * do_sb + (long long)h * D;
  const float* lb = lse + (long long)bh * n;
  const float* deb = delta + (long long)bh * n;

  auto stage_q = [&](int tile) {
    float* dst = qds + (tile & 1) * 2 * C * P;
    stage<D, C, NT>(dst, qb, q_sn, tile * C, n);
    stage<D, C, NT>(dst + C * P, db, do_sn, tile * C, n);
    float* ld = lds + (tile & 1) * 2 * C;
    for (int i = threadIdx.x; i < C; i += NT) {
      const int r = tile * C + i;
      const bool ok = r < n;
      cp_async4(ld + i, ok ? lb + r : lb, ok);
      cp_async4(ld + C + i, ok ? deb + r : deb, ok);
    }
  };
  stage<D, R, NT>(ks, k + b * k_sb + (long long)h * D, k_sn, row0, m);
  stage<D, R, NT>(vs, v + b * v_sb + (long long)h * D, v_sn, row0, m);
  cp_commit();
  stage_q(0);
  cp_commit();

  const int ra = (warp % 4) * 16 + g;  // this thread's rows: ra and ra + 8
  const float* ka = ks + ra * P + t;
  const float* va = vs + ra * P + t;
  // ROLES: acc0 is dv (warps 0-3) or dk (4-7); else dv and acc1 dk
  float acc0[D / 8][4], acc1[ROLES ? 1 : D / 8][4];
  zero(acc0);
  zero(acc1);

  const int tiles = (n + C - 1) / C;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) stage_q(it + 1);
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    const float* qs = qds + (it & 1) * 2 * C * P;
    const float* dos = qs + C * P;
    const float* ls = lds + (it & 1) * 2 * C;
    const float* dls = ls + C;
    const int qn = min(C, n - it * C);

    float part0[D / 8][4];
    zero(part0);
    if constexpr (ROLES) {
      if (dk_warp)
        dkv_tile<D, C, false, true>(ka, va, qs, dos, ls, dls, qn, g, t, sl2,
                                    part0, part0);
      else
        dkv_tile<D, C, true, false>(ka, va, qs, dos, ls, dls, qn, g, t, sl2,
                                    part0, part0);
    } else {
      float part1[D / 8][4];
      zero(part1);
      dkv_tile<D, C, true, true>(ka, va, qs, dos, ls, dls, qn, g, t, sl2,
                                 part0, part1);
      add_tile(acc1, part1);
    }
    add_tile(acc0, part0);
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + ra + 8 * half;
    if (row >= m) continue;
    float* outk = dk + b * dk_sb + row * dk_sn + (long long)h * D + 2 * t;
    float* outv = dv + b * dv_sb + row * dv_sn + (long long)h * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const float2 x = make_float2(acc0[nd][2 * half], acc0[nd][2 * half + 1]);
      if (dk_warp) {
        *reinterpret_cast<float2*>(outk + 8 * nd) =
            make_float2(x.x * scale, x.y * scale);
      } else {
        *reinterpret_cast<float2*>(outv + 8 * nd) = x;
      }
      if constexpr (!ROLES)
        *reinterpret_cast<float2*>(outk + 8 * nd) = make_float2(
            acc1[nd][2 * half] * scale, acc1[nd][2 * half + 1] * scale);
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

template <int D, int C, int W, int MT, int MINB>
int launch_dq(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* dq, float* delta,
              int batch, int heads, int n, int m, const long long* st,
              cudaStream_t stream) {
  constexpr int R = 16 * MT * W;
  constexpr size_t smem = ((2 * R + 4 * C) * pitch(D) + R) * sizeof(float);
  static_assert(smem <= kMaxSmem, "dQ tiles exceed shared memory");
  const int err = prepare(flash_bwd_dq<D, C, W, MT, MINB>, smem);
  if (err) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((n + R - 1) / R, batch * heads);
  flash_bwd_dq<D, C, W, MT, MINB><<<grid, 32 * W, smem, stream>>>(
      q, k, v, o, dout, lse, dq, delta, heads, n, m, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int C, bool ROLES, int MINB>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int batch, int heads, int n, int m,
               const long long* st, cudaStream_t stream) {
  constexpr size_t smem = ((128 + 4 * C) * pitch(D) + 4 * C) * sizeof(float);
  static_assert(smem <= kMaxSmem, "dK/dV tiles exceed shared memory");
  const int err = prepare(flash_bwd_dkv<D, C, ROLES, MINB>, smem);
  if (err) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((m + 63) / 64, batch * heads);
  flash_bwd_dkv<D, C, ROLES, MINB>
      <<<grid, ROLES ? 256 : 128, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, heads, n, m, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tiles per head dim, chosen on an H100 (PERF.md, PR 4) so that ptxas
// spills nothing: (D, streamed rows C, warps W, row groups per warp MT,
// blocks per SM MINB for __launch_bounds__) for the dQ pass, (D, C, ROLES,
// MINB) for the dK/dV pass. Two row groups per warp halve the B fragments
// loaded and split per product (faster at D <= 40), but spill at D = 64
// and are slower at D = 80. The dK/dV pass holds dk, dv and one
// tile's partial sums of each (2 D values); at D = 160 that does not fit,
// so its warps take roles. Without MINB ptxas chose fewer registers and
// spilled (D = 16).
#define FLASH_BWD_DQ_TILES(X)                                                  \
  X(16, 32, 4, 2, 2) X(32, 32, 4, 2, 2) X(40, 32, 4, 2, 2)                     \
  X(64, 64, 4, 1, 2) X(80, 32, 4, 1, 2) X(160, 16, 8, 1, 1)
#define FLASH_BWD_DKV_TILES(X)                                                 \
  X(16, 32, false, 2) X(32, 32, false, 2) X(40, 32, false, 2)                  \
  X(64, 32, false, 1) X(80, 32, false, 1) X(160, 16, true, 1)

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All tensors fp32, each row with a contiguous last axis and a head stride
// of d, 16-byte aligned, other strides (in elements) multiples of 4.
// q, o, dout, dq: [batch, n, heads, d]; k, v: [batch, m, heads, d];
// lse, delta: [batch, heads, n] contiguous. delta is written.
// strides: q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, do_sb, do_sn,
// dq_sb, dq_sn.
int flash_attn_backward_dq(const float* q, const float* k, const float* v,
                           const float* o, const float* dout,
                           const float* lse, float* dq, float* delta,
                           int batch, int heads, int n, int m, int d,
                           const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ_CASE(D, C, W, MT, MINB)                                             \
  case D:                                                                      \
    return launch_dq<D, C, W, MT, MINB>(q, k, v, o, dout, lse, dq, delta,      \
                                        batch, heads, n, m, strides, s);
  switch (d) {
    FLASH_BWD_DQ_TILES(DQ_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DQ_CASE
}

// q, dout: [batch, n, heads, d]; k, v, dk, dv: [batch, m, heads, d];
// lse, delta: [batch, heads, n] contiguous (delta from the dQ pass).
// strides: q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, do_sb, do_sn, dk_sb, dk_sn,
// dv_sb, dv_sn.
int flash_attn_backward_dkv(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* delta, float* dk, float* dv,
                            int batch, int heads, int n, int m, int d,
                            const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV_CASE(D, C, ROLES, MINB)                                            \
  case D:                                                                      \
    return launch_dkv<D, C, ROLES, MINB>(q, k, v, dout, lse, delta, dk, dv,    \
                                         batch, heads, n, m, strides, s);
  switch (d) {
    FLASH_BWD_DKV_TILES(DKV_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DKV_CASE
}

}  // extern "C"
