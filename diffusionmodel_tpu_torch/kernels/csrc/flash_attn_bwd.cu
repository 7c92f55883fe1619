// Flash-attention backward for Hopper (sm_90a), fp32: two passes.
//
//   s = q k^T / sqrt(D),  p = exp(s - L),  Delta = rowsum(do * o),
//   ds = p * (do v^T - Delta),
//   dq = ds k / sqrt(D),  dk = ds^T q / sqrt(D),  dv = p^T do
//
// q, do, o [B,N,H,D], k, v [B,M,H,D], L (the forward's logsumexp) [B,H,N].
// Both passes recompute p from L tile by tile, so no [N, M] matrix ever
// reaches device memory, and each output row is owned by exactly one block:
// no atomics, and a gradient is the same from run to run.
//
// Shared design (simple first; TF32 / bf16 tensor cores are a later step):
//   - A block owns 64 rows of the output it writes, SPLIT threads per row.
//     A row's D values are split into SPLIT slices of D/SPLIT (8 to 20
//     values), so that the row's operands and its accumulators stay in
//     registers; SPLIT grows with D (1 or 2 at D = 16, 8 at D = 160).
//     Partial dot products are summed across a row's SPLIT lanes with
//     shuffles.
//   - The other operand streams through shared memory in tiles of 64 rows
//     (16-byte loads, rows past the end zero-filled). Every lane of a row
//     group reads the same streamed row at the same time: broadcasts.
//   - Streamed rows are taken 8 (dQ) or 4 (dK/dV, which holds four rows of
//     operands and accumulators) at a time: independent dot products (s
//     and dp), then p = 2^(s' - L log2 e) with q or k pre-scaled by
//     log2(e)/sqrt(D), ds = p (dp - Delta), then the FMAs into the
//     accumulators. Ragged tails are masked here (p = 0), not padded
//     outside as the JAX package does.
//   - Operands are read in place through their [B,N,H,D] strides (a to_q
//     output viewed as heads, a gradient that arrives as a view); outputs
//     are written contiguous [B,N,H,D].
//
// Bound: operations. The dQ pass does 3 products of 2*B*H*N*M*D flops
// (q k^T, do v^T, ds k), the dK/dV pass 4 (q k^T, do v^T, p^T do, ds^T q),
// against each input read once and each output written once: at the SD
// site (2, 4096, 4096, 8, 40) about 1000 flops per byte, far above the
// H100's fp32 ridge (~20 flops per byte), so the least time is the flops
// over the 67 TFLOP/s fp32 FMA rate. What the design does about it: the
// streamed tile is read from device memory once per 64 owned rows, the
// inner loops are FMA chains on registers fed by broadcast shared-memory
// reads, and exp2 replaces exp.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;   // owned rows per block
constexpr int kTile = 64;   // streamed rows per shared-memory tile
constexpr int kChunkQ = 8;  // streamed K/V rows per register batch (dQ)
constexpr int kChunkKV = 4; // streamed q rows per register batch (dK/dV)
constexpr float kLog2e = 1.4426950408889634f;
// Blocks per SM the register budget must allow: caps a thread at 128
// registers, so the compiler does not hoist every shared-memory load of an
// unrolled batch into registers (it chose 255 and spilled without a cap).
template <int SPLIT>
constexpr int kMinBlocks = 8 / SPLIT;

template <int SPLIT>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = SPLIT / 2; off > 0; off /= 2) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <int DS4>
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         float mul) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < DS4; ++i) {
    const float4 t = p[i];
    dst[4 * i] = t.x * mul;
    dst[4 * i + 1] = t.y * mul;
    dst[4 * i + 2] = t.z * mul;
    dst[4 * i + 3] = t.w * mul;
  }
}

template <int DS4>
__device__ __forceinline__ void store_row(float* dst, const float* src,
                                          float mul) {
  float4* p = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < DS4; ++i) {
    p[i] = make_float4(src[4 * i] * mul, src[4 * i + 1] * mul,
                       src[4 * i + 2] * mul, src[4 * i + 3] * mul);
  }
}

// Stage rows [r0, r0 + rn) of two [*, D] operands (row strides a_s, b_s,
// already offset to the head) into shared memory, zero-filling to kTile.
template <int D4>
__device__ __forceinline__ void stage(float4* as, float4* bs, const float* a,
                                      long long a_s, const float* b,
                                      long long b_s, int r0, int rn) {
  for (int i = threadIdx.x; i < kTile * D4; i += blockDim.x) {
    const int r = i / D4, c = i % D4;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (r < rn) {
      av = reinterpret_cast<const float4*>(a + (r0 + r) * a_s)[c];
      bv = reinterpret_cast<const float4*>(b + (r0 + r) * b_s)[c];
    }
    as[i] = av;
    bs[i] = bv;
  }
}

// dQ pass. Replaces the Pallas kernel _flash_dq_kernel
// (diffusionmodel_tpu/kernels/flash_attn.py:152, launched at :268), which
// walks the K/V tiles of one q tile along the TPU grid's sequential axis,
// carries dq in VMEM scratch and recomputes Delta on every tile. Here one
// block owns one (batch*head, 64 q rows) and loops over the K/V tiles; it
// owns its q rows whole, so it computes Delta once per row and writes it
// as [B,H,N] for the dK/dV pass. Bound: operations (3 products, above).
template <int D, int SPLIT>
__global__ void __launch_bounds__(kRows * SPLIT, kMinBlocks<SPLIT>)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ o,
             const float* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ dq, float* __restrict__ delta, int heads,
             int n, int m, long long q_sb, long long q_sn, long long k_sb,
             long long k_sn, long long v_sb, long long v_sn, long long o_sb,
             long long o_sn, long long do_sb, long long do_sn,
             long long dq_sb, long long dq_sn, float q_mul, float scale) {
  constexpr int DS = D / SPLIT, D4 = D / 4, DS4 = DS / 4;
  static_assert(D % (4 * SPLIT) == 0, "D must split into float4 slices");
  extern __shared__ float4 smem[];
  float4* ks = smem;                // [kTile][D4]
  float4* vs = smem + kTile * D4;   // [kTile][D4]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int row = blockIdx.x * kRows + threadIdx.x / SPLIT;
  const int part = threadIdx.x % SPLIT;
  const bool valid = row < n;
  const long long hd = (long long)h * D + part * DS;

  float qr[DS], dor[DS], acc[DS];
  float dsum = 0.f, l2 = 0.f;
  if (valid) {
    load_row<DS4>(qr, q + b * q_sb + row * q_sn + hd, q_mul);
    load_row<DS4>(dor, dout + b * do_sb + row * do_sn + hd, 1.f);
    load_row<DS4>(acc, o + b * o_sb + row * o_sn + hd, 1.f);
#pragma unroll
    for (int i = 0; i < DS; ++i) dsum = fmaf(dor[i], acc[i], dsum);
    l2 = lse[(long long)bh * n + row] * kLog2e;
  } else {
#pragma unroll
    for (int i = 0; i < DS; ++i) qr[i] = dor[i] = 0.f;
  }
  const float dlt = lane_sum<SPLIT>(dsum);
  if (valid && part == 0) delta[(long long)bh * n + row] = dlt;
#pragma unroll
  for (int i = 0; i < DS; ++i) acc[i] = 0.f;

  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;
  for (int k0 = 0; k0 < m; k0 += kTile) {
    const int kn = min(kTile, m - k0);
    __syncthreads();  // the previous tile is consumed
    stage<D4>(ks, vs, kb, k_sn, vb, v_sn, k0, kn);
    __syncthreads();

    for (int j0 = 0; j0 < kn; j0 += kChunkQ) {
      float s[kChunkQ], dp[kChunkQ];
#pragma unroll
      for (int jj = 0; jj < kChunkQ; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DS4; ++d4) {
#pragma unroll
        for (int jj = 0; jj < kChunkQ; ++jj) {
          const int at = (j0 + jj) * D4 + part * DS4 + d4;
          const float4 kk = ks[at], vv = vs[at];
          s[jj] = fmaf(qr[4 * d4], kk.x, s[jj]);
          s[jj] = fmaf(qr[4 * d4 + 1], kk.y, s[jj]);
          s[jj] = fmaf(qr[4 * d4 + 2], kk.z, s[jj]);
          s[jj] = fmaf(qr[4 * d4 + 3], kk.w, s[jj]);
          dp[jj] = fmaf(dor[4 * d4], vv.x, dp[jj]);
          dp[jj] = fmaf(dor[4 * d4 + 1], vv.y, dp[jj]);
          dp[jj] = fmaf(dor[4 * d4 + 2], vv.z, dp[jj]);
          dp[jj] = fmaf(dor[4 * d4 + 3], vv.w, dp[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kChunkQ; ++jj) {
        const float sj = lane_sum<SPLIT>(s[jj]);
        const float dpj = lane_sum<SPLIT>(dp[jj]);
        const float p = (valid && j0 + jj < kn) ? exp2f(sj - l2) : 0.f;
        s[jj] = p * (dpj - dlt);  // ds
      }
#pragma unroll
      for (int d4 = 0; d4 < DS4; ++d4) {
#pragma unroll
        for (int jj = 0; jj < kChunkQ; ++jj) {
          const float4 kk = ks[(j0 + jj) * D4 + part * DS4 + d4];
          acc[4 * d4] = fmaf(s[jj], kk.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(s[jj], kk.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(s[jj], kk.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(s[jj], kk.w, acc[4 * d4 + 3]);
        }
      }
    }
  }
  if (valid) store_row<DS4>(dq + b * dq_sb + row * dq_sn + hd, acc, scale);
}

// dK/dV pass. Replaces the Pallas kernel _flash_dkv_kernel
// (diffusionmodel_tpu/kernels/flash_attn.py:182, launched at :285), which
// walks the q tiles of one k tile along the TPU grid's sequential axis and
// carries dk and dv in VMEM scratch. Here one block owns one (batch*head,
// 64 k rows) and loops over the q tiles, staging q, do, L and the dQ
// pass's Delta in shared memory. Bound: operations (4 products, above).
template <int D, int SPLIT>
__global__ void __launch_bounds__(kRows * SPLIT, kMinBlocks<SPLIT>)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int heads,
              int n, int m, long long q_sb, long long q_sn, long long k_sb,
              long long k_sn, long long v_sb, long long v_sn,
              long long do_sb, long long do_sn, long long dk_sb,
              long long dk_sn, long long dv_sb, long long dv_sn, float k_mul,
              float scale) {
  constexpr int DS = D / SPLIT, D4 = D / 4, DS4 = DS / 4;
  static_assert(D % (4 * SPLIT) == 0, "D must split into float4 slices");
  extern __shared__ float4 smem[];
  float4* qs = smem;                 // [kTile][D4]
  float4* dos = smem + kTile * D4;   // [kTile][D4]
  float* ls = reinterpret_cast<float*>(smem + 2 * kTile * D4);  // [kTile]
  float* dls = ls + kTile;                                      // [kTile]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int row = blockIdx.x * kRows + threadIdx.x / SPLIT;
  const int part = threadIdx.x % SPLIT;
  const bool valid = row < m;
  const long long hd = (long long)h * D + part * DS;

  float kr[DS], vr[DS], dka[DS], dva[DS];
  if (valid) {
    load_row<DS4>(kr, k + b * k_sb + row * k_sn + hd, k_mul);
    load_row<DS4>(vr, v + b * v_sb + row * v_sn + hd, 1.f);
  } else {
#pragma unroll
    for (int i = 0; i < DS; ++i) kr[i] = vr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DS; ++i) dka[i] = dva[i] = 0.f;

  const float* qb = q + b * q_sb + (long long)h * D;
  const float* db = dout + b * do_sb + (long long)h * D;
  const float* lb = lse + (long long)bh * n;
  const float* deb = delta + (long long)bh * n;
  for (int i0 = 0; i0 < n; i0 += kTile) {
    const int qn = min(kTile, n - i0);
    __syncthreads();  // the previous tile is consumed
    stage<D4>(qs, dos, qb, q_sn, db, do_sn, i0, qn);
    for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
      ls[r] = r < qn ? lb[i0 + r] * kLog2e : 0.f;
      dls[r] = r < qn ? deb[i0 + r] : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < qn; c0 += kChunkKV) {
      float s[kChunkKV], dp[kChunkKV];
#pragma unroll
      for (int ii = 0; ii < kChunkKV; ++ii) s[ii] = dp[ii] = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DS4; ++d4) {
#pragma unroll
        for (int ii = 0; ii < kChunkKV; ++ii) {
          const int at = (c0 + ii) * D4 + part * DS4 + d4;
          const float4 qq = qs[at], dd = dos[at];
          s[ii] = fmaf(kr[4 * d4], qq.x, s[ii]);
          s[ii] = fmaf(kr[4 * d4 + 1], qq.y, s[ii]);
          s[ii] = fmaf(kr[4 * d4 + 2], qq.z, s[ii]);
          s[ii] = fmaf(kr[4 * d4 + 3], qq.w, s[ii]);
          dp[ii] = fmaf(vr[4 * d4], dd.x, dp[ii]);
          dp[ii] = fmaf(vr[4 * d4 + 1], dd.y, dp[ii]);
          dp[ii] = fmaf(vr[4 * d4 + 2], dd.z, dp[ii]);
          dp[ii] = fmaf(vr[4 * d4 + 3], dd.w, dp[ii]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < kChunkKV; ++ii) {
        const float si = lane_sum<SPLIT>(s[ii]);
        const float dpi = lane_sum<SPLIT>(dp[ii]);
        const float p = (valid && c0 + ii < qn)
                            ? exp2f(si - ls[c0 + ii]) : 0.f;
        s[ii] = p;
        dp[ii] = p * (dpi - dls[c0 + ii]);  // ds
      }
#pragma unroll
      for (int d4 = 0; d4 < DS4; ++d4) {
#pragma unroll
        for (int ii = 0; ii < kChunkKV; ++ii) {
          const int at = (c0 + ii) * D4 + part * DS4 + d4;
          const float4 qq = qs[at], dd = dos[at];
          dva[4 * d4] = fmaf(s[ii], dd.x, dva[4 * d4]);
          dva[4 * d4 + 1] = fmaf(s[ii], dd.y, dva[4 * d4 + 1]);
          dva[4 * d4 + 2] = fmaf(s[ii], dd.z, dva[4 * d4 + 2]);
          dva[4 * d4 + 3] = fmaf(s[ii], dd.w, dva[4 * d4 + 3]);
          dka[4 * d4] = fmaf(dp[ii], qq.x, dka[4 * d4]);
          dka[4 * d4 + 1] = fmaf(dp[ii], qq.y, dka[4 * d4 + 1]);
          dka[4 * d4 + 2] = fmaf(dp[ii], qq.z, dka[4 * d4 + 2]);
          dka[4 * d4 + 3] = fmaf(dp[ii], qq.w, dka[4 * d4 + 3]);
        }
      }
    }
  }
  if (valid) {
    store_row<DS4>(dk + b * dk_sb + row * dk_sn + hd, dka, scale);
    store_row<DS4>(dv + b * dv_sb + row * dv_sn + hd, dva, 1.f);
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <int D, int SPLIT>
int launch_dq(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* dq, float* delta,
              int batch, int heads, int n, int m, const long long* st,
              cudaStream_t stream) {
  const size_t smem = 2 * kTile * D * sizeof(float);
  const int err = prepare(flash_bwd_dq<D, SPLIT>, smem);
  if (err) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((n + kRows - 1) / kRows, batch * heads);
  flash_bwd_dq<D, SPLIT><<<grid, kRows * SPLIT, smem, stream>>>(
      q, k, v, o, dout, lse, dq, delta, heads, n, m, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int SPLIT>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int batch, int heads, int n, int m,
               const long long* st, cudaStream_t stream) {
  const size_t smem = (2 * kTile * D + 2 * kTile) * sizeof(float);
  const int err = prepare(flash_bwd_dkv<D, SPLIT>, smem);
  if (err) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((m + kRows - 1) / kRows, batch * heads);
  flash_bwd_dkv<D, SPLIT><<<grid, kRows * SPLIT, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, heads, n, m, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (D, SPLIT of the dQ pass, SPLIT of the dK/dV pass). A dQ thread holds
// 16-20 values of each of its rows; a dK/dV thread, which holds four row
// arrays, 8 or 20: at 16 the compiler spilled under the 128-register cap
// and the pass ran 5-10x slower (PERF.md).
#define FLASH_BWD_CASES(X)                                                     \
  X(16, 1, 2) X(32, 2, 4) X(40, 2, 2) X(64, 4, 8) X(80, 4, 4) X(160, 8, 8)

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
#define DQ_CASE(D, SPLIT, SPLIT_KV)                                            \
  case D:                                                                      \
    return launch_dq<D, SPLIT>(q, k, v, o, dout, lse, dq, delta, batch,        \
                               heads, n, m, strides, s);
  switch (d) {
    FLASH_BWD_CASES(DQ_CASE)
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
#define DKV_CASE(D, SPLIT_Q, SPLIT)                                            \
  case D:                                                                      \
    return launch_dkv<D, SPLIT>(q, k, v, dout, lse, delta, dk, dv, batch,      \
                                heads, n, m, strides, s);
  switch (d) {
    FLASH_BWD_CASES(DKV_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DKV_CASE
}

}  // extern "C"
