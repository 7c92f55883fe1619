// Flash-attention forward for Hopper (sm_90a), fp32.
//
//   o = softmax(q k^T / sqrt(D)) v        q [B,N,H,D], k, v [B,M,H,D], o [B,N,H,D]
//   lse[b,h,i] = log sum_j exp(q_i . k_j / sqrt(D))   (optional, [B,H,N])
//
// Replaces the Pallas kernel diffusionmodel_tpu/kernels/flash_attn.py:128
// (_flash_forward -> _flash_kernel). That kernel walks the K/V tiles of one
// q tile along the TPU grid's innermost (sequential) axis and carries the
// running max, sum and accumulator in VMEM scratch. Here one block owns one
// (batch*head, 64-row q tile) and walks the K/V tiles in a loop, so nothing
// is carried between blocks. The TPU tiles (512 x 2048), the lane-padded
// [BH, N, 128] logsumexp and the pad-then-slice do not carry over: q, k, v
// and o are read and written in place through their strides ([B,N,H,D] with
// a contiguous last axis, as the to_q/to_k/to_v products leave them), the
// ragged K tail and the ragged q rows are masked inside the kernel, and the
// logsumexp is written once per row as [B,H,N].
//
// Design (simple first; TF32 / bf16 tensor cores are a later step):
//   - Block = 64 q rows x SPLIT threads per row. A row's D values are split
//     into SPLIT slices of D/SPLIT, so that a thread's q slice and its fp32
//     accumulator stay in registers. SPLIT is 2 for D = 40, 80 and 160 and
//     1 otherwise: the faster choice per D on an H100 (PERF.md); D = 160
//     with 4 slices took 1.9x as long, D = 80 in one slice used 255
//     registers.
//   - Each K/V tile of 64 rows is staged in shared memory by the whole
//     block (16-byte loads; rows past M are zero-filled). Every thread of a
//     row group then reads the same k_j / v_j, so the reads are broadcasts.
//   - Scores are taken 16 keys at a time: 16 independent dot products
//     (instruction-level parallelism), a shuffle across the SPLIT threads
//     of a row, then one online-softmax update per 16 keys: m <- max,
//     rescale l and acc by 2^(m_old - m_new), p = 2^(s - m), acc += p v.
//     q is pre-scaled by log2(e)/sqrt(D) so exp is exp2.
//   - All arithmetic is fp32 FMA on the CUDA cores.
//
// Bound: operations. The function does 4*B*H*N*M*D flops (q k^T and p v)
// against reading q, k, v and writing o once; at N = M = 4096, D = 40 that
// is ~1000 flops per byte, far above the H100's fp32 ridge (~20 flops per
// byte), so the least time is the flops over the fp32 FMA rate. What this
// design does about it: no [N, M] matrix ever reaches device memory, the
// K/V tile is read from device memory once per 64 q rows, and the inner
// loops are FMA chains fed by broadcast shared-memory reads.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;    // q rows per block
constexpr int kTileK = 64;   // K/V rows per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update
constexpr float kLn2 = 0.69314718055994530942f;

template <int D, int SPLIT>
__global__ void __launch_bounds__(kRows * SPLIT)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int heads, int n, int m,
          long long q_sb, long long q_sn, long long k_sb, long long k_sn,
          long long v_sb, long long v_sn, long long o_sb, long long o_sn,
          float q_scale) {
  constexpr int DS = D / SPLIT;  // values of a row this thread owns
  constexpr int D4 = D / 4, DS4 = DS / 4;
  static_assert(D % (4 * SPLIT) == 0, "D must split into float4 slices");
  extern __shared__ float4 smem[];
  float4* ks = smem;                 // [kTileK][D4]
  float4* vs = smem + kTileK * D4;   // [kTileK][D4]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int row = blockIdx.x * kRows + threadIdx.x / SPLIT;
  const int part = threadIdx.x % SPLIT;
  const bool valid = row < n;

  float qr[DS];
  float acc[DS];
  if (valid) {
    const float4* qp = reinterpret_cast<const float4*>(
        q + b * q_sb + row * q_sn + (long long)h * D) + part * DS4;
#pragma unroll
    for (int i = 0; i < DS4; ++i) {
      const float4 t = qp[i];
      qr[4 * i] = t.x * q_scale;
      qr[4 * i + 1] = t.y * q_scale;
      qr[4 * i + 2] = t.z * q_scale;
      qr[4 * i + 3] = t.w * q_scale;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DS; ++i) qr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DS; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;  // running max, log2 units
  float l_run = 0.f;        // running sum of 2^(s - m_run)

  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;
  for (int k0 = 0; k0 < m; k0 += kTileK) {
    const int kn = min(kTileK, m - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTileK * D4; i += blockDim.x) {
      const int r = i / D4, c = i % D4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (r < kn) {
        kv = reinterpret_cast<const float4*>(kb + (k0 + r) * k_sn)[c];
        vv = reinterpret_cast<const float4*>(vb + (k0 + r) * v_sn)[c];
      }
      ks[i] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kn; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DS4; ++d4) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 kk = ks[(j0 + jj) * D4 + part * DS4 + d4];
          s[jj] = fmaf(qr[4 * d4], kk.x, s[jj]);
          s[jj] = fmaf(qr[4 * d4 + 1], kk.y, s[jj]);
          s[jj] = fmaf(qr[4 * d4 + 2], kk.z, s[jj]);
          s[jj] = fmaf(qr[4 * d4 + 3], kk.w, s[jj]);
        }
      }
      float c_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
        for (int off = SPLIT / 2; off > 0; off /= 2) {
          s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], off);
        }
        if (j0 + jj < kn) {
          c_max = fmaxf(c_max, s[jj]);
        } else {
          s[jj] = -INFINITY;  // the ragged K tail
        }
      }
      const float m_new = fmaxf(m_run, c_max);
      const float alpha = exp2f(m_run - m_new);
      l_run *= alpha;
#pragma unroll
      for (int i = 0; i < DS; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = exp2f(s[jj] - m_new);
        l_run += s[jj];
      }
#pragma unroll
      for (int d4 = 0; d4 < DS4; ++d4) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 vv = vs[(j0 + jj) * D4 + part * DS4 + d4];
          acc[4 * d4] = fmaf(s[jj], vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(s[jj], vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(s[jj], vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(s[jj], vv.w, acc[4 * d4 + 3]);
        }
      }
      m_run = m_new;
    }
  }

  if (!valid) return;
  const float inv_l = 1.f / l_run;
  float4* op = reinterpret_cast<float4*>(o + b * o_sb + row * o_sn +
                                         (long long)h * D) + part * DS4;
#pragma unroll
  for (int i = 0; i < DS4; ++i) {
    op[i] = make_float4(acc[4 * i] * inv_l, acc[4 * i + 1] * inv_l,
                        acc[4 * i + 2] * inv_l, acc[4 * i + 3] * inv_l);
  }
  if (lse != nullptr && part == 0) {
    lse[(long long)bh * n + row] = (m_run + log2f(l_run)) * kLn2;
  }
}

template <int D, int SPLIT>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int batch, int heads, int n, int m, long long q_sb,
           long long q_sn, long long k_sb, long long k_sn, long long v_sb,
           long long v_sn, long long o_sb, long long o_sn,
           cudaStream_t stream) {
  const size_t smem = 2 * kTileK * D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<D, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float q_scale = (float)(1.4426950408889634 / sqrt((double)D));
  dim3 grid((n + kRows - 1) / kRows, batch * heads);
  flash_fwd<D, SPLIT><<<grid, kRows * SPLIT, smem, stream>>>(
      q, k, v, o, lse, heads, n, m, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb,
      o_sn, q_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: [batch, n, heads, d]; k, v: [batch, m, heads, d]; o like q; all fp32
// with a contiguous last axis and a head stride of d, 16-byte aligned, other
// strides (in elements) given and multiples of 4. lse: [batch, heads, n]
// fp32 contiguous, or null.
int flash_attn_forward(const float* q, const float* k, const float* v,
                       float* o, float* lse, int batch, int heads, int n,
                       int m, int d, long long q_sb, long long q_sn,
                       long long k_sb, long long k_sn, long long v_sb,
                       long long v_sn, long long o_sb, long long o_sn,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(D, SPLIT)                                                   \
  case D:                                                                      \
    return launch<D, SPLIT>(q, k, v, o, lse, batch, heads, n, m, q_sb, q_sn,   \
                            k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, s);
  switch (d) {
    FLASH_CASE(16, 1)
    FLASH_CASE(32, 1)
    FLASH_CASE(40, 2)
    FLASH_CASE(64, 1)
    FLASH_CASE(80, 2)
    FLASH_CASE(160, 2)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // extern "C"
