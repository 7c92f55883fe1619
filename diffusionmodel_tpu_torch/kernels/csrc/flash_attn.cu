// Flash-attention forward for Hopper (sm_90a) on the tensor cores, 3xTF32
// at fp32 accuracy.
//
//   o = softmax(q k^T / sqrt(D)) v        q [B,N,H,D], k, v [B,M,H,D], o [B,N,H,D]
//   lse[b,h,i] = log sum_j exp(q_i . k_j / sqrt(D))   (optional, [B,H,N])
//
// Replaces the Pallas kernel diffusionmodel_tpu/kernels/flash_attn.py:128
// (_flash_forward -> _flash_kernel, :69). That kernel walks the K/V tiles
// of one q tile along the TPU grid's innermost (sequential) axis and
// carries the running max, sum and accumulator in VMEM scratch. Here a
// block owns (batch*head, 16 MT W q rows) and walks the K/V tiles in a
// loop, so nothing is carried between blocks and each output row is
// written by one block: two runs agree bit for bit. The TPU tiles
// (512 x 2048), the lane-padded [BH, N, 128] logsumexp and the
// pad-then-slice do not carry over: q, k and v are read in place through
// their strides ([B,N,H,D] with a contiguous last axis, as the to_q/to_k/
// to_v products leave them), ragged N and M are masked inside the kernel,
// o is written contiguous and the logsumexp once per row as [B,H,N].
//
// Bound: operations. 4*B*H*N*M*D flops (q k^T and p v) against q, k, v
// read once and o written once: at the SD site (4, 4096, 4096, 8, 40)
// about 1000 flops per byte. Every product is formed at fp32 accuracy from
// three TF32 tensor-core products, so the least time is 3x the flops over
// the H100's 495 TFLOP/s dense TF32 rate: 0.521 ms at that site (1.282 ms
// at the 67 TFLOP/s fp32 CUDA-core rate, the bound of this kernel's first,
// SIMT design). What the design does about it:
//
//   - Products: mma.sync.m16n8k8 tf32 with fp32 accumulators, each fp32
//     product as lo*hi + hi*lo + hi*hi (tf32_mma.cuh; one TF32 product
//     misses the 1e-4 tolerance on peaked softmaxes). mma.sync and not
//     wgmma: TF32 wgmma has no transposed B, and p v needs v as [key, d].
//     s = q k^T takes q as the A operand and K rows as the n index;
//     o += p v takes p from the s accumulator as its A fragment (acc_to_a:
//     the k8 index renumbered, v's rows loaded in the same order), so p
//     never leaves registers.
//   - Splits: shared memory holds fp32 and each warp splits the fragments
//     it loads (load_a, load_bt, load_b), MT row groups sharing every B
//     fragment. Splitting each operand once per block into hi/lo "planes"
//     (q once, each K/V tile as it lands) was slower at every D on an
//     H100 (1.99 against 1.65 ms at the SD site, PERF.md): a plane moves
//     hi and lo, twice the shared-memory bytes per fragment, and the
//     extra pass costs two barriers a tile.
//   - Online softmax in fragments: a thread holds rows g and g+8 of its
//     16-row group; row maxima are reduced across the 4 lanes of a quad
//     with two shuffles, key columns past M are -inf before the max, p =
//     2^(s log2(e)/sqrt(D) - m) by ex2.approx.ftz, and l is summed in fp32
//     from the unsplit p (per lane, reduced across the quad at the end).
//   - Sums: each K tile's p v starts from zero in its own accumulator; the
//     running o is rescaled by 2^(m_old - m_new) and the tile added with
//     fp32 adds (add_tile): the tensor cores truncate as they accumulate.
//   - Memory: K/V tiles of C rows are staged by cp.async (16-byte copies,
//     ragged rows zero-filled through the src-size operand) while the
//     previous tile is multiplied; fp32 rows are D + 4 floats apart.
//   - Tiles per D (FLASH_FWD_TILES below): a block owns 16 MT W q rows;
//     no spill at any D. At the SD site 64 q tiles x 32 heads give 2048
//     blocks of 128 threads, two per SM.

#include "tf32_mma.cuh"

namespace {

constexpr float kLn2 = 0.69314718055994530942f;

template <int D, int C, int W, int MT, int MINB>
__global__ void __launch_bounds__(32 * W, MINB)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int heads, int n, int m,
          long long q_sb, long long q_sn, long long k_sb, long long k_sn,
          long long v_sb, long long v_sn, long long o_sb, long long o_sn,
          float sl2) {
  // MT m16 row groups per warp share every B fragment they load
  constexpr int P = pitch(D), R = 16 * MT * W, NT = 32 * W;
  static_assert(D % 8 == 0 && C % 8 == 0, "D and C in whole k8 steps");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;           // [R][P]
  float* kvs = qs + R * P;    // 2 stages of k [C][P], v [C][P]

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;

  auto stage_kv = [&](int tile) {
    float* dst = kvs + (tile & 1) * 2 * C * P;
    stage<D, C, NT>(dst, kb, k_sn, tile * C, m);
    stage<D, C, NT>(dst + C * P, vb, v_sn, tile * C, m);
  };
  stage<D, R, NT>(qs, qb, q_sn, row0, n);
  cp_commit();
  stage_kv(0);
  cp_commit();

  // this thread's rows: ra[i] and ra[i] + 8 of each row group i
  int ra[MT];
  float acc[MT][D / 8][4], m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    ra[i] = (warp * MT + i) * 16 + g;
    zero(acc[i]);
    m_run[i][0] = m_run[i][1] = -INFINITY;  // running max, log2 units
    l_run[i][0] = l_run[i][1] = 0.f;        // this lane's share of the sum
  }

  const int tiles = (m + C - 1) / C;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) stage_kv(it + 1);
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    const float* ks = kvs + (it & 1) * 2 * C * P;
    const float* vs = ks + C * P;
    const int kn = min(C, m - it * C);

    // s = q k^T over D / 8 k-steps
    float s[MT][C / 8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) zero(s[i]);
#pragma unroll
    for (int kd = 0; kd < D / 8; ++kd) {
      FragA aq[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        aq[i] = load_a<P>(qs + ra[i] * P + 8 * kd + t);
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const FragB bk = load_bt(ks + (8 * j + g) * P + 8 * kd + t);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma3(s[i][j], aq[i], bk);
      }
    }

    // online softmax: e = 0, 1 are row g, e = 2, 3 row g + 8
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (kn < C) {  // the ragged K tail
#pragma unroll
        for (int j = 0; j < C / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t + (e & 1) >= kn) s[i][j][e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[i][j][0], s[i][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[i][j][2], s[i][j][3]));
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m_run[i][hh], mx[hh] * sl2);
        alpha[hh] = exp2_approx(m_run[i][hh] - m_new);
        m_run[i][hh] = m_new;
      }
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              exp2_approx(fmaf(s[i][j][e], sl2, -m_run[i][e >> 1]));
          s[i][j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l_run[i][hh] = l_run[i][hh] * alpha[hh] + sum[hh];
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nd][e] *= alpha[e >> 1];
    }

    // o += p v, this tile's product summed from zero, then added in fp32.
    // With few keys a tile against a wide D, p's fragments are held and
    // the product walks d outermost (4 partial sums a row group); else it
    // walks the keys outermost with partial sums for all of D.
    if constexpr (C < D / 2) {
      FragA pa[MT][C / 8];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < C / 8; ++j) pa[i][j] = acc_to_a(s[i][j]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        float part[MT][4];
        zero(part);
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const FragB bv = load_b<P>(vs + (8 * j + 2 * t) * P + 8 * nd + g);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma3(part[i], pa[i][j], bv);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nd][e] += part[i][e];
      }
    } else {
      float part[MT][D / 8][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) zero(part[i]);
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        FragA pa[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) pa[i] = acc_to_a(s[i][j]);
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const FragB bv = load_b<P>(vs + (8 * j + 2 * t) * P + 8 * nd + g);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma3(part[i][nd], pa[i], bv);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) add_tile(acc[i], part[i]);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  float* out = o + b * o_sb + (long long)h * D + 2 * t;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[i][hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + ra[i] + 8 * hh;
      if (row >= n) continue;
      const float inv_l = 1.f / l;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(out + row * o_sn + 8 * nd) =
            make_float2(acc[i][nd][2 * hh] * inv_l,
                        acc[i][nd][2 * hh + 1] * inv_l);
      if (lse != nullptr && t == 0)
        lse[(long long)bh * n + row] = (m_run[i][hh] + log2f(l)) * kLn2;
    }
}

template <int D, int C, int W, int MT, int MINB>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int batch, int heads, int n, int m, long long q_sb,
           long long q_sn, long long k_sb, long long k_sn, long long v_sb,
           long long v_sn, long long o_sb, long long o_sn,
           cudaStream_t stream) {
  constexpr int R = 16 * MT * W;
  constexpr size_t smem = (R + 4 * C) * pitch(D) * sizeof(float);
  static_assert(smem <= kMaxSmem, "forward tiles exceed shared memory");
  const int err = prepare(flash_fwd<D, C, W, MT, MINB>, smem);
  if (err) return err;
  const float sl2 = (float)(1.4426950408889634 / sqrt((double)D));
  dim3 grid((n + R - 1) / R, batch * heads);
  flash_fwd<D, C, W, MT, MINB><<<grid, 32 * W, smem, stream>>>(
      q, k, v, o, lse, heads, n, m, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb,
      o_sn, sl2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tiles per head dim, chosen on an H100 by tools/flash_fwd_probe.py
// (PERF.md) among those that spill nothing: (D, K/V rows per tile C,
// warps W, 16-row groups per warp MT, blocks per SM MINB for
// __launch_bounds__). Two row groups per warp halve the B fragments each
// product loads and splits (1.35 against 1.63 ms at the SD site). At
// D = 80 registers allow them only with 16-row K/V tiles, which were
// slower; at D = 16 they were slower; at D = 160 the accumulators of two
// groups alone would take 160 registers.
#define FLASH_FWD_TILES(X)                                                     \
  X(16, 64, 4, 1, 2) X(32, 64, 4, 2, 1) X(40, 64, 4, 2, 1)                     \
  X(64, 32, 4, 2, 1) X(80, 64, 4, 1, 1) X(160, 16, 4, 1, 2)

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
#define FLASH_CASE(D, C, W, MT, MINB)                                          \
  case D:                                                                      \
    return launch<D, C, W, MT, MINB>(                                          \
        q, k, v, o, lse, batch, heads, n, m, q_sb, q_sn, k_sb, k_sn, v_sb,     \
        v_sn, o_sb, o_sn, s);
  switch (d) {
    FLASH_FWD_TILES(FLASH_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // extern "C"
