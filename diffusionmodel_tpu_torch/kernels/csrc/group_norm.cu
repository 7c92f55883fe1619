// GroupNorm + activation for Hopper (sm_90a), NHWC bf16 in and out.
//
//   y   = bf16((x - mean_g) * rstd_g * w_c + b_c)      per sample, group g
//   out = act(y), act in {none, GELU (exact erf), ReLU}, in the bf16 program
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which fuses
// the statistics, the affine, the cast and the activation around it. Added for
// the card because PyTorch runs the same chain on a bf16 channels_last map as
// a cast to fp32, an NCHW copy, RowwiseMoments, a broadcast affine, a copy back
// to channels_last, a cast to bf16 and four bf16 kernels for GELU: ~58 bytes of
// device memory traffic per element. The flagship's sampling forward runs it
// at 36 sites (34 followed by GELU, 2 by ReLU).
//
// Bound: memory. The function reads x once and writes out once (4 bytes an
// element); the arithmetic (about 20 operations an element with GELU) is
// below the card's rate, though not by much: GELU's erfc is read from a
// table (below) and its bf16 products run two at a time (fma.rn.bf16x2).
// This kernel reads x twice, once for the statistics and once to normalise
// it, and keeps few parts in flight, so that the second read of a part mostly
// comes from the 50 MB L2 (a flagship sample holds at most 25 MB).
//
// One cooperative launch (cudaLaunchCooperativeKernel): every block is
// resident (the wrapper sizes the grid with the occupancy API, gn_max_blocks),
// so a block may wait for others. The work, all of it fixed by (HW, C) and
// the card (kernels/group_norm.py launch_plan computes the same numbers):
//
//   part   part_pixels consecutive pixels of one sample (the last part may
//          hold fewer); a sample has `parts` <= 132 parts, and no more than
//          the card holds resident blocks. Unit u (sample
//          u / parts, part u % parts) goes to block u % grid, so a block's
//          units belong to rising samples, one part per sample at most.
//   thread a block's active threads are lanes x cv: thread t reads vector
//          column t % cv (8 channels, 16 bytes) of pixels p0 + t / cv,
//          p0 + t / cv + lanes, ...: consecutive threads read consecutive
//          16-byte vectors, whatever C is.
//
// A block takes its units in order and, for each, first the statistics of
// the next one (steps 1-3), then the output of this one (steps 4-5). By the
// time it needs the current sample's statistics, the sample's other blocks
// have published theirs, so it seldom waits, and the card reads next parts
// while it writes current ones.
//   1. read the part (ld.global.nc) and keep, per thread and channel, the
//      count, mean and sum of squared deviations (Welford);
//   2. merge them over the lanes (a tree in shared memory, pairs fixed by the
//      lane count), then over each group's channels (one warp a group: lanes
//      in channel order, then a shuffle tree), by Chan's formulas;
//   3. publish the part's (mean, M2) of each group as two 8-byte words, each
//      holding the value and the call's epoch, so a reader that sees the
//      epoch sees the value: no counter, fence or flag, and no memset (a word
//      left by an earlier call holds another epoch);
//   4. wait until every part of the sample is published and merge them in
//      part order (one warp a group: lanes in part order, then the same
//      shuffle tree), so every block of the sample computes the same bits;
//      var = M2 / n (biased), rstd = rsqrtf(var + eps);
//   5. read the part again (ld.global.cs: the lines are not needed after) and
//      write out with st.global.cs, which keeps the writes from evicting
//      inputs still waiting for their second read.
//
// Arithmetic, as PyTorch's CUDA GroupNorm on the fp32 copy and the bf16
// program after it: a_c = rstd_g * w_c, b_c = fmaf(-a_c, mean_g, bias_c)
// (ComputeFusedParamsCUDAKernel), y = fmaf(a_c, x, b_c) rounded once to bf16;
// GELU as nn/blocks.gelu writes it for bf16 (each step exact in fp32 and
// rounded): h = bf16(y * 0.5), u = bf16(y * bf16(-sqrt(1/2))), e =
// bf16(erfcf(u)), out = bf16(h * e), where the three products are
// fma.rn.bf16x2 with -0 (exact, then rounded once) and e comes from a table
// of bf16(erfcf(u)) that each block fills with erfcf at its start; ReLU keeps
// y unless y < 0. Only the statistics are summed in another order than
// PyTorch's Welford, so y lands one bf16 ulp away where the rounding boundary
// falls between the two.
//
// Deadlock: a block waits only for the parts of its current unit's sample,
// after publishing that unit's part (and its next unit's), and every part of
// a sample lies on another block (parts <= grid, checked). The lowest sample
// with a part not yet published has every such part on a block whose waits
// are all for lower samples, all published, so it is published; all blocks
// are resident (cooperative). A wait over 10 s traps instead of holding the
// card.
//
// Determinism and batch invariance: no atomics; every sum runs in an order
// fixed by (HW, C), the group count and the card, never by B, the grid, or
// where a sample sits in the batch. A sample's output is bit-identical alone
// and in any batch, and from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxVectors = kMaxThreads;  // C / 8 <= 512: C <= 4096
constexpr int kMaxGroups = 1024;
constexpr int kMaxParts = 160;  // 5 a warp lane in the merge
constexpr int kPartsPerLane = (kMaxParts + 31) / 32;
constexpr int kUnroll = 4;
constexpr unsigned long long kWaitLimitNs = 10ull * 1000 * 1000 * 1000;
// bf16(-sqrt(1/2)): the constant nn/blocks.gelu multiplies by in bf16
constexpr float kNegSqrtHalf = -0.70703125f;
constexpr unsigned kNegSqrtHalf2 = 0xBF35BF35u;  // the same, twice as bf16
// GELU's bf16(erfcf(u)) for every bf16 u with 2**-12 <= |u| < 16 (biased
// exponents 115..130, 16 of them, 128 mantissas, two signs), as bf16 bits in
// shared memory. Below 2**-12 erfc rounds to 1 in bf16 (its distance from 1
// is under 1.13 * 2**-12, less than half an ulp on either side of 1); from
// 16 on it is 0 (u > 0: erfcf underflows) or 2 (u < 0), and for inf too; a
// NaN u comes from a NaN y, whose h is NaN already.
constexpr int kErfcExp0 = 115, kErfcExps = 16;
constexpr int kErfcTable = 2 * kErfcExps * 128;

enum { kNone = 0, kGelu = 1, kRelu = 2 };

struct Plan {
  int b, hw, c, groups, cv, lanes, part_pixels, parts;
  float eps;
  unsigned epoch;
};

struct Stat {
  float n, mean, m2;
};

// Chan et al.'s merge of two (count, mean, M2); an empty side leaves the
// other as it is.
__device__ __forceinline__ Stat merge(const Stat& a, const Stat& b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float wb = b.n / n;
  const float d = b.mean - a.mean;
  return Stat{n, fmaf(d, wb, a.mean), a.m2 + b.m2 + d * d * (a.n * wb)};
}

// Lanes in [l0, l1) of a part of q * lanes + r pixels: lane l holds q + (l < r).
__device__ __forceinline__ float lane_count(int l0, int l1, int q, int r) {
  return static_cast<float>(q * (l1 - l0) + max(0, min(l1, r) - l0));
}

// Warp lane 0 ends with the merge of all 32 lanes (pairs fixed by offset).
__device__ __forceinline__ Stat warp_merge(Stat s, int wl) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stat o;
    o.n = __shfl_down_sync(0xffffffffu, s.n, off);
    o.mean = __shfl_down_sync(0xffffffffu, s.mean, off);
    o.m2 = __shfl_down_sync(0xffffffffu, s.m2, off);
    if (wl + off < 32) s = merge(s, o);
  }
  return s;
}

__device__ __forceinline__ void widen(const uint4& v, float (&f)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  return *reinterpret_cast<const unsigned short*>(&b);
}

// bf16(erfcf(u)) as bits, for the bf16 u with bits ub, from the table.
__device__ __forceinline__ unsigned erfc_bits(unsigned ub,
                                              const unsigned short* tab) {
  const int e = static_cast<int>((ub >> 7) & 0xFF);
  const int ec = min(max(e, kErfcExp0), kErfcExp0 + kErfcExps - 1);
  const unsigned t = tab[((ub >> 15) << 11) | ((ec - kErfcExp0) << 7) | (ub & 0x7F)];
  return e < kErfcExp0 ? 0x3F80u                                 // 1.0
         : e >= kErfcExp0 + kErfcExps ? ((ub & 0x8000) ? 0x4000u : 0u)  // 2, 0
                                      : t;
}

// a * b for two pairs of bf16, each product exact in fp32 and rounded once
// to bf16 (fma with -0, as __hmul2_rn), as the bf16 program rounds it.
__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// act of two bf16 values y (bits lo | hi << 16): GELU as h = bf16(y * 0.5),
// u = bf16(y * bf16(-sqrt(1/2))), e = bf16(erfc(u)), bf16(h * e); ReLU keeps
// y unless y < 0.
template <int kAct>
__device__ __forceinline__ unsigned activate2(unsigned y2,
                                              const unsigned short* tab) {
  if (kAct == kGelu) {
    const unsigned h2 = mul_bf16x2(y2, 0x3F003F00u);  // 0.5, 0.5
    const unsigned u2 = mul_bf16x2(y2, kNegSqrtHalf2);
    const unsigned e2 = erfc_bits(u2 & 0xFFFF, tab) | (erfc_bits(u2 >> 16, tab) << 16);
    return mul_bf16x2(h2, e2);
  }
  if (kAct == kRelu) {
    const float lo = __uint_as_float(y2 << 16), hi = __uint_as_float(y2 & 0xFFFF0000u);
    return (lo < 0.f ? 0u : (y2 & 0xFFFF)) | (hi < 0.f ? 0u : (y2 & 0xFFFF0000u));
  }
  return y2;
}

__device__ __forceinline__ void publish(unsigned long long* p, float v,
                                        unsigned epoch) {
  const unsigned long long w =
      (static_cast<unsigned long long>(epoch) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long read_word(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Shared memory: the lanes' per-channel (mean, M2), the sample's per-group
// mean and rstd, and GELU's erfc table (at most 48 KB: no opt-in).
constexpr size_t smem_bytes(int lanes, int c, int groups) {
  return 4 * (2 * (size_t)lanes * c + 2 * (size_t)groups) + 2 * kErfcTable;
}

// What a block knows of the call and of itself.
struct Block {
  const uint4* x;
  const float* weight;
  const float* bias;
  uint4* out;
  unsigned long long* published;
  Plan p;
  float* s_mean;  // [lanes][c]
  float* s_m2;    // [lanes][c]
  float* g_mean;  // [groups]
  float* g_rstd;  // [groups]
  unsigned short* erfc_tab;
  int tid, lane, vcol, warp, wl, warps, cpg;
  bool active;
};

// Steps 1-3 for unit u: the part's statistics, merged and published.
__device__ __forceinline__ void part_stats(const Block& k, int u) {
  const Plan& p = k.p;
  const int s = u / p.parts, part = u % p.parts;
  const int p0 = part * p.part_pixels;
  const int p1 = min(p0 + p.part_pixels, p.hw);
  const int pk = p1 - p0;
  const size_t row0 = (size_t)s * p.hw;  // the sample's first pixel
  if (k.active) {
    float mean[8], m2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) mean[j] = m2[j] = 0.f;
    int n = 0;
    for (int q = p0 + k.lane; q < p1; q += kUnroll * p.lanes) {
      uint4 v[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int pix = q + i * p.lanes;
        if (pix < p1) v[i] = __ldg(k.x + (row0 + pix) * p.cv + k.vcol);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        if (q + i * p.lanes >= p1) break;
        ++n;
        const float inv = __frcp_rn(static_cast<float>(n));
        float f[8];
        widen(v[i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[j] - mean[j];
          mean[j] = fmaf(d, inv, mean[j]);
          m2[j] = fmaf(d, f[j] - mean[j], m2[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      k.s_mean[k.lane * p.c + k.vcol * 8 + j] = mean[j];
      k.s_m2[k.lane * p.c + k.vcol * 8 + j] = m2[j];
    }
  }

  // 2. over the lanes: a tree whose pairs depend on the lane count alone
  const int lq = pk / p.lanes, lr = pk % p.lanes;
  for (int st = 1; st < p.lanes; st *= 2) {
    __syncthreads();
    const int pairs = (p.lanes - st + 2 * st - 1) / (2 * st);
    for (int i = k.tid; i < pairs * p.c; i += blockDim.x) {
      const int l = (i / p.c) * 2 * st, c = i % p.c;
      const Stat a{lane_count(l, l + st, lq, lr), k.s_mean[l * p.c + c],
                   k.s_m2[l * p.c + c]};
      const int l2 = l + st;
      const Stat b{lane_count(l2, min(l2 + st, p.lanes), lq, lr),
                   k.s_mean[l2 * p.c + c], k.s_m2[l2 * p.c + c]};
      const Stat m = merge(a, b);
      k.s_mean[l * p.c + c] = m.mean;
      k.s_m2[l * p.c + c] = m.m2;
    }
  }
  __syncthreads();
  // ... then over each group's channels, and 3. published
  for (int g = k.warp; g < p.groups; g += k.warps) {
    Stat acc{0.f, 0.f, 0.f};
    for (int c = g * k.cpg + k.wl; c < (g + 1) * k.cpg; c += 32)
      acc = merge(acc, Stat{static_cast<float>(pk), k.s_mean[c], k.s_m2[c]});
    acc = warp_merge(acc, k.wl);
    if (k.wl == 0) {
      unsigned long long* w = k.published + ((size_t)u * p.groups + g) * 2;
      publish(w, acc.mean, p.epoch);
      publish(w + 1, acc.m2, p.epoch);
    }
  }
  __syncthreads();  // the lanes' stage is free again
}

// Steps 4-5 for unit u: the sample's statistics, then the part normalised,
// activated and stored.
template <int kAct>
__device__ __forceinline__ void part_finish(const Block& k, int u) {
  const Plan& p = k.p;
  const int s = u / p.parts, part = u % p.parts;
  const int p0 = part * p.part_pixels;
  const int p1 = min(p0 + p.part_pixels, p.hw);
  const size_t row0 = (size_t)s * p.hw;
  for (int g = k.warp; g < p.groups; g += k.warps) {
    unsigned long long wm[kPartsPerLane], wv[kPartsPerLane];
    const unsigned long long t0 = globaltimer_ns();
    for (;;) {
      bool ready = true;
#pragma unroll
      for (int i = 0; i < kPartsPerLane; ++i) {
        const int kk = k.wl + 32 * i;
        if (kk < p.parts) {
          const unsigned long long* w =
              k.published + (((size_t)s * p.parts + kk) * p.groups + g) * 2;
          wm[i] = read_word(w);
          wv[i] = read_word(w + 1);
          ready = ready && static_cast<unsigned>(wm[i] >> 32) == p.epoch &&
                  static_cast<unsigned>(wv[i] >> 32) == p.epoch;
        }
      }
      if (ready) break;
      __nanosleep(64);
      if (globaltimer_ns() - t0 > kWaitLimitNs) __trap();
    }
    __syncwarp();
    Stat acc{0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kPartsPerLane; ++i) {
      const int kk = k.wl + 32 * i;
      if (kk < p.parts) {
        const int px = min(p.part_pixels, p.hw - kk * p.part_pixels);
        acc = merge(acc, Stat{static_cast<float>(px * k.cpg),
                              __uint_as_float(static_cast<unsigned>(wm[i])),
                              __uint_as_float(static_cast<unsigned>(wv[i]))});
      }
    }
    acc = warp_merge(acc, k.wl);
    if (k.wl == 0) {
      k.g_mean[g] = acc.mean;
      k.g_rstd[g] = rsqrtf(acc.m2 / acc.n + p.eps);
    }
  }
  __syncthreads();

  // 5. normalise, activate, store
  if (k.active) {
    float a[8], sh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k.vcol * 8 + j, g = c / k.cpg;
      a[j] = k.g_rstd[g] * k.weight[c];
      sh[j] = fmaf(-a[j], k.g_mean[g], k.bias[c]);
    }
    for (int q = p0 + k.lane; q < p1; q += kUnroll * p.lanes) {
      uint4 v[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int pix = q + i * p.lanes;
        if (pix < p1) v[i] = __ldcs(k.x + (row0 + pix) * p.cv + k.vcol);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int pix = q + i * p.lanes;
        if (pix >= p1) break;
        float f[8];
        widen(v[i], f);
        unsigned y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          y[j] = activate2<kAct>(pack2(fmaf(a[2 * j], f[2 * j], sh[2 * j]),
                                       fmaf(a[2 * j + 1], f[2 * j + 1],
                                            sh[2 * j + 1])),
                                 k.erfc_tab);
        __stcs(k.out + (row0 + pix) * p.cv + k.vcol,
               make_uint4(y[0], y[1], y[2], y[3]));
      }
    }
  }
  __syncthreads();  // the sample's statistics are free again
}

template <int kAct>
__global__ void __launch_bounds__(kMaxThreads, 1)
    gn_act(const uint4* __restrict__ x, const float* __restrict__ weight,
           const float* __restrict__ bias, uint4* __restrict__ out,
           unsigned long long* published, const Plan p) {
  extern __shared__ float smem[];
  Block k;
  k.x = x; k.weight = weight; k.bias = bias; k.out = out;
  k.published = published; k.p = p;
  k.s_mean = smem;
  k.s_m2 = k.s_mean + p.lanes * p.c;
  k.g_mean = k.s_m2 + p.lanes * p.c;
  k.g_rstd = k.g_mean + p.groups;
  k.erfc_tab = reinterpret_cast<unsigned short*>(k.g_rstd + p.groups);
  k.tid = threadIdx.x;
  k.active = k.tid < p.lanes * p.cv;
  k.lane = k.tid / p.cv;
  k.vcol = k.tid % p.cv;
  k.warp = k.tid >> 5;
  k.wl = k.tid & 31;
  k.warps = blockDim.x >> 5;
  k.cpg = p.c / p.groups;
  const int units = p.b * p.parts;
  if (kAct == kGelu) {  // read only after the first unit's __syncthreads
    for (int i = k.tid; i < kErfcTable; i += blockDim.x) {
      const unsigned e = kErfcExp0 + ((i >> 7) & (kErfcExps - 1));
      const unsigned ub = ((i >> 11) << 15) | (e << 7) | (i & 0x7F);
      k.erfc_tab[i] = bf16_bits(erfcf(__uint_as_float(ub << 16)));
    }
  }
  // A block publishes its next part's statistics before it finishes the
  // current one: the other blocks of the current sample have published
  // theirs by then, so the wait is short and the card reads the next parts
  // while it writes the current ones.
  if (blockIdx.x < units) part_stats(k, blockIdx.x);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    if (u + gridDim.x < units) part_stats(k, u + gridDim.x);
    part_finish<kAct>(k, u);
  }
}

template <int kAct>
const void* kernel() {
  return reinterpret_cast<const void*>(gn_act<kAct>);
}

const void* kernel_for(int act) {
  return act == kGelu ? kernel<kGelu>() : act == kRelu ? kernel<kRelu>()
                                                       : kernel<kNone>();
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of a call, in bytes.
int gn_smem_bytes(int lanes, int c, int groups) {
  return static_cast<int>(smem_bytes(lanes, c, groups));
}

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory that
// an SM of `device` holds at once (the kernel for `act`), into *blocks.
int gn_max_blocks(int device, int act, int threads, int smem, int* blocks) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel_for(act), threads, static_cast<size_t>(smem));
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// x, out: [b, hw, c] bf16, 16-byte aligned, c % 8 == 0; weight, bias: [c]
// fp32; published: b * parts * groups * 2 8-byte words, none holding `epoch`
// (0 never is one). q: device, b, hw, c, groups, lanes, threads, part_pixels,
// parts, grid, smem, act (kernels/group_norm.py _params). One cooperative
// launch on `stream` of the given device.
int group_norm_act_bf16(const void* x, const float* weight, const float* bias,
                        void* out, unsigned long long* published, const int* q,
                        float eps, unsigned epoch, void* stream) {
  const int device = q[0];
  Plan p;
  p.b = q[1]; p.hw = q[2]; p.c = q[3]; p.groups = q[4]; p.lanes = q[5];
  const int threads = q[6];
  p.part_pixels = q[7]; p.parts = q[8];
  const int grid = q[9], smem = q[10], act = q[11];
  p.cv = p.c / 8;
  p.eps = eps;
  p.epoch = epoch;
  if (p.b < 1 || p.hw < 1 || p.c % 8 || p.cv > kMaxVectors || p.groups < 1 ||
      p.groups > kMaxGroups || p.c % p.groups || p.lanes < 1 ||
      p.lanes * p.cv > threads || threads > kMaxThreads || threads % 32 ||
      p.part_pixels < 1 || p.parts < 1 || p.parts > kMaxParts ||
      (long long)p.parts * p.part_pixels < p.hw ||
      (long long)(p.parts - 1) * p.part_pixels >= p.hw || p.parts > grid ||
      grid < 1 || epoch == 0u || act < kNone || act > kRelu ||
      (size_t)smem != smem_bytes(p.lanes, p.c, p.groups))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    const uint4* xv = static_cast<const uint4*>(x);
    uint4* ov = static_cast<uint4*>(out);
    void* args[] = {&xv, &weight, &bias, &ov, &published, &p};
    err = cudaLaunchCooperativeKernel(kernel_for(act), dim3(grid), dim3(threads),
                                      args, static_cast<size_t>(smem),
                                      static_cast<cudaStream_t>(stream));
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // extern "C"
