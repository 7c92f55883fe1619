// Squeeze-excitation for Hopper (sm_90a), NHWC, x in fp32 or bf16.
//
//   out = x * sigmoid(GELU(mean_HW(x) @ w1) @ w2)     x [B,H,W,C], w1 [C,R], w2 [R,C]
//
// Replaces the Pallas kernel diffusionmodel_tpu/kernels/se_block.py
// (se_block_fused -> _make_se_kernel). That kernel walks one sample's H-tiles
// in order through VMEM twice: once to sum them, once to scale them, so it
// reads x twice. A TPU core has one VMEM; a Hopper card has 132 SMs with up
// to 227 KB of shared memory each, about 30 MB on chip, and a flagship
// sample's slab is 3.1-25.2 MB in bf16 (6.3-50.3 MB in fp32). So this kernel
// keeps each sample's x on chip between pooling and scaling:
//
// Bound: memory. The function must read x once and write out once; the
// arithmetic (2 flops per element plus 4*C*R per sample) is far below the
// card's rate. Where a sample fits on chip (every flagship site in bf16, and
// in fp32 all but the two 256 px sites) this design moves exactly those
// bytes; the rest is re-read (below).
//
// One cooperative, persistent launch (cudaLaunchCooperativeKernel): a grid
// of at most one block per SM (the wrapper sizes it with the occupancy API,
// se_max_blocks), so every block is resident and a block may wait for
// others. Work, all of it fixed by (H, W, C, dtype) and R alone
// (kernels/se_block.py launch_plan computes the same numbers):
//
//   tile   sv 16-byte vectors (8 at every flagship site: 128 bytes, 64 bf16
//          or 32 fp32 channels) of tile_pixels consecutive pixels, at most
//          32 KB. A sample's tiles run slice-major: n_pr pixel tiles of
//          channel slice 0, then of slice 1, ...
//   part   tpb consecutive tiles of one sample (the last part may hold
//          fewer): as many as the ring holds (kSlots), unless a sample would
//          then need more than 132 parts; a sample has `parts` <= 132.
//          Part u of the call (sample u / parts) goes to block u % grid, so
//          a block's parts belong to rising samples, one per sample at most.
//
// Each block walks its parts in order through a ring of kSlots tile slots in
// shared memory (192 KB), loading with 16-byte cp.async.cg (one commit group
// per tile). For each part it:
//   1. pools: sums every tile in fp32 from shared memory (a thread keeps the
//      sums of one vector's channels over a fixed set of the tile's pixels),
//      and at the end of each channel slice within the part reduces them
//      (warp butterfly, then the 16 warps in order) and folds the squeeze in:
//      rv += sums(slice) @ w1[slice rows], an R-vector;
//   2. publishes rv: each value stored with the call's epoch in the same
//      8-byte word (warp 0 does it; it stores no tiles, so no write of x
//      delays it). A reader that sees the epoch sees the value, so there is
//      no counter, fence or ready flag, and no call needs a memset: a word
//      left by an earlier call holds another epoch;
//   3. asks L2 to fetch the tiles it will load next (prefetch), then waits
//      until the sample's other parts are published too, adding the
//      R-vectors in a fixed order as it reads them (every block of the
//      sample computes the same sum), divides by H*W and applies GELU: the
//      hidden vector [R];
//   4. forms the gate of each channel slice it holds from the hidden vector
//      and w2 (sigmoid; rounded to bf16 for bf16 x), scales its resident
//      tiles (warps 1-15) and stores them, and frees each slot at once: the
//      next part's tiles load into it while this part's later tiles are
//      stored, and are pooled (two loads behind) in between.
//
// A part of more than kSlots tiles (fp32 at 256 px: 12 tiles of 32 KB) keeps
// its last kSlots tiles resident; its first ns = tpb - kSlots tiles are pooled
// as they stream through the ring, dropped, and re-read after the gate, the
// newest first. While it waits for the sample, the block asks L2 to fetch
// them back (prefetch, evict_last), so the re-read mostly hits L2.
// launch_plan counts those bytes as re-read.
//
// Deadlock: a block waits only for the parts of its current part's sample,
// after publishing its own, and every part of a sample lies on another block
// (parts <= grid, checked). The lowest sample not yet complete has every
// part either published or on a block that finishes earlier samples (all
// complete) first, so it completes; all blocks are resident (cooperative).
// A wait over 10 s traps instead of holding the card.
//
// Determinism: no atomics. A tile's pixels go to fixed threads; slices,
// parts and the order in which their partial sums are added depend only on
// (H, W, C, dtype) and R, never on B, the grid, or where a sample sits in
// the batch; so a sample's output is bit-identical alone and in any batch,
// and from run to run. GELU is the exact erf form, as in the JAX module and
// its XLA twin (the Pallas kernel used the tanh form).
//
// Weights are read in nn.Linear's layout: w1t [R, C] (fc[0].weight = w1^T)
// and w2t [C, R] (fc[2].weight = w2^T), so the squeeze's fold and the gate
// are dot products along contiguous rows and the model path copies nothing.
// Types: x and out are float or __nv_bfloat16; everything else is fp32. In
// bf16 the kernel computes what the Pallas kernel computes on bf16 x: fp32
// pooling and MLP, the gate rounded to bf16 (__float2bfloat16_rn), and
// out = bf16(float(x) * float(gate)), exact in fp32 before its one rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 32 * 1024;
constexpr int kTileVectors = kTileBytes / 16;
constexpr int kSlots = 6;
constexpr int kPoolLag = 2;  // pool a tile once two newer loads are issued
constexpr int kMaxSliceChannels = 64;  // 8 vectors of 8 bf16 channels
constexpr int kMaxR = 1024;
constexpr int kScratchFloats = 1024;  // >= max(kThreads, kMaxR)
constexpr int kMaxDevices = 64;

// A 16-byte vector of x: 4 fp32 or 8 bf16 channels, widened to fp32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  static constexpr bool round_gate = false;
  static __device__ __forceinline__ void widen(const float4& v, float (&f)[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ float4 narrow(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
  static constexpr bool round_gate = true;
  static __device__ __forceinline__ void widen(const uint4& v, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float (&f)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

// The launch plan (kernels/se_block.py launch_plan) and the call's epoch.
struct Plan {
  int b, hw, c, r;
  int sv, log_sv;   // 16-byte vectors per tile row (1, 2, 4 or 8) and log2
  int tile_pixels;  // pixels per tile (the last of a slice may hold fewer)
  int n_pr;         // pixel tiles per channel slice
  int tiles;        // tiles per sample, slice-major
  int tpb;          // tiles per part
  int parts;        // parts per sample
  unsigned epoch;   // tags this call's published words (never 0)
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n (0 <= n < kSlots) committed groups are in flight.
__device__ __forceinline__ void cp_wait_n(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    default: cp_wait<5>(); break;
  }
}

// A published value: the call's epoch in the high word, the fp32 bits in
// the low one. An aligned 8-byte store is seen whole or not at all, so a
// reader that sees this call's epoch sees the value: no fence, no flag.
__device__ __forceinline__ void st_tagged(unsigned long long* p, float v, unsigned epoch) {
  const unsigned long long w = ((unsigned long long)epoch << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long ld_tagged(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait this long is a fault (a part never published): trap, so that the
// call fails instead of holding the card.
constexpr unsigned long long kWaitLimitNs = 10000000000ull;

// Where a tile lies: its channel slice, first pixel and pixel count.
struct Tile {
  int s, p0, npx;
};

__device__ __forceinline__ Tile tile_at(const Plan& p, int t) {
  Tile g;
  g.s = t / p.n_pr;
  g.p0 = (t - g.s * p.n_pr) * p.tile_pixels;
  g.npx = min(p.tile_pixels, p.hw - g.p0);
  return g;
}

// Part lp of this block: its sample, index within the sample, first tile and
// tile count. False past the call's last part.
__device__ __forceinline__ bool part_of(const Plan& p, int lp, int& b, int& k,
                                        int& t0, int& nt) {
  const long long u = blockIdx.x + (long long)lp * gridDim.x;
  if (u >= (long long)p.b * p.parts) return false;
  b = static_cast<int>(u / p.parts);
  k = static_cast<int>(u - (long long)b * p.parts);
  t0 = k * p.tpb;
  nt = min(p.tpb, p.tiles - t0);
  return true;
}

// published [b, parts, r]: the parts' R-vectors, tagged with the epoch
// (no word of it may hold this call's epoch on entry).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
se_fused(const typename Vec<T>::type* __restrict__ x, const float* __restrict__ w1t,
         const float* __restrict__ w2t, typename Vec<T>::type* __restrict__ out,
         unsigned long long* __restrict__ published, const Plan p) {
  using V = typename Vec<T>::type;
  constexpr int N = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  V* ring = reinterpret_cast<V*>(smem);
  float* red = reinterpret_cast<float*>(smem + kSlots * kTileBytes);  // [kWarps][64]
  float* csum = red + kWarps * kMaxSliceChannels;  // a slice's channel sums
  float* gate = csum + kMaxSliceChannels;          // a slice's gate
  float* fp = gate + kMaxSliceChannels;            // partial dot products
  float* rv = fp + kScratchFloats;                 // the part's R-vector
  float* hid = rv + ((p.r + 3) & ~3);              // the sample's hidden vector

  const int tid = threadIdx.x;
  const int cv = p.c / N;  // vectors per pixel
  const int cs = p.sv * N;  // channels per slice
  const int v = tid & (p.sv - 1);  // this thread's vector in every tile row
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int j = tid; j < p.r; j += kThreads) rv[j] = 0.f;

  int ld_lp = 0, ld_j = 0, loaded = 0, released = 0;  // the ring's loads
  int pl_lp = 0, pl_j = 0, pooled = 0;                // and its pooling

  // Fill every free slot, in sequence order (slot = sequence index % kSlots).
  auto issue_loads = [&]() {
    int b, k, t0, nt;
    while (loaded < released + kSlots && part_of(p, ld_lp, b, k, t0, nt)) {
      const Tile g = tile_at(p, t0 + ld_j);
      V* dst = ring + (size_t)(loaded % kSlots) * kTileVectors;
      const V* src = x + ((size_t)b * p.hw + g.p0) * cv + (size_t)g.s * p.sv;
      const int n = g.npx << p.log_sv;
      for (int i = tid; i < n; i += kThreads)
        cp_async16(dst + i, src + (size_t)(i >> p.log_sv) * cv + (i & (p.sv - 1)));
      cp_commit();
      ++loaded;
      if (++ld_j == nt) { ++ld_lp; ld_j = 0; }
    }
  };

  // Channel sums of slice s (the sums in acc, reset here) folded into rv.
  auto fold = [&](int s) {
    for (int off = p.sv; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    const int lane = tid & 31, warp = tid >> 5;
    if (lane < p.sv)
#pragma unroll
      for (int i = 0; i < N; ++i) red[warp * kMaxSliceChannels + lane * N + i] = acc[i];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    __syncthreads();
    if (tid < cs) {
      float sum = red[tid];
      for (int w = 1; w < kWarps; ++w) sum += red[w * kMaxSliceChannels + tid];
      csum[tid] = sum;
    }
    __syncthreads();
    const int ng = p.r <= kThreads ? kThreads / p.r : 1;
    const int chunk = (cs + ng - 1) / ng;
    const float* w1s = w1t + (size_t)s * cs;
    for (int idx = tid; idx < ng * p.r; idx += kThreads) {
      const int j = idx % p.r, lo = (idx / p.r) * chunk, hi = min(cs, lo + chunk);
      const float* wr = w1s + (size_t)j * p.c;
      float sum = 0.f;
      for (int c = lo; c < hi; ++c) sum += csum[c] * __ldg(wr + c);
      fp[idx] = sum;
    }
    __syncthreads();
    for (int j = tid; j < p.r; j += kThreads) {
      float sum = rv[j];
      for (int g = 0; g < ng; ++g) sum += fp[g * p.r + j];
      rv[j] = sum;
    }
    __syncthreads();
  };

  // Publish part k of sample b: its R-vector, tagged (warp 0, which stores
  // no tiles, so nothing waits on it).
  auto publish = [&](int b, int k) {
    if (tid < 32) {
      unsigned long long* dst = published + ((size_t)b * p.parts + k) * p.r;
      for (int j = tid; j < p.r; j += 32) {
        st_tagged(dst + j, rv[j], p.epoch);
        rv[j] = 0.f;
      }
    }
    __syncthreads();
  };

  // Wait until every part of sample b is published, adding their R-vectors
  // in a fixed order as they are read; hid = GELU(sum / (H*W)).
  auto gather = [&](int b) {
    constexpr int kG = sizeof(T) == 4 ? 8 : 4;  // bf16 has fewer registers to spare
    const int ng = p.r <= kThreads ? kThreads / p.r : 1;
    const int chunk = (p.parts + ng - 1) / ng;
    const unsigned long long* src = published + (size_t)b * p.parts * p.r;
    const unsigned long long t_wait = globaltimer_ns();
    for (int idx0 = 0; idx0 < ng * p.r; idx0 += kThreads) {
      const int idx = idx0 + tid;
      const int j = idx % p.r, lo = (idx / p.r) * chunk;
      const int hi = idx < ng * p.r ? min(p.parts, lo + chunk) : lo;
      float sum;
      bool ready;
      do {  // kG loads in flight, then their sums in order
        ready = true;
        sum = 0.f;
        for (int q0 = lo; q0 < hi; q0 += kG) {
          unsigned long long w[kG];
#pragma unroll
          for (int q = 0; q < kG; ++q)
            if (q0 + q < hi) w[q] = ld_tagged(src + (size_t)(q0 + q) * p.r + j);
#pragma unroll
          for (int q = 0; q < kG; ++q)
            if (q0 + q < hi) {
              ready &= static_cast<unsigned>(w[q] >> 32) == p.epoch;
              sum += __uint_as_float(static_cast<unsigned>(w[q]));
            }
        }
        if (tid == 0 && globaltimer_ns() - t_wait > kWaitLimitNs) __trap();
      } while (!__syncthreads_and(ready));
      if (idx < ng * p.r) fp[idx] = sum;
    }
    __syncthreads();
    for (int j = tid; j < p.r; j += kThreads) {
      float sum = fp[j];
      for (int g = 1; g < ng; ++g) sum += fp[g * p.r + j];
      hid[j] = gelu_erf(sum / (float)p.hw);
    }
  };

  // Pool the next tile of the sequence (its load waited for).
  auto pool_next = [&]() {
    int b, k, t0, nt;
    part_of(p, pl_lp, b, k, t0, nt);
    const int t = t0 + pl_j;
    const Tile g = tile_at(p, t);
    cp_wait_n(loaded - pooled - 1);
    __syncthreads();
    const V* src = ring + (size_t)(pooled % kSlots) * kTileVectors;
    const int n = g.npx << p.log_sv;
    for (int i = tid; i < n; i += kThreads) {
      float f[N];
      Vec<T>::widen(src[i], f);
#pragma unroll
      for (int q = 0; q < N; ++q) acc[q] += f[q];
    }
    const bool part_end = pl_j + 1 == nt;
    if (part_end || (t + 1) / p.n_pr != g.s) fold(g.s);
    if (part_end) publish(b, k);
    ++pooled;
    if (++pl_j == nt) { ++pl_lp; pl_j = 0; }
  };

  // The gate of slice s from hid; this thread's N channels into gv.
  auto slice_gate = [&](int s, float (&gv)[N]) {
    __syncthreads();
    const int ng = kThreads / cs;  // cs divides kThreads
    const int chunk = (p.r + ng - 1) / ng;
    {
      const int c = tid % cs, lo = (tid / cs) * chunk, hi = min(p.r, lo + chunk);
      const float* wr = w2t + ((size_t)s * cs + c) * p.r;
      float sum = 0.f;
      for (int j = lo; j < hi; ++j) sum += hid[j] * __ldg(wr + j);
      fp[tid] = sum;
    }
    __syncthreads();
    if (tid < cs) {
      float sum = fp[tid];
      for (int g = 1; g < ng; ++g) sum += fp[g * cs + tid];
      float y = sigmoid(sum);
      if (Vec<T>::round_gate) y = __bfloat162float(__float2bfloat16_rn(y));
      gate[tid] = y;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) gv[i] = gate[v * N + i];
  };

  // Pool every tile loaded at least kPoolLag loads ago: its copy has most
  // likely landed, so the wait costs nothing.
  auto pool_lagged = [&]() {
    while (pooled < loaded - kPoolLag) pool_next();
  };

  issue_loads();
  int seq = 0;  // sequence index of the current part's first tile
  int b, k, t0, nt;
  for (int lp = 0; part_of(p, lp, b, k, t0, nt); ++lp) {
    const int ns = max(0, nt - kSlots);  // tiles streamed, then re-read
    for (int j = 0; j < nt; ++j) {
      if (pooled == seq + j) pool_next();
      if (j < ns) {  // a streamed tile leaves the ring once pooled
        __syncthreads();
        ++released;
        issue_loads();
      }
    }
    pool_lagged();  // later parts' tiles already loaded

    // While it waits, L2 fetches what this block reads next: the tiles it
    // re-reads (kept with evict_last), or else the first half of the next
    // ring's tiles, which load once this part's stores free their slots
    // (half: more competes with the other blocks' loads at the small sites).
    for (int j = 0; j < ns; ++j) {
      const Tile g = tile_at(p, t0 + j);
      const V* src = x + ((size_t)b * p.hw + g.p0) * cv + (size_t)g.s * p.sv;
      for (int i = tid; i < g.npx; i += kThreads)
        asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(src + (size_t)i * cv));
    }
    for (int n = 0, pl = ld_lp, pj = ld_j; ns == 0 && n < kSlots / 2; ++n) {
      int pb, pk, pt0, pnt;
      if (!part_of(p, pl, pb, pk, pt0, pnt)) break;
      const Tile g = tile_at(p, pt0 + pj);
      const V* src = x + ((size_t)pb * p.hw + g.p0) * cv + (size_t)g.s * p.sv;
      for (int i = tid; i < g.npx; i += kThreads)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(src + (size_t)i * cv));
      if (++pj == pnt) { ++pl; pj = 0; }
    }
    gather(b);

    int cur = -1;
    float gv[N];
    for (int j = ns; j < nt; ++j) {  // resident tiles: scale in place, store
      const Tile g = tile_at(p, t0 + j);
      if (g.s != cur) { slice_gate(g.s, gv); cur = g.s; }
      const V* src = ring + (size_t)((seq + j) % kSlots) * kTileVectors;
      V* dst = out + ((size_t)b * p.hw + g.p0) * cv + (size_t)g.s * p.sv;
      const int n = g.npx << p.log_sv;
      // warps 1.. scale and store; warp 0 only publishes (see publish)
      constexpr int kStorers = kThreads - 32;
      constexpr int kPer = (kTileVectors + kStorers - 1) / kStorers;
      V vals[kPer];
      const int st = tid - 32;
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        if (st >= 0 && st + q * kStorers < n) vals[q] = src[st + q * kStorers];
      __syncthreads();
      ++released;
      issue_loads();
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int i = st + q * kStorers;
        if (st >= 0 && i < n) {
          float f[N];
          Vec<T>::widen(vals[q], f);
#pragma unroll
          for (int e = 0; e < N; ++e) f[e] *= gv[e];
          dst[(size_t)(i >> p.log_sv) * cv + v] = Vec<T>::narrow(f);
        }
      }
      pool_lagged();
    }
    for (int j = ns - 1; j >= 0; --j) {  // streamed tiles: re-read, newest first
      const Tile g = tile_at(p, t0 + j);
      if (g.s != cur) { slice_gate(g.s, gv); cur = g.s; }
      const size_t base = ((size_t)b * p.hw + g.p0) * cv + (size_t)g.s * p.sv;
      const int n = g.npx << p.log_sv;
      if (tid >= 32) {  // kB loads in flight, then their stores
        constexpr int kB = sizeof(T) == 4 ? 5 : 1;
        for (int i0 = tid - 32; i0 < n; i0 += kB * (kThreads - 32)) {
          V vals[kB];
#pragma unroll
          for (int q = 0; q < kB; ++q) {
            const int i = i0 + q * (kThreads - 32);
            if (i < n) vals[q] = __ldg(x + base + (size_t)(i >> p.log_sv) * cv + v);
          }
#pragma unroll
          for (int q = 0; q < kB; ++q) {
            const int i = i0 + q * (kThreads - 32);
            if (i < n) {
              float f[N];
              Vec<T>::widen(vals[q], f);
#pragma unroll
              for (int e = 0; e < N; ++e) f[e] *= gv[e];
              out[base + (size_t)(i >> p.log_sv) * cv + v] = Vec<T>::narrow(f);
            }
          }
        }
      }
    }
    seq += nt;
  }
}

constexpr size_t smem_bytes(int r) {
  return (size_t)kSlots * kTileBytes +
         4 * ((size_t)kWarps * kMaxSliceChannels + 2 * kMaxSliceChannels +
              kScratchFloats + 2 * (size_t)((r + 3) & ~3));
}

// Blocks above 48 KB of dynamic shared memory must ask for it; each kernel
// asks once per device, for the most it may take.
template <typename T>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices || done[dev]) return err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(se_fused<T>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kMaxR)));
  done[dev] = err == cudaSuccess;
  return err;
}

template <typename T>
int max_blocks(int device, int smem, int* blocks) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = allow_smem<T>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, se_fused<T>, kThreads, static_cast<size_t>(smem));
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// q: device, b, hw, c, r, sv, tile_pixels, n_pr, tiles, tpb, parts, grid,
// smem (kernels/se_block.py _params).
template <typename T>
int forward(const T* x, const float* w1t, const float* w2t, T* out,
            unsigned long long* published, const int* q, unsigned epoch,
            void* stream) {
  using V = typename Vec<T>::type;
  const int device = q[0];
  Plan p;
  p.b = q[1]; p.hw = q[2]; p.c = q[3]; p.r = q[4]; p.sv = q[5];
  p.tile_pixels = q[6]; p.n_pr = q[7]; p.tiles = q[8]; p.tpb = q[9];
  p.parts = q[10];
  p.epoch = epoch;
  const int grid = q[11], smem = q[12];
  p.log_sv = p.sv == 8 ? 3 : p.sv == 4 ? 2 : p.sv == 2 ? 1 : 0;
  const int cv = p.c / Vec<T>::n;
  if ((p.sv != 1 << p.log_sv) || p.c % Vec<T>::n || cv % p.sv ||
      p.tile_pixels * p.sv > kTileVectors || p.r < 1 || p.r > kMaxR ||
      (long long)p.n_pr * p.tile_pixels < p.hw ||
      p.tiles != cv / p.sv * p.n_pr || (long long)p.parts * p.tpb < p.tiles ||
      p.parts > grid || grid < 1 || epoch == 0u ||
      (size_t)smem != smem_bytes(p.r))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = allow_smem<T>();
  if (err == cudaSuccess) {
    const V* xv = reinterpret_cast<const V*>(x);
    V* ov = reinterpret_cast<V*>(out);
    void* args[] = {&xv, &w1t, &w2t, &ov, &published, &p};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(se_fused<T>),
                                      dim3(grid), dim3(kThreads), args,
                                      static_cast<size_t>(smem),
                                      static_cast<cudaStream_t>(stream));
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a call with this R takes, in bytes.
int se_smem_bytes(int r) { return static_cast<int>(smem_bytes(r)); }

// Blocks of the fp32 (bf16 = 0) or bf16 kernel an SM of `device` holds at
// once with `smem` bytes of dynamic shared memory, into *blocks.
int se_max_blocks(int device, int bf16, int smem, int* blocks) {
  return bf16 ? max_blocks<__nv_bfloat16>(device, smem, blocks)
              : max_blocks<float>(device, smem, blocks);
}

// x, out: [b, hw, c], fp32 (se_block_forward) or bf16 (se_block_forward_bf16),
// 16-byte aligned, c % 4 == 0 (fp32) or c % 8 == 0 (bf16); w1t: [r, c]; w2t:
// [c, r] (nn.Linear's weights); published: b * parts * r 8-byte words, none
// holding `epoch` (0 never is one; a word keeps the epoch of the call that
// wrote it). q: the launch plan (kernels/se_block.py _params). One
// cooperative launch on `stream` of the given device.
int se_block_forward(const float* x, const float* w1t, const float* w2t,
                     float* out, unsigned long long* published, const int* q,
                     unsigned epoch, void* stream) {
  return forward<float>(x, w1t, w2t, out, published, q, epoch, stream);
}

int se_block_forward_bf16(const __nv_bfloat16* x, const float* w1t,
                          const float* w2t, __nv_bfloat16* out,
                          unsigned long long* published, const int* q,
                          unsigned epoch, void* stream) {
  return forward<__nv_bfloat16>(x, w1t, w2t, out, published, q, epoch, stream);
}

}  // extern "C"
