// Coordinate attention for Hopper (sm_90a), NHWC, square maps (L = H = W),
// x and out in fp32 or bf16.
//
// Replaces the Pallas kernel diffusionmodel_tpu/kernels/coord_attn.py
// (coord_attn_fused -> _make_kernel, weights packed as CoordAttnWeights).
// Per sample it computes
//
//   xh = mean_W x [L,C]      xw = mean_H x [L,C]
//   yh = norm(xh @ W1h + b)  yw = norm(xw @ W1w + b)      norm: GroupNorm (stats
//        then exact-erf GELU                              over L x R/G) or affine
//   zh = yh + s0 * (yw @ Ww2h + b)                        (cross mix; the
//   zw = yw + s1 * (yh @ Wh2w + b)                         realign is the
//                                                          identity on square maps)
//   out[h,w,c] = x[h,w,c] * (s2 * sigmoid(zh @ Wh + bh)[h,c]
//                          + s3 * sigmoid(zw @ Ww + bw)[w,c])
//
// Bound: memory. The function must read x once and write out once. The
// Pallas kernel holds a sample's [L,L,C] block in VMEM; a flagship sample is
// 1.5-12.6 MB, and an SM holds 227 KB of shared memory, so no block sees a
// whole sample: the gates need the pooled means of all of x before any
// output can be written. So x is read twice, once to pool and once to
// apply, and this design's floor is 3 x-sized transfers against the bound's
// 2 (67% of the bound). Three launches:
//
//   ca_pool        first read of x. Block (32-channel chunk, tile of 16
//                  rows, sample); a warp reads 4 columns x 128 contiguous
//                  bytes of a row, each lane keeps its columns' sums in
//                  registers across the tile's rows, and each row's sum is
//                  reduced with warp shuffles, then across warps once per
//                  tile through shared memory. Writes the complete row
//                  means rmean[B,L,C] and the tile's column sums
//                  cp[B,T,L,C], T = ceil(L/16).
//   ca_bottleneck  y = pooled @ W1 + b for both directions as one batched
//                  product: block (32 outputs of R, a k-slice of at most 6
//                  chunks of 64 channels, 16 rows of a sample, direction x
//                  sample). A chunk of the column means is the T tiles'
//                  sums, staged side by side and added in tile order, over
//                  L. Chunks are staged by cp.async into a ring of 2-7
//                  buffers (as deep as the slice where shared memory
//                  allows), so a block reads each weight element of its
//                  slice once and the next chunks' copies overlap the
//                  current products. The last slice of an output tile adds
//                  the slices' partial products in order. The last block of
//                  a (sample, direction) then takes its GroupNorm
//                  statistics (or the folded affine) and GELU -> yn, and
//                  its cross term yx = yn @ Wx + bx (the h2w projection for
//                  h, w2h for w).
//   ca_apply       second read of x, one write of out. Block (32-channel
//                  chunk, tile of 16 rows, sample), in the reverse of
//                  ca_pool's order (the part of x read last may still be in
//                  L2): forms z = yn + s * yx (the other direction's cross
//                  term: zh = yn_h + s0 yx_w, zw = yn_w + s1 yx_h) for its
//                  rows and all L columns, the gates s2*sigmoid(zh@Wh+bh)
//                  and s3*sigmoid(zw@Ww+bw) of its chunk into shared memory
//                  (the output projection, fused: gates never reach device
//                  memory), then streams x 16 bytes a load, 8 loads in flight.
//
// Each kernel lets the next one start early (programmatic dependent
// launch): ca_bottleneck warms L2 with the cross-mix weights, ca_apply
// stages its Wout chunk and issues its first x loads, and each waits for
// the kernel before it to finish before it reads that kernel's output.
//
// Bytes per pass at the flagship sites (batch 16; MB = 1e6 bytes). x is
// 201.3 / 100.7 / 50.3 / 25.2 MB at L,C = 128,192 / 64,384 / 32,768 /
// 16,1536; rmean is 1.57 MB at every site (1/L of x), cp T/L of x: 12.6 /
// 6.3 / 3.1 / 1.6 MB; y, yn and yx 0.2 MB each; the weights 0.02-2.4 MB.
//
//   ca_pool        reads x, writes rmean + cp (7.0 / 7.8 / 9.4 / 12.5 % of x)
//   ca_bottleneck  reads rmean, cp and W1 (from L2; W1 once per sample and
//                  direction), writes y, the k-slices' partials, yn, yx
//   ca_apply       reads x, yn, yx and Wout (from L2), writes out
//
// Types: x and out are float or __nv_bfloat16 (ca_pool and ca_apply, the
// two passes that touch them, are templated on it); everything else (the
// means, y, yn, yx, the gates, the weights) is fp32. In bf16 the kernel
// computes what the Pallas kernel computes on bf16 x: x widened to fp32,
// fp32 throughout, and out = bf16(float(x) * attn) with attn not rounded.
// A lane reads x 16 bytes at a time: 4 fp32 or 8 bf16 channels, so a
// ca_pool chunk is 32 fp32 or 64 bf16 channels (8 vectors) and a ca_apply
// block's 32 channels are 8 or 4 vectors; the wrapper requires C % 4 or
// C % 8 and 16-byte alignment. bf16 halves the x bytes and so the bound.
//
// Determinism: no sum uses atomics, and every sum runs in a fixed order
// (lane-strided loops, xor-butterfly shuffles, tiles, k-groups, k-slices
// and warps added in index order), with tiles that depend on L, C and R but
// not on B: reruns are bit-identical and a sample's output does not depend
// on its batch. Counters only signal which block finishes last (of an
// output tile's k-slices, of a (sample, direction)'s tiles), the
// threadfence-reduction pattern: a block writes its share, fences, and
// bumps the counter; the one that completes it reads the others' shares.
// They add no data. The wrapper keeps one counter buffer per device and
// stream, zeroed once when it is made; each last block sets its counter
// back to zero, so the kernel leaves the buffer as it found it and a call
// needs no memset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"  // cp.async staging (cp_async4, cp_async16, cp_commit)

namespace {

constexpr int kChunkV = 8;       // 16-byte vectors per ca_pool channel chunk
constexpr int kColsPerWarp = 4;  // ca_pool: a warp reads 4 columns x 8 vectors
constexpr int kPoolRows = 16;    // ca_pool: rows per tile, at most
constexpr int kPoolWarps = 8;    // ca_pool: warps per block, at most
constexpr int kBnRows = 16;      // ca_bottleneck: rows (of one sample) per block
constexpr int kBnCols = 32;      // ca_bottleneck: outputs (of R) per block
constexpr int kBnChunk = 64;     // ca_bottleneck: channels per staged chunk
constexpr int kBnGroups = 4;     // ca_bottleneck: k-groups, 16 channels of a chunk each
constexpr int kBnPitch = kBnChunk + 4;  // padded row of the staged means
constexpr int kBnMaxStages = 7;  // ca_bottleneck: ring depth, at most
constexpr int kApplyUnroll = 8;  // ca_apply: 16-byte loads of x in flight per thread
constexpr int kApplyCh = 32;     // ca_apply: channels per block (a multiple of 32)
constexpr int kThreads = 256;    // ca_bottleneck and ca_apply

// A 16-byte vector of x: 4 fp32 or 8 bf16 channels, widened to fp32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
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

// n fp32 values to 16-byte aligned memory, as float4 stores.
template <int N>
__device__ __forceinline__ void store_floats(float* dst, const float (&f)[N]) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    reinterpret_cast<float4*>(dst)[k] =
        make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Programmatic dependent launch (sm_90): a kernel launched with
// programmatic stream serialization may start while the kernel before it
// runs, once every block of that kernel has allowed it (or exited); it
// must wait for the earlier kernel to finish, and its writes to be
// visible, before it reads them.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Wait until at most N committed cp.async groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same for a depth known at run time (0 <= n < kBnMaxStages).
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

// The threadfence-reduction signal: after every thread of the block has
// written its share, one thread bumps *count; the block that brings it to
// n is the last and resets it to zero. Adds no data; returns (to every
// thread) whether this block is the last.
__device__ __forceinline__ bool last_block(unsigned int* count, unsigned int n,
                                           int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(count, 1u) == n - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  if (threadIdx.x == 0) *count = 0;  // leave the buffer zeroed for the next call
  return true;
}

// grid (ceil(cv / kChunkV), ceil(l / rows), b), block 32 * warps with
// warps * kColsPerWarp * KC >= l; cv = c / Vec<T>::n vectors per pixel.
// Lane = (column, vector) = (lane / 8, lane % 8); warp w owns columns
// w*4 + lane/8 + k*4*warps, k < KC. Writes the tile's row means to rmean
// [b, l, c] and its column sums to cp [b, T, l, c] (fp32).
template <typename T, int KC>
__global__ void __launch_bounds__(kPoolWarps * 32)
ca_pool(const typename Vec<T>::type* __restrict__ x, float* __restrict__ rmean,
        float* __restrict__ cp, int l, int cv_n, int rows) {
  using V = typename Vec<T>::type;
  constexpr int N = Vec<T>::n;
  constexpr int G = KC >= 8 ? 1 : 8 / KC;  // rows loaded together
  __shared__ float red[kPoolRows][kPoolWarps][kChunkV][N];
  allow_dependents();  // ca_bottleneck may take free SMs for its prologue
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int cv = blockIdx.x * kChunkV + (lane & 7);
  const int tile = blockIdx.y, b = blockIdx.z;
  const int h0 = tile * rows, h1 = min(h0 + rows, l);
  const bool active = cv < cv_n;
  const int col0 = warp * kColsPerWarp + (lane >> 3);
  const int step = nw * kColsPerWarp;
  const int c = cv_n * N;
  const V zero{};
  const V* xs = x + (size_t)b * l * l * cv_n + cv;
  float col[KC][N];
#pragma unroll
  for (int k = 0; k < KC; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) col[k][i] = 0.f;
  for (int h = h0; h < h1; h += G) {
    V v[G][KC];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int w = col0 + k * step;
        v[g][k] = (active && h + g < h1 && w < l)
                      ? __ldg(xs + ((size_t)(h + g) * l + w) * cv_n)
                      : zero;
      }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (h + g >= h1) break;  // uniform over the block
      float row[N];
#pragma unroll
      for (int i = 0; i < N; ++i) row[i] = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        float f[N];
        Vec<T>::widen(v[g][k], f);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          col[k][i] += f[i];
          row[i] += f[i];
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {  // the warp's 4 columns
        row[i] += __shfl_xor_sync(0xffffffffu, row[i], 8);
        row[i] += __shfl_xor_sync(0xffffffffu, row[i], 16);
      }
      if (lane < kChunkV)
#pragma unroll
        for (int i = 0; i < N; ++i) red[h + g - h0][warp][lane][i] = row[i];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < (h1 - h0) * kChunkV; t += blockDim.x) {
    const int i = t / kChunkV, vi = t % kChunkV;
    const int cvv = blockIdx.x * kChunkV + vi;
    if (cvv >= cv_n) continue;
    float s[N];
#pragma unroll
    for (int e = 0; e < N; ++e) s[e] = red[i][0][vi][e];
    for (int w = 1; w < nw; ++w)
#pragma unroll
      for (int e = 0; e < N; ++e) s[e] += red[i][w][vi][e];
#pragma unroll
    for (int e = 0; e < N; ++e) s[e] = s[e] / (float)l;
    store_floats<N>(rmean + ((size_t)b * l + h0 + i) * c + (size_t)cvv * N, s);
  }
  if (active) {
    float* o = cp + ((size_t)b * gridDim.y + tile) * l * c + (size_t)cv * N;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int w = col0 + k * step;
      if (w < l) store_floats<N>(o + (size_t)w * c, col[k]);
    }
  }
}

// n floats global -> shared by cp.async, 16 bytes at a time where both
// src and dst are 16-byte aligned, else 4.
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             int n) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    for (int i = 4 * threadIdx.x; i + 4 <= n; i += 4 * blockDim.x)
      cp_async16(dst + i, src + i, true);
    for (int i = (n & ~3) + threadIdx.x; i < n; i += blockDim.x)
      cp_async4(dst + i, src + i, true);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i, true);
  }
}

// The last block of (sample b, direction d): y[b, d] -> norm, GELU -> yn,
// and its cross term yx = yn @ Wx + bx (Wx: wmix rows 0..R for d = 0, the
// h2w projection; rows R+1..2R+1 for d = 1, w2h). ca_apply forms
// zh = yn_h + s0 * yx_w and zw = yn_w + s1 * yx_h. Shared memory: v [L, R], the
// norm [2, R], stats [groups][mean, rstd], then Wx [R+1, R], staged
// together by cp.async.
__device__ __forceinline__ void mix_direction(
    float* sm, const float* __restrict__ y, const float* __restrict__ nrm_d,
    const float* __restrict__ wmix, float* __restrict__ yn,
    float* __restrict__ yx, int bd, int d, int l, int r, int norm_kind,
    int groups) {
  const int lr = l * r, tid = threadIdx.x;
  float* v = sm;
  float* nrm = v + ((lr + 3) & ~3);  // scale [R], shift [R]
  float* stats = nrm + ((2 * r + 3) & ~3);
  float* wx = stats + ((2 * groups + 3) & ~3);
  stage_floats(v, y + (size_t)bd * lr, lr);
  stage_floats(nrm, nrm_d, 2 * r);
  stage_floats(wx, wmix + (d ? (size_t)(r + 1) * r : 0), (r + 1) * r);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const int rg = r / groups;
  if (norm_kind == 0) {  // a warp per group: mean, then centred squares
    const int warp = tid >> 5, lane = tid & 31;
    const float cnt = (float)(l * rg);
    for (int g = warp; g < groups; g += kThreads / 32) {
      const float* vg = v + g * rg;
      float s = 0.f;
      for (int e = lane; e < l * rg; e += 32) s += vg[(e / rg) * r + e % rg];
      const float mean = warp_sum(s) / cnt;
      float ss = 0.f;
      for (int e = lane; e < l * rg; e += 32) {
        const float dv = vg[(e / rg) * r + e % rg] - mean;
        ss += dv * dv;
      }
      ss = warp_sum(ss);
      if (lane == 0) {
        stats[2 * g] = mean;
        stats[2 * g + 1] = rsqrtf(ss / cnt + 1e-5f);
      }
    }
    __syncthreads();
  }
  // thread = (column j, rows li0, li0 + step, ...): one division each
  const int per = kThreads / r > 0 ? kThreads / r : 1;
  if (tid < per * r) {
    const int j = tid % r;
    const float sc = nrm[j], sh = nrm[r + j];
    float mean = 0.f, rstd = 1.f;
    if (norm_kind == 0) {
      mean = stats[2 * (j / rg)];
      rstd = stats[2 * (j / rg) + 1];
    }
    for (int li = tid / r; li < l; li += per) {
      float u = v[li * r + j];
      if (norm_kind == 0) u = (u - mean) * rstd;
      u = gelu_erf(u * sc + sh);
      v[li * r + j] = u;
      yn[(size_t)bd * lr + li * r + j] = u;
    }
  }
  __syncthreads();
  // yx = v @ Wx + bx; thread = (2 rows, columns jt + q * tc for q < 4):
  // lanes take consecutive columns, so the weight reads hit distinct banks
  const int tc = (r + 3) / 4, tr = (l + 1) / 2;
  for (int t = tid; t < tr * tc; t += kThreads) {
    const int l0 = 2 * (t / tc), jt = t % tc;
    const float* a0 = v + l0 * r;
    const float* a1 = l0 + 1 < l ? a0 + r : a0;
    float acc[2][4] = {};
    for (int k = 0; k < r; ++k) {
      const float x0 = a0[k], x1 = a1[k];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w = jt + q * tc < r ? wx[k * r + jt + q * tc] : 0.f;
        acc[0][q] = fmaf(x0, w, acc[0][q]);
        acc[1][q] = fmaf(x1, w, acc[1][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = jt + q * tc;
      if (j >= r) continue;
      const float bias = wx[r * r + j];
      yx[(size_t)bd * lr + l0 * r + j] = acc[0][q] + bias;
      if (l0 + 1 < l) yx[(size_t)bd * lr + (l0 + 1) * r + j] = acc[1][q] + bias;
    }
  }
}

// grid (ceil(r / kBnCols) * n_splits, ceil(l / kBnRows), 2 * b), block
// kThreads. Block (column tile, k-slice, row tile, direction x sample).
// Its slice of C streams in chunks of kBnChunk channels through a ring of
// n_stages buffers filled by cp.async (as deep as the slice where shared
// memory allows: then every chunk's copies are in flight at once), the
// next chunks' copies in flight during the current chunk's products. A chunk of the column means is the
// T row tiles' sums (T = n_tiles), staged side by side and added in tile
// order, over L. Thread (k-group, row pair, column quad) accumulates 2 x 4
// outputs over its 16 channels of each chunk; the k-groups are added in
// order. With one slice the block writes y (plus the bias); otherwise it
// writes its partial tile to yp, and the last slice of the tile adds the
// slices in order. The block that completes a (sample, direction) then
// normalizes it (mix_direction).
__global__ void __launch_bounds__(kThreads, 3)
ca_bottleneck(const float* __restrict__ rmean, const float* __restrict__ cp,
              const float* __restrict__ w1h, const float* __restrict__ w1w,
              const float* __restrict__ nh, const float* __restrict__ nw,
              const float* __restrict__ wmix, float* __restrict__ yp,
              float* __restrict__ y, float* __restrict__ yn,
              float* __restrict__ yx, unsigned int* __restrict__ counter,
              int l, int c, int r, int n_tiles, int n_splits,
              int split_chunks, int n_stages, int norm_kind, int groups) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int last;
  const int dir = blockIdx.z & 1, b = blockIdx.z >> 1;
  const int n_jt = gridDim.x / n_splits;
  const int jt = blockIdx.x % n_jt, split = blockIdx.x / n_jt;
  const int l0 = blockIdx.y * kBnRows, j0 = jt * kBnCols;
  const int tid = threadIdx.x;
  const int kg = tid / 64, q = tid % 8, p = (tid % 64) / 8;
  const float* w1 = dir ? w1w : w1h;
  const int nt = dir ? n_tiles : 1;  // row tiles summed into a chunk of means
  const float* src = dir ? cp + (size_t)b * n_tiles * l * c
                         : rmean + (size_t)b * l * c;
  const int a_floats = nt * kBnRows * kBnPitch;
  const int stage_n = a_floats + kBnChunk * kBnCols;  // floats per buffer
  const bool w_vec = r % 4 == 0 && (reinterpret_cast<uintptr_t>(w1) & 15) == 0;
  allow_dependents();  // ca_apply may take free SMs for its prologue
  if (blockIdx.z == 0) {  // warm L2 with the mix's weights for the last blocks
    const int lines = (2 * (r + 1) * r + 31) / 32;  // 128-byte lines
    for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * kThreads + tid;
         i < lines; i += gridDim.x * gridDim.y * kThreads)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(wmix + (size_t)i * 32));
  }
  wait_for_prior_grid();  // ca_pool's means and sums
  const int ch0 = split * split_chunks * kBnChunk;
  const int n_chunks = min(split_chunks, (c - ch0 + kBnChunk - 1) / kBnChunk);
  // chunk ch (of this slice) into ring buffer s: nt tiles a [kBnRows][kBnPitch],
  // then wt [kBnChunk][kBnCols]
  auto stage = [&](int s, int ch) {
    float* a = sm + s * stage_n;
    float* wt = a + a_floats;
    const int c0 = ch0 + ch * kBnChunk;
    for (int i = tid; i < nt * kBnRows * (kBnChunk / 4); i += kThreads) {
      const int t = i / (kBnRows * (kBnChunk / 4));
      const int row = (i / (kBnChunk / 4)) % kBnRows, seg = 4 * (i % (kBnChunk / 4));
      const bool ok = l0 + row < l && c0 + seg < c;
      cp_async16(a + (t * kBnRows + row) * kBnPitch + seg,
                 ok ? src + ((size_t)t * l + l0 + row) * c + c0 + seg : src, ok);
    }
    if (w_vec) {
#pragma unroll
      for (int u = 0; u < kBnChunk * kBnCols / 4 / kThreads; ++u) {
        const int i = tid + u * kThreads;
        const int k = i / (kBnCols / 4), j = 4 * (i % (kBnCols / 4));
        const bool ok = c0 + k < c && j0 + j < r;
        cp_async16(wt + k * kBnCols + j, ok ? w1 + (size_t)(c0 + k) * r + j0 + j : w1, ok);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kBnChunk * kBnCols / kThreads; ++u) {
        const int i = tid + u * kThreads;
        const int k = i / kBnCols, j = i % kBnCols;
        const bool ok = c0 + k < c && j0 + j < r;
        cp_async4(wt + i, ok ? w1 + (size_t)(c0 + k) * r + j0 + j : w1, ok);
      }
    }
  };
  float acc[2][4] = {};
  for (int i = 0; i < n_stages - 1; ++i) {
    if (i < n_chunks) stage(i, i);
    cp_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    cp_wait_n(n_stages - 2);  // chunk i has landed
    __syncthreads();            // ... for every thread; buffer (i - 1) is free
    if (i + n_stages - 1 < n_chunks)
      stage((i + n_stages - 1) % n_stages, i + n_stages - 1);
    cp_commit();
    float* a = sm + (i % n_stages) * stage_n;
    const float* wt = a + a_floats;
    if (nt > 1) {  // column means: the row tiles' sums in tile order, over L
      for (int e = tid; e < kBnRows * kBnChunk; e += kThreads) {
        const int at = (e / kBnChunk) * kBnPitch + e % kBnChunk;
        float s = a[at];
        for (int t = 1; t < nt; ++t) s += a[t * kBnRows * kBnPitch + at];
        a[at] = s / (float)l;
      }
      __syncthreads();
    } else if (dir) {
      for (int e = tid; e < kBnRows * kBnChunk; e += kThreads) {
        const int at = (e / kBnChunk) * kBnPitch + e % kBnChunk;
        a[at] = a[at] / (float)l;
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < kBnChunk / kBnGroups; ++kk) {
      const int k = kg * (kBnChunk / kBnGroups) + kk;
      const float a0 = a[(2 * p) * kBnPitch + k];
      const float a1 = a[(2 * p + 1) * kBnPitch + k];
      const float4 wv = *reinterpret_cast<const float4*>(wt + k * kBnCols + 4 * q);
      acc[0][0] = fmaf(a0, wv.x, acc[0][0]);
      acc[0][1] = fmaf(a0, wv.y, acc[0][1]);
      acc[0][2] = fmaf(a0, wv.z, acc[0][2]);
      acc[0][3] = fmaf(a0, wv.w, acc[0][3]);
      acc[1][0] = fmaf(a1, wv.x, acc[1][0]);
      acc[1][1] = fmaf(a1, wv.y, acc[1][1]);
      acc[1][2] = fmaf(a1, wv.z, acc[1][2]);
      acc[1][3] = fmaf(a1, wv.w, acc[1][3]);
    }
  }
  cp_wait<0>();
  __syncthreads();
  float* red = sm;  // [kBnGroups][kBnRows][kBnCols], over the staging buffers
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      red[(kg * kBnRows + 2 * p + i) * kBnCols + 4 * q + jj] = acc[i][jj];
  __syncthreads();
  const int tile = (blockIdx.z * gridDim.y + blockIdx.y) * n_jt + jt;  // (b, dir, rt, jt)
  float* yb = y + ((size_t)b * 2 + dir) * l * r;
  float* pb = yp + ((size_t)tile * n_splits + split) * kBnRows * kBnCols;
  for (int o = tid; o < kBnRows * kBnCols; o += kThreads) {
    float s = red[o];
    for (int g = 1; g < kBnGroups; ++g) s += red[g * kBnRows * kBnCols + o];
    const int li = l0 + o / kBnCols, jj = j0 + o % kBnCols;
    if (n_splits > 1)
      pb[o] = s;
    else if (li < l && jj < r)
      yb[(size_t)li * r + jj] = s + __ldg(w1 + (size_t)c * r + jj);
  }
  if (n_splits > 1) {  // the tile's last slice adds the slices in order
    if (!last_block(counter + gridDim.z + tile, n_splits, &last)) return;
    const float* tb = yp + (size_t)tile * n_splits * kBnRows * kBnCols;
    for (int o = tid; o < kBnRows * kBnCols; o += kThreads) {
      const int li = l0 + o / kBnCols, jj = j0 + o % kBnCols;
      if (li >= l || jj >= r) continue;
      float s = __ldcg(tb + o);
      for (int k = 1; k < n_splits; ++k) s += __ldcg(tb + k * kBnRows * kBnCols + o);
      yb[(size_t)li * r + jj] = s + __ldg(w1 + (size_t)c * r + jj);
    }
  }
  // the block that completes (sample, direction) normalizes it
  if (!last_block(counter + blockIdx.z, n_jt * gridDim.y, &last)) return;
  mix_direction(sm, y, dir ? nw : nh, wmix, yn, yx, blockIdx.z, dir, l, r,
                norm_kind, groups);
}

// grid (ceil(c / kApplyCh), ceil(l / rows), b), block kThreads; dynamic
// shared memory ((rows + l) * (rp + max(rp, kApplyCh)) + 2 * rp *
// kApplyCh) floats, rp = r rounded up to 4. The chunk's Wout is staged by
// cp.async and the thread's first kApplyUnroll 16-byte vectors of x are loaded
// before the kernel waits for ca_bottleneck's yn and yx (programmatic
// dependent launch), so both are in flight during the bottleneck's tail
// and the gates' products.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
ca_apply(const typename Vec<T>::type* __restrict__ x, const float* __restrict__ yn,
         const float* __restrict__ yx, const float* __restrict__ wout,
         const float* __restrict__ bout,
         const float* __restrict__ scal, typename Vec<T>::type* __restrict__ out,
         int l, int c, int r, int rows) {
  extern __shared__ __align__(16) float sm[];
  constexpr int N = Vec<T>::n;
  // V: 16-byte vectors of x per chunk row (8 fp32 / 4 bf16)
  constexpr int U = kApplyUnroll, V = kApplyCh / N, H = kApplyCh / 32;
  const int cv_n = c / N, rp = (r + 3) & ~3;
  // blocks walk x in the reverse of ca_pool's order: the part it read last
  // may still be in L2
  const int chunk = gridDim.x - 1 - blockIdx.x, b = gridDim.z - 1 - blockIdx.z;
  const int h0 = (gridDim.y - 1 - blockIdx.y) * rows, nh = min(rows, l - h0);
  const int nrow = nh + l;  // gate rows: the tile's rows, then all L columns
  float* zs = sm;                    // [nrow][rp]
  float* ws = zs + nrow * rp;        // [2][rp][kApplyCh]: Wh, Ww for the chunk
  float* gs = ws + 2 * rp * kApplyCh;  // [nrow][kApplyCh]
  float* xs = gs;                    // [nrow][rp]: yx rows, before the gates
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = chunk * kApplyCh;

  constexpr int WV = kApplyCh / 4;  // 16-byte pieces of a Wout row (fp32)
  for (int i = tid; i < 2 * rp * WV; i += kThreads) {  // rows of [Wh; Ww]
    const int row = i / WV, seg = 4 * (i % WV);
    const int d = row / rp, k = row % rp;
    const bool ok = k < r && c0 + seg < c;
    cp_async16(ws + row * kApplyCh + seg,
               ok ? wout + ((size_t)d * r + k) * c + c0 + seg : wout, ok);
  }
  cp_commit();

  // this thread's 16-byte vector of the tile: vector vi of the pairs (row,
  // col) slot, slot + kThreads / V, ... (row-major over the tile)
  const int vi = tid % V, pstep = kThreads / V;
  const bool vok = chunk * V + vi < cv_n;
  const size_t base = ((size_t)b * l + h0) * l * cv_n + chunk * V + vi;
  const int n_pairs = vok ? nh * l : 0;
  int pair = tid / V;
  typename Vec<T>::type xv[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (pair + u * pstep < n_pairs)
      xv[u] = __ldg(x + base + (size_t)(pair + u * pstep) * cv_n);

  wait_for_prior_grid();  // ca_bottleneck's yn and yx
  // z rows: zh = yn_h + s0 * yx_w for the tile's rows, then
  // zw = yn_w + s1 * yx_h for all L columns; yn into zs, yx into xs
  const float* nb = yn + (size_t)b * 2 * l * r;
  const float* pb = yx + (size_t)b * 2 * l * r;
  for (int i = tid; i < nrow * rp; i += kThreads) {
    const int gr = i / rp, k = i % rp;
    const bool ok = k < r;
    const size_t hn = (size_t)(h0 + gr) * r + k, wn = (size_t)(l + gr - nh) * r + k;
    const size_t hx = (size_t)(l + h0 + gr) * r + k, wx = (size_t)(gr - nh) * r + k;
    cp_async4(zs + i, ok ? nb + (gr < nh ? hn : wn) : nb, ok);
    cp_async4(xs + i, ok ? pb + (gr < nh ? hx : wx) : pb, ok);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  {
    const float s0 = scal[0], s1 = scal[1];
    for (int i = tid; i < nrow * rp; i += kThreads)
      zs[i] = fmaf(i < nh * rp ? s0 : s1, xs[i], zs[i]);
  }
  __syncthreads();

  // gates: lane = channels lane + 32 * q (q < H) of the chunk; a warp takes
  // groups of 4 gate rows
  const int ngh = (nh + 3) / 4, ngw = (l + 3) / 4;
  for (int grp = warp; grp < ngh + ngw; grp += kThreads / 32) {
    const bool is_w = grp >= ngh;
    const int first = is_w ? nh + 4 * (grp - ngh) : 4 * grp;
    const int end = is_w ? nrow : nh;
    const float* wk = ws + (is_w ? rp * kApplyCh : 0) + lane;
    float acc[4][H] = {};
    for (int k = 0; k < rp; k += 4) {
      float w[4][H];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < H; ++q) w[kk][q] = wk[(k + kk) * kApplyCh + 32 * q];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int gr = min(first + g, end - 1);
        const float4 zv = *reinterpret_cast<const float4*>(zs + gr * rp + k);
#pragma unroll
        for (int q = 0; q < H; ++q) {
          acc[g][q] = fmaf(zv.x, w[0][q], acc[g][q]);
          acc[g][q] = fmaf(zv.y, w[1][q], acc[g][q]);
          acc[g][q] = fmaf(zv.z, w[2][q], acc[g][q]);
          acc[g][q] = fmaf(zv.w, w[3][q], acc[g][q]);
        }
      }
    }
    const float s = scal[is_w ? 3 : 2];
#pragma unroll
    for (int q = 0; q < H; ++q) {
      const int ch = c0 + lane + 32 * q;
      const float bias = ch < c ? __ldg(bout + (is_w ? c : 0) + ch) : 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (first + g < end)
          gs[(first + g) * kApplyCh + lane + 32 * q] = s * sigmoid(acc[g][q] + bias);
    }
  }
  __syncthreads();

  for (;; pair += U * pstep) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pr = pair + u * pstep;
      if (pr >= n_pairs) break;
      const int row = pr / l, col = pr - row * l;
      const float4* gh = reinterpret_cast<const float4*>(gs + row * kApplyCh + N * vi);
      const float4* gw = reinterpret_cast<const float4*>(gs + (nh + col) * kApplyCh + N * vi);
      float f[N];
      Vec<T>::widen(xv[u], f);
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        const float4 a = gh[k], bw = gw[k];
        f[4 * k] *= a.x + bw.x;
        f[4 * k + 1] *= a.y + bw.y;
        f[4 * k + 2] *= a.z + bw.z;
        f[4 * k + 3] *= a.w + bw.w;
      }
      out[base + (size_t)pr * cv_n] = Vec<T>::narrow(f);
    }
    const int next = pair + U * pstep;
    if (next >= n_pairs) break;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (next + u * pstep < n_pairs)
        xv[u] = __ldg(x + base + (size_t)(next + u * pstep) * cv_n);
  }
}

template <typename T, int KC>
cudaError_t launch_pool(dim3 grid, int threads, cudaStream_t s, const T* x,
                        float* rmean, float* cp, int l, int cv_n, int rows) {
  ca_pool<T, KC><<<grid, threads, 0, s>>>(
      reinterpret_cast<const typename Vec<T>::type*>(x), rmean, cp, l, cv_n,
      rows);
  return cudaGetLastError();
}

// Launch with programmatic stream serialization: the kernel may start
// while the one before it on the stream runs (it waits for it itself).
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int threads,
                             int smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Blocks above 48 KB of dynamic shared memory must ask for it first; a
// kernel asks once, for all it may take, so that a call makes no such
// host call (at the small sites the host's pace sets the launches').
constexpr int kMaxDevices = 64;
constexpr int kDynamicSmem = kMaxSmem - 1024;  // what a kernel asks for

cudaError_t allow_smem(const void* fn, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || bytes <= 48 * 1024 || dev >= kMaxDevices ||
      done[dev])
    return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDynamicSmem);
  done[dev] = err == cudaSuccess;
  return err;
}

// The three launches of one call, on stream s of the current device.
template <typename T>
cudaError_t launch(const T* x, const float* w1h, const float* w1w,
                   const float* nh, const float* nw, const float* wmix,
                   const float* wout, const float* bout, const float* scal,
                   T* out, float* scratch, unsigned int* counter, int b,
                   int l, int c, int r, int norm_kind, int groups,
                   int pool_rows, int pool_threads, int n_splits,
                   int split_chunks, int n_stages, int apply_rows,
                   int bottleneck_smem, int apply_smem, cudaStream_t s) {
  const int cv_n = c / Vec<T>::n;
  const int n_tiles = (l + pool_rows - 1) / pool_rows;
  const int chunks = (cv_n + kChunkV - 1) / kChunkV;
  const int cols_per_step = (pool_threads / 32) * kColsPerWarp;
  const int kc = (l + cols_per_step - 1) / cols_per_step;
  if (pool_rows > kPoolRows || pool_threads > kPoolWarps * 32 || kc > 8 ||
      n_stages < 2 || n_stages > kBnMaxStages || c % Vec<T>::n ||
      (size_t)n_splits * split_chunks * kBnChunk < (size_t)c)
    return cudaErrorInvalidValue;
  float* rmean = scratch;
  float* cp = rmean + (size_t)b * l * c;
  float* y = cp + (size_t)b * n_tiles * l * c;
  float* yn = y + (size_t)b * 2 * l * r;
  float* yx = yn + (size_t)b * 2 * l * r;
  float* yp = yx + (size_t)b * 2 * l * r;

  const dim3 pool_grid(chunks, n_tiles, b);
  cudaError_t err =
      kc <= 1 ? launch_pool<T, 1>(pool_grid, pool_threads, s, x, rmean, cp, l, cv_n, pool_rows)
      : kc <= 2 ? launch_pool<T, 2>(pool_grid, pool_threads, s, x, rmean, cp, l, cv_n, pool_rows)
      : kc <= 4 ? launch_pool<T, 4>(pool_grid, pool_threads, s, x, rmean, cp, l, cv_n, pool_rows)
                : launch_pool<T, 8>(pool_grid, pool_threads, s, x, rmean, cp, l, cv_n, pool_rows);
  if (err != cudaSuccess) return err;

  static bool bn_smem[kMaxDevices] = {}, apply_smem_set[kMaxDevices] = {};
  err = allow_smem(reinterpret_cast<const void*>(ca_bottleneck), bottleneck_smem,
                   bn_smem);
  if (err != cudaSuccess) return err;
  const dim3 bn_grid((r + kBnCols - 1) / kBnCols * n_splits,
                     (l + kBnRows - 1) / kBnRows, 2 * b);
  err = launch_dependent(ca_bottleneck, bn_grid, kThreads, bottleneck_smem, s,
                         rmean, cp, w1h, w1w, nh, nw, wmix, yp, y, yn, yx,
                         counter, l, c, r, n_tiles, n_splits, split_chunks,
                         n_stages, norm_kind, groups);
  if (err != cudaSuccess) return err;

  err = allow_smem(reinterpret_cast<const void*>(ca_apply<T>), apply_smem,
                   apply_smem_set);
  if (err != cudaSuccess) return err;
  const dim3 apply_grid((c + kApplyCh - 1) / kApplyCh,
                        (l + apply_rows - 1) / apply_rows, b);
  using V = typename Vec<T>::type;
  return launch_dependent(
      ca_apply<T>, apply_grid, kThreads, apply_smem, s,
      reinterpret_cast<const V*>(x), yn, yx, wout, bout, scal,
      reinterpret_cast<V*>(out), l, c, r, apply_rows);
}

// The entry points' body: the shape and plan from p, on the given device.
template <typename T>
int forward(const T* x, const float* const* w, T* out, float* scratch,
            unsigned int* counter, const int* p, void* stream) {
  const int device = p[0], b = p[1], l = p[2], c = p[3], r = p[4];
  const int norm_kind = p[5], groups = p[6], pool_rows = p[7];
  const int pool_threads = p[8], n_splits = p[9], split_chunks = p[10];
  const int n_stages = p[11], apply_rows = p[12], bottleneck_smem = p[13];
  const int apply_smem = p[14];
  const float *w1h = w[0], *w1w = w[1], *nh = w[2], *nw = w[3], *wmix = w[4];
  const float *wout = w[5], *bout = w[6], *scal = w[7];
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch<T>(x, w1h, w1w, nh, nw, wmix, wout, bout, scal, out, scratch,
                  counter, b, l, c, r, norm_kind, groups, pool_rows,
                  pool_threads, n_splits, split_chunks, n_stages, apply_rows,
                  bottleneck_smem, apply_smem, static_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [b, l, l, c], fp32 (coord_attn_forward) or bf16
// (coord_attn_forward_bf16); w holds the packed weights w1h, w1w: [c+1, r];
// nh, nw: [2, r]; wmix: [2(r+1), r]; wout: [2r, c]; bout: [2, c]; scal: >= 4
// floats, all fp32. All contiguous; x and out 16-byte aligned, c % 4 == 0
// (fp32) or c % 8 == 0 (bf16).
// p holds the shape and the launch plan (kernels/coord_attn.py
// launch_plan): the device, b, l, c, r, norm_kind (0 = group with
// r % groups == 0, 1 = affine), groups, pool_rows rows per ca_pool tile (T =
// ceil(l / pool_rows) tiles), pool_threads = 32 * warps with warps * 32 * 8
// >= l (l <= 256), the bottleneck's k-slices (n_splits of split_chunks
// chunks of 64 channels) and ring depth (n_stages), apply_rows rows per
// ca_apply tile, and the dynamic shared memory of ca_bottleneck and
// ca_apply in bytes. scratch holds, in floats, rmean [b, l, c], cp
// [b, T, l, c], y, yn and yx [b, 2, l, r] each and, with n_splits > 1, yp
// [b * 2 * tiles, n_splits, 16 * 32] (tiles = ceil(l / 16) * ceil(r /
// 32)). counter holds 2 * b * (1 + tiles) zeros and is left zeroed. The
// launches go to `stream` on the given device.
int coord_attn_forward(const float* x, const float* const* w, float* out,
                       float* scratch, unsigned int* counter, const int* p,
                       void* stream) {
  return forward<float>(x, w, out, scratch, counter, p, stream);
}

int coord_attn_forward_bf16(const __nv_bfloat16* x, const float* const* w,
                            __nv_bfloat16* out, float* scratch,
                            unsigned int* counter, const int* p, void* stream) {
  return forward<__nv_bfloat16>(x, w, out, scratch, counter, p, stream);
}

}  // extern "C"
