// Coordinate attention for Hopper (sm_90a), fp32, NHWC, square maps (L = H = W).
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
// The Pallas kernel holds a sample's whole [H,W,C] block in VMEM; at the
// flagship's first site that is 12.6 MB, which no SM can hold (227 KB of
// shared memory). So the work is split into six launches:
//
//   ca_pool        one read of x: complete row means (direction 0 of
//                  pooled[B,2,L,C]) and per-tile column sums pw[B,n_tiles,L,C]
//                  (a block owns a tile of rows)
//   ca_pool_finish adds the column partials in a fixed order -> direction 1
//   ca_proj_in     y = pooled @ W1 + b in slices of 128 channels: one thread
//                  per output and slice, lanes across R so that the weight
//                  reads are coalesced
//   ca_mix         one block per sample and row: adds the slices in order,
//                  GroupNorm statistics (or the folded affine), GELU and the
//                  cross mix in shared memory -> z[B,2,L,R]
//   ca_proj_out    gates[B,2,L,C] = s * sigmoid(z @ Wout + b): one thread per
//                  output, lanes across C
//   ca_apply       the second read of x: out = x * (gates[0][h] + gates[1][w])
//
// Bound: memory. The function must read x once and write out once; this
// design reads x twice, so it reaches at best 2/3 of the bandwidth bound.
// The products are 2*L*C*R per sample and direction, far below the card's
// rate; each runs over ~50k-800k threads at the flagship sites.
//
// Determinism: no atomics; every sum runs in a fixed order, so a sample's
// output depends on nothing else in its batch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTX = 16;        // threads across channel vectors (64 channels)
constexpr int kTY = 16;        // threads across columns
constexpr int kMaxCols = 16;   // columns per thread: W <= kTY * kMaxCols
constexpr int kThreads = 256;  // block size of the flat kernels
constexpr int kInSlice = 128;  // channels per ca_proj_in slice

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 div4(float4 a, float d) {
  return make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// grid (n_tiles, ceil(c4 / kTX), B), block (kTX, kTY)
__global__ void ca_pool(const float4* __restrict__ x, float4* __restrict__ pooled,
                        float4* __restrict__ pw, int l, int c4, int rows_per_tile,
                        int n_tiles) {
  const int tile = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int cv = blockIdx.y * kTX + tx;
  const int b = blockIdx.z;
  const int h0 = tile * rows_per_tile;
  const int h1 = min(h0 + rows_per_tile, l);
  const bool active = cv < c4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 col[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) col[k] = zero;
  __shared__ float4 red[kTY][kTX];
  for (int hh = h0; hh < h1; ++hh) {
    float4 row = zero;
    if (active) {
      const float4* xr = x + ((size_t)b * l + hh) * l * c4 + cv;
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        const int ww = ty + k * kTY;
        if (ww < l) {
          const float4 v = xr[(size_t)ww * c4];
          col[k] = add4(col[k], v);
          row = add4(row, v);
        }
      }
    }
    red[ty][tx] = row;
    __syncthreads();
    if (ty == 0 && active) {
      float4 s = red[0][tx];
      for (int i = 1; i < kTY; ++i) s = add4(s, red[i][tx]);
      pooled[((size_t)b * 2 * l + hh) * c4 + cv] = div4(s, (float)l);
    }
    __syncthreads();
  }
  if (active) {
    float4* out = pw + ((size_t)b * n_tiles + tile) * l * c4 + cv;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int ww = ty + k * kTY;
      if (ww < l) out[(size_t)ww * c4] = col[k];
    }
  }
}

// one thread per (b, w, channel vector): pooled[b,1,w] = sum_tiles pw / L
__global__ void ca_pool_finish(const float4* __restrict__ pw,
                               float4* __restrict__ pooled, int nb, int l, int c4,
                               int n_tiles) {
  const size_t per_sample = (size_t)l * c4;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_sample * nb) return;
  const size_t b = i / per_sample, rem = i % per_sample;
  const float4* p = pw + b * n_tiles * per_sample + rem;
  float4 s = p[0];
  for (int t = 1; t < n_tiles; ++t) s = add4(s, p[(size_t)t * per_sample]);
  pooled[(2 * b + 1) * per_sample + rem] = div4(s, (float)l);
}

// one thread per (b, slice, dir, l, j): the part of y = pooled @ W1 + bias
// over one slice of kInSlice channels (slice 0 adds the bias); ca_mix adds
// the slices in order
__global__ void ca_proj_in(const float* __restrict__ pooled,
                           const float* __restrict__ w1h,
                           const float* __restrict__ w1w, float* __restrict__ y,
                           int nb, int l, int c, int r, int n_slices) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_slice = (size_t)2 * l * r;
  if (i >= (size_t)nb * n_slices * per_slice) return;
  const int j = (int)(i % r);
  const int li = (int)((i / r) % l);
  const int dir = (int)((i / ((size_t)l * r)) % 2);
  const int slice = (int)((i / per_slice) % n_slices);
  const size_t b = i / (per_slice * n_slices);
  const float* src = pooled + ((b * 2 + dir) * l + li) * c;
  const float* wk = dir ? w1w : w1h;
  const int c0 = slice * kInSlice, c1 = min(c, c0 + kInSlice);
  float s = 0.f;
  for (int ch = c0; ch < c1; ++ch) s += src[ch] * wk[(size_t)ch * r + j];
  y[i] = slice == 0 ? s + wk[(size_t)c * r + j] : s;
}

// grid (L, B), block (kThreads), dynamic shared memory
// (2*L*R + 2*R + 4*groups) floats. Block (li, b) adds the slices of y for
// the whole sample, takes GroupNorm statistics over it (or the folded
// affine), normalises row li of both directions, applies GELU, and mixes
// the two rows: zh = yh + s0 * w2h(yw), zw = yw + s1 * h2w(yh).
__global__ void ca_mix(const float* __restrict__ y, const float* __restrict__ nh,
                       const float* __restrict__ nw, const float* __restrict__ wmix,
                       const float* __restrict__ scal, float* __restrict__ z, int l,
                       int r, int norm_kind, int groups, int n_slices) {
  extern __shared__ float sm[];
  const int lr = l * r;
  float* raw = sm;             // [2, L, R]
  float* row = sm + 2 * lr;    // [2, R]: row li, normalised
  float* stats = row + 2 * r;  // [2 directions][groups][mean, rstd]
  const int li = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* yb = y + (size_t)b * n_slices * 2 * lr;
  for (int i = tid; i < 2 * lr; i += nt) {
    float s = yb[i];
    for (int p = 1; p < n_slices; ++p) s += yb[(size_t)p * 2 * lr + i];
    raw[i] = s;
  }
  __syncthreads();

  const int rg = r / groups;
  if (norm_kind == 0) {  // GroupNorm statistics, one thread per direction and group
    for (int q = tid; q < 2 * groups; q += nt) {
      const int dir = q / groups, g = q % groups;
      const float* v = raw + dir * lr;
      const float cnt = (float)(l * rg);
      float s = 0.f;
      for (int k = 0; k < l; ++k)
        for (int m = 0; m < rg; ++m) s += v[k * r + g * rg + m];
      const float mean = s / cnt;
      float var = 0.f;
      for (int k = 0; k < l; ++k)
        for (int m = 0; m < rg; ++m) {
          const float d = v[k * r + g * rg + m] - mean;
          var += d * d;
        }
      stats[q * 2] = mean;
      stats[q * 2 + 1] = rsqrtf(var / cnt + 1e-5f);
    }
    __syncthreads();
  }
  // normalise row li (GroupNorm, or the folded affine), scale/shift, GELU
  for (int i = tid; i < 2 * r; i += nt) {
    const int dir = i / r, j = i % r;
    const float* nrm = dir ? nw : nh;
    float v = raw[dir * lr + li * r + j];
    if (norm_kind == 0) {
      const float* st = stats + (dir * groups + j / rg) * 2;
      v = (v - st[0]) * st[1];
    }
    row[i] = gelu_erf(v * nrm[j] + nrm[r + j]);
  }
  __syncthreads();

  const float* yh = row;
  const float* yw = row + r;
  const float s0 = scal[0], s1 = scal[1];
  float* zb = z + (size_t)b * 2 * lr + li * r;
  for (int j = tid; j < r; j += nt) {
    float h2w = 0.f, w2h = 0.f;
    for (int k = 0; k < r; ++k) {
      h2w += yh[k] * wmix[(size_t)k * r + j];
      w2h += yw[k] * wmix[(size_t)(r + 1 + k) * r + j];
    }
    h2w += wmix[(size_t)r * r + j];
    w2h += wmix[(size_t)(2 * r + 1) * r + j];
    zb[j] = yh[j] + s0 * w2h;
    zb[lr + j] = yw[j] + s1 * h2w;
  }
}

// one thread per (b, dir, l, ch): gates = s_dir * sigmoid(z @ Wout_dir + b)
__global__ void ca_proj_out(const float* __restrict__ z,
                            const float* __restrict__ wout,
                            const float* __restrict__ bout,
                            const float* __restrict__ scal,
                            float* __restrict__ gates, int nb, int l, int c,
                            int r) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)nb * 2 * l * c) return;
  const int ch = (int)(i % c);
  const size_t row = i / c;  // (b * 2 + dir) * l + li
  const int dir = (int)((row / l) % 2);
  const float* zr = z + row * r;
  const float* wk = wout + (size_t)dir * r * c + ch;
  float s = 0.f;
  for (int k = 0; k < r; ++k) s += zr[k] * wk[(size_t)k * c];
  gates[i] = scal[2 + dir] * sigmoid(s + bout[(size_t)dir * c + ch]);
}

// grid (B*L, ceil(L*c4 / kThreads)), block (kThreads)
__global__ void ca_apply(const float4* __restrict__ x,
                         const float4* __restrict__ gates,
                         float4* __restrict__ out, int l, int c4) {
  const int row = blockIdx.x;  // b * l + hh
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= l * c4) return;
  const int b = row / l, hh = row % l;
  const int ww = j / c4, cv = j % c4;
  const size_t idx = (size_t)row * l * c4 + j;
  const float4 v = x[idx];
  const float4 a = gates[((size_t)b * 2 * l + hh) * c4 + cv];
  const float4 g = gates[((size_t)b * 2 * l + l + ww) * c4 + cv];
  out[idx] = make_float4(v.x * (a.x + g.x), v.y * (a.y + g.y),
                         v.z * (a.z + g.z), v.w * (a.w + g.w));
}

unsigned int blocks_for(size_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Channels per ca_proj_in slice: y holds ceil(c / ca_in_slice()) slices.
int ca_in_slice() { return kInSlice; }

// x, out: [b, l, l, c]; pooled, gates: [b, 2, l, c]; pw: [b, n_tiles, l, c];
// y: [b, ceil(c / ca_in_slice()), 2, l, r]; z: [b, 2, l, r]; w1h, w1w: [c+1, r]; nh, nw: [2, r]; wmix: [2(r+1), r];
// wout: [2r, c]; bout: [2, c]; scal: >= 4 floats. All fp32, contiguous,
// 16-byte aligned where read as float4 (x, out, pooled, pw, gates); c % 4 == 0;
// l <= kTY * kMaxCols; norm_kind 0 = group (r % groups == 0), 1 = affine;
// (2*l*r + 2*r + 4*groups) floats of shared memory for ca_mix.
int coord_attn_forward(const float* x, const float* w1h, const float* w1w,
                       const float* nh, const float* nw, const float* wmix,
                       const float* wout, const float* bout, const float* scal,
                       float* out, float* pooled, float* pw, float* y, float* z,
                       float* gates, int b, int l, int c, int r, int norm_kind,
                       int groups, int rows_per_tile, int n_tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c4 = c / 4;
  if (l > kTY * kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  dim3 pool_grid(n_tiles, (c4 + kTX - 1) / kTX, b);
  ca_pool<<<pool_grid, dim3(kTX, kTY), 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(pooled),
      reinterpret_cast<float4*>(pw), l, c4, rows_per_tile, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ca_pool_finish<<<blocks_for((size_t)b * l * c4), kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(pw), reinterpret_cast<float4*>(pooled), b,
      l, c4, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_slices = (c + kInSlice - 1) / kInSlice;
  ca_proj_in<<<blocks_for((size_t)b * n_slices * 2 * l * r), kThreads, 0, s>>>(
      pooled, w1h, w1w, y, b, l, c, r, n_slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = (size_t)(2 * l * r + 2 * r + 4 * groups) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ca_mix, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ca_mix<<<dim3(l, b), kThreads, smem, s>>>(y, nh, nw, wmix, scal, z, l, r,
                                             norm_kind, groups, n_slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ca_proj_out<<<blocks_for((size_t)b * 2 * l * c), kThreads, 0, s>>>(
      z, wout, bout, scal, gates, b, l, c, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  dim3 apply_grid(b * l, (l * c4 + kThreads - 1) / kThreads);
  ca_apply<<<apply_grid, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(gates),
      reinterpret_cast<float4*>(out), l, c4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
