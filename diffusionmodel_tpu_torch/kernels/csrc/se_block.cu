// Squeeze-excitation for Hopper (sm_90a), fp32, NHWC.
//
//   out = x * sigmoid(GELU(mean_HW(x) @ w1) @ w2)     x [B,H,W,C], w1 [C,R], w2 [R,C]
//
// Replaces the Pallas kernel diffusionmodel_tpu/kernels/se_block.py
// (se_block_fused -> _make_se_kernel). That kernel walks one sample's H-tiles
// in order, carrying the channel sum in VMEM from one grid step to the next.
// Blocks on a GPU run in no order and carry nothing, so the work is split
// into four launches:
//
//   (a) se_pool_partial: many blocks per sample each sum a tile of pixels
//       and write fp32 partial sums partial[B, n_tiles, C]. Threads of a
//       block read neighbouring channels of one pixel (16-byte loads), so
//       the reads are coalesced in NHWC.
//   (b) se_squeeze: one block per sample and slice of 64 channels adds the
//       partials in a fixed order (the channel means) and multiplies them
//       into its 64 rows of w1: hidden_part[B, n_slices, R].
//   (c) se_excite: one block per sample and 256 channels adds the slices
//       in order, applies GELU, and computes gate = sigmoid(hidden @ w2)
//       for its channels. Both small products stay inside the kernels, with
//       lanes across the contiguous axis of the weights (coalesced reads).
//   (d) se_apply: out = x * gate[b, c], 16 bytes per thread.
//
// Bound: memory. The function must read x once and write out once; this
// design reads x twice (the pooling pass and the apply pass), so it can
// reach at best 2/3 of the bandwidth bound. The arithmetic (2 flops per
// element plus 4*C*R per sample) is far below the card's rate.
//
// Determinism: no atomics; every sum runs in a fixed order, so a sample's
// output does not depend on the other samples of its batch or on the run.
// GELU is the exact erf form, as in the JAX module and its XLA twin (the
// Pallas kernel used the tanh form).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTX = 16;  // threads across channel vectors (16 x float4 = 64 channels)
constexpr int kTY = 16;  // threads across pixels
constexpr int kSlice = 64;  // channels per se_squeeze block
constexpr int kThreads = 256;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// grid (n_tiles, ceil(c4 / kTX), B), block (kTX, kTY)
__global__ void se_pool_partial(const float4* __restrict__ x,
                                float4* __restrict__ partial, int hw, int c4,
                                int tile_pixels, int n_tiles) {
  const int tile = blockIdx.x;
  const int cv = blockIdx.y * kTX + threadIdx.x;
  const int b = blockIdx.z;
  const int p0 = tile * tile_pixels;
  const int p1 = min(p0 + tile_pixels, hw);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (cv < c4) {
    const float4* xb = x + (size_t)b * hw * c4 + cv;
    for (int p = p0 + threadIdx.y; p < p1; p += kTY) {
      acc = add4(acc, xb[(size_t)p * c4]);
    }
  }
  __shared__ float4 red[kTY][kTX];
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && cv < c4) {
    float4 s = red[0][threadIdx.x];
    for (int i = 1; i < kTY; ++i) s = add4(s, red[i][threadIdx.x]);
    partial[((size_t)b * n_tiles + tile) * c4 + cv] = s;
  }
}

// grid (n_slices, B), block (kThreads)
__global__ void se_squeeze(const float* __restrict__ partial,
                           const float* __restrict__ w1,
                           float* __restrict__ hidden_part, int hw, int c, int r,
                           int n_tiles) {
  __shared__ float pooled[kSlice];
  const int slice = blockIdx.x, b = blockIdx.y;
  const int c0 = slice * kSlice, n = min(kSlice, c - c0);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* pp = partial + (size_t)b * n_tiles * c + c0 + k;
    float s = 0.f;
#pragma unroll 8
    for (int t = 0; t < n_tiles; ++t) s += pp[(size_t)t * c];
    pooled[k] = s / (float)hw;
  }
  __syncthreads();
  float* out = hidden_part + ((size_t)b * gridDim.x + slice) * r;
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n; ++k) s += pooled[k] * w1[(size_t)(c0 + k) * r + j];
    out[j] = s;
  }
}

// grid (ceil(c / kThreads), B), block (kThreads), dynamic shared memory r floats
__global__ void se_excite(const float* __restrict__ hidden_part,
                          const float* __restrict__ w2, float* __restrict__ gate,
                          int c, int r, int n_slices) {
  extern __shared__ float hidden[];
  const int b = blockIdx.y;
  const float* hp = hidden_part + (size_t)b * n_slices * r;
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < n_slices; ++p) s += hp[(size_t)p * r + j];
    hidden[j] = gelu_erf(s);
  }
  __syncthreads();
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float s = 0.f;
  for (int j = 0; j < r; ++j) s += hidden[j] * w2[(size_t)j * c + ch];
  gate[(size_t)b * c + ch] = sigmoid(s);
}

// grid-stride over the n4 float4 elements of x
__global__ void se_apply(const float4* __restrict__ x,
                         const float4* __restrict__ gate,
                         float4* __restrict__ out, size_t n4, size_t per_sample4,
                         int c4) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const size_t b = i / per_sample4;
    const int cv = (int)(i % (size_t)c4);
    const float4 g = gate[b * c4 + cv];
    const float4 v = x[i];
    out[i] = make_float4(v.x * g.x, v.y * g.y, v.z * g.z, v.w * g.w);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Channels per squeeze slice: hidden_part holds ceil(c / se_slice()) slices.
int se_slice() { return kSlice; }

// x, out: [b, hw, c]; w1: [c, r]; w2: [r, c]; partial: [b, n_tiles, c];
// hidden_part: [b, ceil(c / se_slice()), r]; gate: [b, c]. All fp32,
// contiguous, 16-byte aligned; c % 4 == 0; r * 4 bytes of shared memory.
int se_block_forward(const float* x, const float* w1, const float* w2,
                     float* out, float* partial, float* hidden_part, float* gate,
                     int b, int hw, int c, int r, int tile_pixels, int n_tiles,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c4 = c / 4;
  const int n_slices = (c + kSlice - 1) / kSlice;
  if ((size_t)r * sizeof(float) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 pool_grid(n_tiles, (c4 + kTX - 1) / kTX, b);
  se_pool_partial<<<pool_grid, dim3(kTX, kTY), 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(partial),
      hw, c4, tile_pixels, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  se_squeeze<<<dim3(n_slices, b), kThreads, 0, s>>>(partial, w1, hidden_part, hw,
                                                    c, r, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  se_excite<<<dim3((c + kThreads - 1) / kThreads, b), kThreads,
              (size_t)r * sizeof(float), s>>>(hidden_part, w2, gate, c, r,
                                              n_slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t per_sample4 = (size_t)hw * c4;
  const size_t n4 = per_sample4 * b;
  const size_t want = (n4 + 255) / 256;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  se_apply<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(x),
                                  reinterpret_cast<const float4*>(gate),
                                  reinterpret_cast<float4*>(out), n4,
                                  per_sample4, c4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
