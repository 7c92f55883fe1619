// Squeeze-excitation for Hopper (sm_90a), NHWC, x in fp32 or bf16.
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
// Types: x and out are float or __nv_bfloat16 (the launches below are
// templated on it); weights, partial sums, the hidden vector and the gate
// are fp32. In bf16 the kernel computes what the Pallas kernel computes on
// bf16 x: fp32 pooling and MLP, the gate rounded to bf16
// (__float2bfloat16_rn), and out = bf16(float(x) * float(gate)), a product
// that is exact in fp32 before its one rounding. A thread reads and writes
// x 16 bytes at a time: 4 fp32 or 8 bf16 channels (the wrapper requires
// C % 4 or C % 8 and 16-byte alignment). bf16 halves the bytes and so the
// bound.
//
// Determinism: no atomics; every sum runs in a fixed order, so a sample's
// output does not depend on the other samples of its batch or on the run.
// GELU is the exact erf form, as in the JAX module and its XLA twin (the
// Pallas kernel used the tanh form).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTX = 16;  // threads across 16-byte channel vectors (64 fp32 / 128 bf16 channels)
constexpr int kTY = 16;  // threads across pixels
constexpr int kSlice = 64;  // channels per se_squeeze block
constexpr int kThreads = 256;

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

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// grid (n_tiles, ceil(cv / kTX), B), block (kTX, kTY); cv = C / Vec<T>::n
// vectors per pixel. partial [B, n_tiles, C] fp32.
template <typename T>
__global__ void se_pool_partial(const typename Vec<T>::type* __restrict__ x,
                                float* __restrict__ partial, int hw, int cv_n,
                                int tile_pixels, int n_tiles) {
  constexpr int N = Vec<T>::n;
  const int tile = blockIdx.x;
  const int cv = blockIdx.y * kTX + threadIdx.x;
  const int b = blockIdx.z;
  const int p0 = tile * tile_pixels;
  const int p1 = min(p0 + tile_pixels, hw);
  float acc[N] = {};
  if (cv < cv_n) {
    const typename Vec<T>::type* xb = x + (size_t)b * hw * cv_n + cv;
    for (int p = p0 + threadIdx.y; p < p1; p += kTY) {
      float f[N];
      Vec<T>::widen(xb[(size_t)p * cv_n], f);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += f[i];
    }
  }
  __shared__ float red[kTY][kTX][N];
#pragma unroll
  for (int i = 0; i < N; ++i) red[threadIdx.y][threadIdx.x][i] = acc[i];
  __syncthreads();
  if (threadIdx.y == 0 && cv < cv_n) {
    float s[N];
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = red[0][threadIdx.x][i];
    for (int j = 1; j < kTY; ++j)
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] += red[j][threadIdx.x][i];
    float4* o = reinterpret_cast<float4*>(
        partial + ((size_t)b * n_tiles + tile) * cv_n * N + (size_t)cv * N);
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      o[k] = make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
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

// grid (ceil(c / kThreads), B), block (kThreads), dynamic shared memory r
// floats. With round_bf16 the gate is rounded to bf16 (kept as fp32).
__global__ void se_excite(const float* __restrict__ hidden_part,
                          const float* __restrict__ w2, float* __restrict__ gate,
                          int c, int r, int n_slices, int round_bf16) {
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
  const float g = sigmoid(s);
  gate[(size_t)b * c + ch] = round_bf16 ? __bfloat162float(__float2bfloat16_rn(g)) : g;
}

// grid-stride over the nv 16-byte vectors of x
template <typename T>
__global__ void se_apply(const typename Vec<T>::type* __restrict__ x,
                         const float* __restrict__ gate,
                         typename Vec<T>::type* __restrict__ out, size_t nv,
                         size_t per_sample_v, int cv_n) {
  constexpr int N = Vec<T>::n;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nv; i += stride) {
    const size_t b = i / per_sample_v;
    const int cv = (int)(i % (size_t)cv_n);
    const float4* g4 = reinterpret_cast<const float4*>(gate + (b * cv_n + cv) * N);
    float f[N];
    Vec<T>::widen(x[i], f);
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 g = g4[k];
      f[4 * k] *= g.x;
      f[4 * k + 1] *= g.y;
      f[4 * k + 2] *= g.z;
      f[4 * k + 3] *= g.w;
    }
    out[i] = Vec<T>::narrow(f);
  }
}

template <typename T>
int forward(const T* x, const float* w1, const float* w2, T* out,
            float* partial, float* hidden_part, float* gate, int b, int hw,
            int c, int r, int tile_pixels, int n_tiles, void* stream) {
  using V = typename Vec<T>::type;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cv_n = c / Vec<T>::n;
  const int n_slices = (c + kSlice - 1) / kSlice;
  if ((size_t)r * sizeof(float) > 48 * 1024 || c % Vec<T>::n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 pool_grid(n_tiles, (cv_n + kTX - 1) / kTX, b);
  se_pool_partial<T><<<pool_grid, dim3(kTX, kTY), 0, s>>>(
      reinterpret_cast<const V*>(x), partial, hw, cv_n, tile_pixels, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  se_squeeze<<<dim3(n_slices, b), kThreads, 0, s>>>(partial, w1, hidden_part, hw,
                                                    c, r, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  se_excite<<<dim3((c + kThreads - 1) / kThreads, b), kThreads,
              (size_t)r * sizeof(float), s>>>(hidden_part, w2, gate, c, r,
                                              n_slices, Vec<T>::n == 8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t per_sample_v = (size_t)hw * cv_n;
  const size_t nv = per_sample_v * b;
  const size_t want = (nv + 255) / 256;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  se_apply<T><<<blocks, 256, 0, s>>>(reinterpret_cast<const V*>(x), gate,
                                     reinterpret_cast<V*>(out), nv,
                                     per_sample_v, cv_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Channels per squeeze slice: hidden_part holds ceil(c / se_slice()) slices.
int se_slice() { return kSlice; }

// x, out: [b, hw, c]; w1: [c, r]; w2: [r, c]; partial: [b, n_tiles, c];
// hidden_part: [b, ceil(c / se_slice()), r]; gate: [b, c]. x and out fp32
// (se_block_forward) or bf16 (se_block_forward_bf16), the rest fp32; all
// contiguous and 16-byte aligned; c % 4 == 0 (fp32) or c % 8 == 0 (bf16);
// r * 4 bytes of shared memory.
int se_block_forward(const float* x, const float* w1, const float* w2,
                     float* out, float* partial, float* hidden_part, float* gate,
                     int b, int hw, int c, int r, int tile_pixels, int n_tiles,
                     void* stream) {
  return forward<float>(x, w1, w2, out, partial, hidden_part, gate, b, hw, c,
                        r, tile_pixels, n_tiles, stream);
}

int se_block_forward_bf16(const __nv_bfloat16* x, const float* w1,
                          const float* w2, __nv_bfloat16* out, float* partial,
                          float* hidden_part, float* gate, int b, int hw,
                          int c, int r, int tile_pixels, int n_tiles,
                          void* stream) {
  return forward<__nv_bfloat16>(x, w1, w2, out, partial, hidden_part, gate, b,
                                hw, c, r, tile_pixels, n_tiles, stream);
}

}  // extern "C"
