// Shared helpers of the port's CUDA kernels: element type conversions, warp
// reductions, the launchers' shared-memory opt-in and the head-dim dispatch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace mk {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round to nearest even, as XLA's f32 -> bf16 convert
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, back in fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The opt-in to more than 48 KB of dynamic shared memory, set once per
// kernel and device rather than at every launch (the call costs more than a
// small launch). A launcher keeps one static record per kernel; a larger size
// than any set before sets it again. The record names its kernel, since the
// static of an inline launcher may be shared with another library's copy. A
// second setting from a racing thread is harmless.
struct SmemOptIn {
  static constexpr int kMaxDevices = 64;
  const void* kernel[kMaxDevices] = {};
  size_t bytes[kMaxDevices] = {};

  int ensure(const void* fn, size_t need) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (kernel[dev] == fn && bytes[dev] >= need) return 0;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err != cudaSuccess) return (int)err;
    kernel[dev] = fn;
    bytes[dev] = need;
    return 0;
  }
};

// The instances of the attention kernels (K1, K3, K4, K5, K6, K7): tile
// widths 32, 64, 80, 128, 192 and 256 bf16 (or fp32) columns, and past 256
// the deep route. ops/_build.py::HEAD_DIMS mirrors this list. A head dim d of
// 8 to 256, a multiple of 8 (the wrappers copy any other into a zero-padded
// buffer first, K6's int8 cache to a multiple of 16), runs on the smallest
// instance DP >= d: the tiles' columns d .. DP - 1 are zeros (TMA fills them,
// or the loads skip them), which add nothing to any product, and the stores
// skip them. Any d past 256 (a multiple of 8) runs on the deep route, DEEP:
// the head dim streams through the products in chunks of DEEP_CHUNK columns
// (NK = ceil(d / DEEP_CHUNK) of them, the last zero-filled past d) and each
// output's columns split into blocks of DEEP_CHUNK over the grid, so that a
// CTA's shared memory and registers are those of one chunk, whatever d.
// Calls f with std::integral_constant<int, DP> (DEEP past 256), or returns
// cudaErrorInvalidValue for any other d; the kernels take d itself as an
// argument.
constexpr int DEEP = 0;            // the instance tag of the deep route
constexpr int DEEP_CHUNK = 128;    // its chunk width (columns)
constexpr int MAX_INSTANCE = 256;  // the widest tile instance

__host__ __device__ constexpr int deep_chunks(int d) { return (d + DEEP_CHUNK - 1) / DEEP_CHUNK; }

template <typename F>
int with_head_dim(int d, F&& f) {
  if (d < 8 || d % 8) return (int)cudaErrorInvalidValue;
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 80) return f(std::integral_constant<int, 80>{});
  if (d <= 128) return f(std::integral_constant<int, 128>{});
  if (d <= 192) return f(std::integral_constant<int, 192>{});
  if (d <= MAX_INSTANCE) return f(std::integral_constant<int, 256>{});
  return f(std::integral_constant<int, DEEP>{});
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A softmax row's running max m and sum l of exp(w - m), merged with another
// part's (m2, l2): the larger max kept, each sum rescaled to it. Two empty
// parts (both maxes -inf) stay empty. The first pass of the score-chunked
// attention routes (K6, K7) reduces each row so, a key or a part at a time.
__device__ __forceinline__ void softmax_merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -CUDART_INF_F) return;
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

}  // namespace mk
