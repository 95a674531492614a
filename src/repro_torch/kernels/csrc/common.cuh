// Shared helpers for the attention kernels: 16-byte vector loads that widen
// to float, and the store back to the working type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Element types, as the Python wrappers number them.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // floats per 16-byte load
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;  // bf16 values per 16-byte load
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T>
__device__ inline T from_float(float x);

template <>
__device__ inline float from_float<float>(float x) { return x; }

template <>
__device__ inline __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kMaxDevices = 64;

// Let kernel `kern` use `bytes` of dynamic shared memory on the current
// device.  `allowed` is the kernel's own table of the bound set so far on
// each device (a static of its launcher), so the attribute is set once per
// kernel, device and bound, not on every launch: it is a host call on the
// launch path.
inline cudaError_t allow_smem(const void* kern, size_t bytes,
                              size_t* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace repro_torch
