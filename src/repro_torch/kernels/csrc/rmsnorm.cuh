// Shared between the fused RMSNorm forward (rmsnorm.cu) and backward (rmsnorm_bwd.cu):
// element conversions, 16-byte packs, the warp sum and the device guard.
//
// Both replace the TPU kernel src/repro/kernels/rmsnorm.py (_rmsnorm_kernel, and the
// gradient JAX takes of its formula).  Bound on this card: bytes (see rmsnorm.cu);
// nothing here moves data.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace rmsnorm {
namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

template <typename T, int N> struct alignas(sizeof(T) * N) Pack { T v[N]; };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Makes `dev` the current device for the lifetime of the guard when it is not
// already (the runtime launches on the current device).
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int dev) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != dev) {
      err = cudaSetDevice(dev);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace
}  // namespace rmsnorm
