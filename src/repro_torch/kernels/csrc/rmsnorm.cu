// Fused RMSNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (_rmsnorm_kernel, launched
// by rmsnorm): y = x * rsqrt(mean(x^2, -1) + eps) * w, fp32 arithmetic whatever
// the input type, output in x's type.
//
// Bound on this card: bytes.  Each element of x is read once and written once
// and only ~4 flops are spent on it, far below the ~295 flop/byte at which the
// tensor cores would become the limit.  The design therefore only tries to
// keep loads wide and the card full:
//   * 16-byte loads and stores whenever d and the pointers allow it, scalar
//     loads otherwise (d need not be a power of two, rows need not be a
//     multiple of anything);
//   * d <= 1024: one warp per row, eight rows per block, so the per-head
//     qk-norm shape (d = head_dim = 128) does not spend a block on 128 values;
//     the reduction is pure warp shuffles;
//   * d  > 1024: one block per row, the sum of squares goes warp shuffle ->
//     shared memory -> every thread; the second pass re-reads the row, which
//     is a few KB and still sits in L1.
// Nothing is carried between rows, so the grid is simply the rows.
// At the decode shape (4 rows of 3584) the kernel runs ~2 us and the call is bound
// by the host's launch path instead, which decode pays 57 times a step: the C entry
// takes its arguments as one block (RmsnormCall) and the device and raw stream as
// plain values, so the Python wrapper builds no objects for them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rmsnorm.cuh"

namespace {

using rmsnorm::DeviceGuard;
using rmsnorm::from_f;
using rmsnorm::Pack;
using rmsnorm::to_f;
using rmsnorm::warp_sum;

// Sum of squares of the elements first, first+step, ... of one row, VEC at a time.
template <typename T, int VEC>
__device__ __forceinline__ float partial_sumsq(const T* xr, int d, int first, int step) {
  float ss = 0.f;
  for (int i = first * VEC; i < d; i += step * VEC) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float f = to_f<T>(p.v[j]);
      ss += f * f;
    }
  }
  return ss;
}

template <typename T, typename WT, int VEC>
__device__ __forceinline__ void scale_row(const T* xr, const WT* w, T* yr, int d, float r,
                                          int first, int step) {
  for (int i = first * VEC; i < d; i += step * VEC) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out.v[j] = from_f<T>(to_f<T>(p.v[j]) * r * to_f<WT>(w[i + j]));
    *reinterpret_cast<Pack<T, VEC>*>(yr + i) = out;
  }
}

// d <= 1024: a warp per row.
template <typename T, typename WT, int VEC>
__global__ void rmsnorm_warp_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                                    T* __restrict__ y, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together; no block barrier below
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = warp_sum(partial_sumsq<T, VEC>(xr, d, lane, 32));
  float r = 1.0f / sqrtf(ss / (float)d + eps);
  scale_row<T, WT, VEC>(xr, w, yr, d, r, lane, 32);
}

// d > 1024: a block per row.
template <typename T, typename WT, int VEC>
__global__ void rmsnorm_block_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                                     T* __restrict__ y, int rows, int d, float eps) {
  __shared__ float warp_part[32];
  __shared__ float total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = warp_sum(partial_sumsq<T, VEC>(xr, d, tid, blockDim.x));
  if (lane == 0) warp_part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < nwarps ? warp_part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) total = v;
  }
  __syncthreads();
  float r = 1.0f / sqrtf(total / (float)d + eps);
  scale_row<T, WT, VEC>(xr, w, yr, d, r, tid, blockDim.x);
}

template <typename T, typename WT, int VEC>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d, float eps,
                   cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const WT* wp = static_cast<const WT*>(w);
  T* yp = static_cast<T*>(y);
  if (d <= 1024) {
    const int rows_per_block = 8;
    dim3 grid((rows + rows_per_block - 1) / rows_per_block);
    rmsnorm_warp_kernel<T, WT, VEC><<<grid, rows_per_block * 32, 0, st>>>(xp, wp, yp, rows, d, eps);
  } else {
    int threads = ((d + VEC - 1) / VEC + 31) / 32 * 32;
    if (threads > 512) threads = 512;
    rmsnorm_block_kernel<T, WT, VEC><<<dim3(rows), threads, 0, st>>>(xp, wp, yp, rows, d, eps);
  }
  return cudaGetLastError();
}

template <typename T, typename WT>
cudaError_t launch_vec(const void* x, const void* w, void* y, int rows, int d, float eps,
                       cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool wide = d % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (wide) return launch<T, WT, VEC>(x, w, y, rows, d, eps, st);
  return launch<T, WT, 1>(x, w, y, rows, d, eps, st);
}

template <typename T>
int launch_w(const void* x, const void* w, void* y, int rows, int d, float eps, int x_dtype,
             int w_dtype, cudaStream_t st) {
  if (w_dtype == x_dtype) return (int)launch_vec<T, T>(x, w, y, rows, d, eps, st);
  if (w_dtype == 0) return (int)launch_vec<T, float>(x, w, y, rows, d, eps, st);
  return -2;
}

}  // namespace

// One call's arguments, passed as one block: at the decode shape the kernel runs
// for ~2 us, and converting ten separate ctypes arguments cost about as much.
// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  w is in x's type or float32.
// The kernel goes to `stream` of CUDA device `device` (made current only if it is not).
struct RmsnormCall {
  const void* x;
  const void* w;
  void* y;
  void* stream;
  int rows;
  int d;
  float eps;
  int x_dtype;
  int w_dtype;
  int device;
};

// Returns 0, a cudaError_t (> 0) from the launch, or -2 for a type pair it does not take.
extern "C" int repro_rmsnorm_fwd(const RmsnormCall* c) {
  if (c->rows <= 0 || c->d <= 0) return 0;
  DeviceGuard guard(c->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  switch (c->x_dtype) {
    case 0: return launch_w<float>(c->x, c->w, c->y, c->rows, c->d, c->eps, 0, c->w_dtype, st);
    case 1:
      return launch_w<__nv_bfloat16>(c->x, c->w, c->y, c->rows, c->d, c->eps, 1, c->w_dtype, st);
    case 2: return launch_w<__half>(c->x, c->w, c->y, c->rows, c->d, c->eps, 2, c->w_dtype, st);
    default: return -2;
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
