// Fused RMSNorm backward for Hopper (sm_90a), plain C interface.
//
// Replaces the gradient of the TPU kernel src/repro/kernels/rmsnorm.py
// (_rmsnorm_kernel): the Pallas kernel has no VJP, and the reference differentiates
// the formula y = x * r * w with r = rsqrt(mean(x^2, -1) + eps) instead.  Per row,
// with fp32 arithmetic whatever the input type:
//   dx = r * (w o dy) - x * r^3 * mean(x o w o dy)        (in x's type)
//   dw = sum over rows of x * r o dy                      (in w's type)
// r is recomputed from x (the forward stores nothing but y).
//
// Bound on this card: bytes.  x and dy are read and dx written once (~10 flops an
// element), far below the ~295 flop/byte ridge.  What the design does:
//   * rows wider than 1024 (d_model: the training path's shape) take the row
//     pipeline: a block per worker, each thread owning the same PPT 16-byte packs of
//     every row of the worker's run.  Its packs of x and dy stay in registers from
//     the two row sums to dx (no second read), the next row's packs are loaded before
//     the current row is reduced (two rows in flight per thread), the two sums (x^2
//     and x*w*dy) go through one barrier a row (the warps' partials in double-buffered
//     shared slots, summed by every thread in warp order), and w's packs and the dw
//     partial stay in registers across the run;
//   * rows of at most 1024 take the forward's layout (rmsnorm.cu): a warp per row,
//     the dw partial in shared memory, the second pass re-reading the row from L1
//     (as do rows too wide for the pipeline's registers, a block per row);
//   * dw without atomics, in a fixed order: each worker (warp or block) takes a
//     contiguous run of rows, writes its dw partial once as one row of an fp32
//     partials buffer, and a second small kernel sums the partials column by column
//     in worker order.  The result does not depend on the timing of the blocks, so
//     dx and dw are the same bit for bit from run to run.

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

constexpr int kWarpsPerBlock = 8;    // workers of a block when a warp takes a row
constexpr int kMaxBlockThreads = 512;
constexpr int kMaxPacksPerThread = 4;  // the row pipeline's reach: 2048 packs a row

// One worker's rows: thread `tw` of `nt` owns the VEC-packs tw, tw + nt, ... of d.
// WARP: the worker is warp `threadIdx.x / 32` of the block; else the whole block.
template <typename T, typename WT, int VEC, bool WARP>
__global__ void rmsnorm_bwd_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                                   const T* __restrict__ dy, T* __restrict__ dx,
                                   float* __restrict__ partial, int rows, int d, float eps,
                                   int rows_per_worker) {
  extern __shared__ float sdw[];  // one row of d floats per worker of the block
  __shared__ float red[2][32];
  __shared__ float tot[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tw = WARP ? lane : threadIdx.x;
  const int nt = WARP ? 32 : blockDim.x;
  const long long worker = WARP ? (long long)blockIdx.x * kWarpsPerBlock + warp : blockIdx.x;
  float* acc = sdw + (WARP ? warp * d : 0);
  for (int i = tw * VEC; i < d; i += nt * VEC)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i + j] = 0.f;

  const long long r_lo = worker * rows_per_worker;
  const long long r_hi = min((long long)rows, r_lo + rows_per_worker);
  for (long long row = r_lo; row < r_hi; ++row) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float ss = 0.f, sg = 0.f;
    for (int i = tw * VEC; i < d; i += nt * VEC) {
      Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
      Pack<T, VEC> pg = *reinterpret_cast<const Pack<T, VEC>*>(gr + i);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f<T>(px.v[j]);
        ss += xf * xf;
        sg += xf * to_f<WT>(w[i + j]) * to_f<T>(pg.v[j]);
      }
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    if (!WARP) {  // every thread of the block runs the same rows: the barriers are uniform
      if (lane == 0) {
        red[0][warp] = ss;
        red[1][warp] = sg;
      }
      __syncthreads();
      if (warp == 0) {
        const int nw = blockDim.x >> 5;
        float a = lane < nw ? red[0][lane] : 0.f, c = lane < nw ? red[1][lane] : 0.f;
        a = warp_sum(a);
        c = warp_sum(c);
        if (lane == 0) {
          tot[0] = a;
          tot[1] = c;
        }
      }
      __syncthreads();
      ss = tot[0];
      sg = tot[1];
    }
    const float r = 1.0f / sqrtf(ss / (float)d + eps);
    const float c = r * r * r * (sg / (float)d);
    T* dr = dx + row * d;
    for (int i = tw * VEC; i < d; i += nt * VEC) {
      Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
      Pack<T, VEC> pg = *reinterpret_cast<const Pack<T, VEC>*>(gr + i);
      Pack<T, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f<T>(px.v[j]), gf = to_f<T>(pg.v[j]);
        out.v[j] = from_f<T>(r * to_f<WT>(w[i + j]) * gf - xf * c);
        acc[i + j] += xf * r * gf;
      }
      *reinterpret_cast<Pack<T, VEC>*>(dr + i) = out;
    }
  }
  float* pr = partial + worker * d;
  for (int i = tw * VEC; i < d; i += nt * VEC)
#pragma unroll
    for (int j = 0; j < VEC; ++j) pr[i + j] = acc[i + j];
}

// The row pipeline: a block per worker; thread tw owns packs tw + k * blockDim.x
// (k < PPT) of every row, and keeps them, w's and its dw partial in registers.
template <typename T, typename WT, int VEC, int PPT>
__global__ void __launch_bounds__(kMaxBlockThreads)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ partial, int rows, int d, float eps,
                            int rows_per_worker) {
  __shared__ float red[2][2][kMaxBlockThreads / 32];  // [row parity][sum][warp]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int packs = d / VEC;
  int col[PPT];
  bool has[PPT];
  float wf[PPT][VEC], acc[PPT][VEC];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    has[k] = i < packs;
    col[k] = i * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      wf[k][j] = has[k] ? to_f<WT>(w[col[k] + j]) : 0.f;
      acc[k][j] = 0.f;
    }
  }
  using P = Pack<T, VEC>;
  P cx[PPT], cg[PPT], nx[PPT], ng[PPT];
  auto load = [&](long long row, P (&px)[PPT], P (&pg)[PPT]) {
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      if (has[k]) {
        px[k] = *reinterpret_cast<const P*>(x + row * d + col[k]);
        pg[k] = *reinterpret_cast<const P*>(dy + row * d + col[k]);
      }
  };
  const long long r_lo = (long long)blockIdx.x * rows_per_worker;
  const long long r_hi = min((long long)rows, r_lo + rows_per_worker);
  if (r_lo < r_hi) load(r_lo, cx, cg);
  for (long long row = r_lo; row < r_hi; ++row) {
    const int buf = (int)((row - r_lo) & 1);
    if (row + 1 < r_hi) load(row + 1, nx, ng);  // in flight across this row's barrier
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      if (has[k])
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xf = to_f<T>(cx[k].v[j]);
          ss += xf * xf;
          sg += xf * wf[k][j] * to_f<T>(cg[k].v[j]);
        }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    if (lane == 0) {
      red[buf][0][warp] = ss;
      red[buf][1][warp] = sg;
    }
    // One barrier a row: row i + 2 writes this buffer again only after every thread
    // has passed row i + 1's barrier, so after every thread has read it here.
    __syncthreads();
    ss = 0.f;
    sg = 0.f;
    for (int i = 0; i < nw; ++i) {
      ss += red[buf][0][i];
      sg += red[buf][1][i];
    }
    const float r = 1.0f / sqrtf(ss / (float)d + eps);
    const float c = r * r * r * (sg / (float)d);
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      if (has[k]) {
        P out;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xf = to_f<T>(cx[k].v[j]), gf = to_f<T>(cg[k].v[j]);
          out.v[j] = from_f<T>(r * wf[k][j] * gf - xf * c);
          acc[k][j] += xf * r * gf;
        }
        *reinterpret_cast<P*>(dx + row * d + col[k]) = out;
      }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      cx[k] = nx[k];
      cg[k] = ng[k];
    }
  }
  float* pr = partial + (long long)blockIdx.x * d;
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    if (has[k])
#pragma unroll
      for (int j = 0; j < VEC; ++j) pr[col[k] + j] = acc[k][j];
}

// dw[col] = the partials' column sum, in worker order.
template <typename WT>
__global__ void rmsnorm_dw_sum_kernel(const float* __restrict__ partial, WT* __restrict__ dw,
                                      int workers, int d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
#pragma unroll 8
  for (int i = 0; i < workers; ++i) s += partial[(long long)i * d + col];
  dw[col] = from_f<WT>(s);
}

template <typename T, typename WT, int VEC>
cudaError_t launch(const void* x, const void* w, const void* dy, void* dx, void* dw,
                   float* partial, int rows, int d, float eps, int workers, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const WT* wp = static_cast<const WT*>(w);
  const T* gp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  const int rows_per_worker = (rows + workers - 1) / workers;
  cudaError_t e;
  if (d <= 1024) {
    auto kern = rmsnorm_bwd_kernel<T, WT, VEC, true>;
    const int smem = kWarpsPerBlock * d * (int)sizeof(float);  // <= 32 KB
    kern<<<workers / kWarpsPerBlock, kWarpsPerBlock * 32, smem, st>>>(
        xp, wp, gp, dxp, partial, rows, d, eps, rows_per_worker);
  } else if (d / VEC <= kMaxPacksPerThread * kMaxBlockThreads) {
    const int packs = d / VEC;
    const int ppt = packs <= kMaxBlockThreads ? 1 : packs <= 2 * kMaxBlockThreads ? 2 : 4;
    const int threads = ((packs + ppt - 1) / ppt + 31) / 32 * 32;
    auto kern = ppt == 1   ? rmsnorm_bwd_rows_kernel<T, WT, VEC, 1>
                : ppt == 2 ? rmsnorm_bwd_rows_kernel<T, WT, VEC, 2>
                           : rmsnorm_bwd_rows_kernel<T, WT, VEC, 4>;
    kern<<<workers, threads, 0, st>>>(xp, wp, gp, dxp, partial, rows, d, eps, rows_per_worker);
  } else {
    auto kern = rmsnorm_bwd_kernel<T, WT, VEC, false>;
    const int smem = d * (int)sizeof(float);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    int threads = ((d + VEC - 1) / VEC + 31) / 32 * 32;
    if (threads > kMaxBlockThreads) threads = kMaxBlockThreads;
    kern<<<workers, threads, smem, st>>>(xp, wp, gp, dxp, partial, rows, d, eps,
                                         rows_per_worker);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_dw_sum_kernel<WT><<<(d + 255) / 256, 256, 0, st>>>(partial, static_cast<WT*>(dw),
                                                           workers, d);
  return cudaGetLastError();
}

template <typename T, typename WT>
cudaError_t launch_vec(const void* x, const void* w, const void* dy, void* dx, void* dw,
                       float* partial, int rows, int d, float eps, int workers, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool wide = d % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (wide) return launch<T, WT, VEC>(x, w, dy, dx, dw, partial, rows, d, eps, workers, st);
  return launch<T, WT, 1>(x, w, dy, dx, dw, partial, rows, d, eps, workers, st);
}

}  // namespace

// One backward call's arguments.  dtype codes: 0 = float32, 1 = bfloat16, 2 = float16;
// dy and dx in x's type, dw in w's (x's type or float32).  `partial` is a float32
// scratch of `workers` rows of d; workers is a multiple of 8 when d <= 1024 (a warp per
// worker, eight to a block).  All tensors contiguous.
struct RmsnormBwdCall {
  const void* x;
  const void* w;
  const void* dy;
  void* dx;
  void* dw;
  void* partial;
  void* stream;
  int rows;
  int d;
  float eps;
  int workers;
  int x_dtype;
  int w_dtype;
  int device;
};

// Returns 0, a cudaError_t (> 0) from a launch, -2 for a type pair it does not take,
// -5 for a worker count or row width the kernels cannot take.
extern "C" int repro_rmsnorm_bwd(const RmsnormBwdCall* c) {
  if (c->rows <= 0 || c->d <= 0) return 0;
  if (c->workers <= 0 || (c->d <= 1024 && c->workers % kWarpsPerBlock) ||
      c->d > 227 * 1024 / 4 - 64)
    return -5;
  DeviceGuard guard(c->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  float* part = static_cast<float*>(c->partial);
#define REPRO_RMS_BWD(T, WT)                                                              \
  (int)launch_vec<T, WT>(c->x, c->w, c->dy, c->dx, c->dw, part, c->rows, c->d, c->eps, \
                         c->workers, st)
  const bool same = c->w_dtype == c->x_dtype, wf32 = c->w_dtype == 0;
  switch (c->x_dtype) {
    case 0:
      return same ? REPRO_RMS_BWD(float, float) : -2;
    case 1:
      if (same) return REPRO_RMS_BWD(__nv_bfloat16, __nv_bfloat16);
      return wf32 ? REPRO_RMS_BWD(__nv_bfloat16, float) : -2;
    case 2:
      if (same) return REPRO_RMS_BWD(__half, __half);
      return wf32 ? REPRO_RMS_BWD(__half, float) : -2;
    default:
      return -2;
  }
#undef REPRO_RMS_BWD
}
