// Fused RMSNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (_rmsnorm_kernel, launched
// by rmsnorm): y = x * rsqrt(mean(x^2, -1) + eps) * w, fp32 arithmetic whatever
// the input type, output in x's type.
//
// Bound on this card: bytes.  Each element of x is read once and written once
// and only ~4 flops are spent on it, far below the ~295 flop/byte at which the
// tensor cores would become the limit.  So the design reads x exactly once, keeps
// enough 16-byte loads in flight to cover the memory's latency, and spends no
// instruction or barrier it can avoid (the backward's design, rmsnorm_bwd.cu):
//   * rows wider than 1024 in whole 16-byte packs (d_model: 2048-6144 on the
//     paths) take the row pipeline: persistent workers, a block each, walking the
//     rows with a grid stride.  Each thread owns the same PPT packs of every row,
//     so its packs of x stay in registers from the sum of squares to the scaled
//     store (no second read); w's packs are loaded once, as packs, and kept across
//     the run; the next row's packs are loaded before the current row is reduced
//     (two rows in flight per thread); one barrier a row, the warps' partial sums
//     in double-buffered shared slots that every thread sums in warp order;
//   * rows of at most 1024 in whole packs (q/k-norm's 128, whisper's 1024) take a
//     group of G lanes a row (G * PPL >= d / VEC packs: 16 lanes at d = 128 in
//     bf16, two rows a warp), the sum by shuffles within the group; w in registers,
//     rows walked with a grid stride, the next row loaded ahead;
//   * rows wider than the pipeline's reach take a block a row, and widths that are
//     not a multiple of the pack (or unaligned pointers) the scalar kernels: a warp
//     a row up to 1024, a block a row above.  Their second pass re-reads the row
//     from L1.
// The persistent grids hold as many blocks as fit on the card at once (the
// occupancy query, made once per kernel and block size).  At the decode shape (4
// rows of 3584) the kernel runs ~2 us and the call is bound by the host's launch
// path instead, which decode pays 57 times a step: the C entry takes its arguments
// as one block (RmsnormCall) and the device and raw stream as plain values, so the
// Python wrapper builds no objects for them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "rmsnorm.cuh"

namespace {

using rmsnorm::DeviceGuard;
using rmsnorm::from_f;
using rmsnorm::Pack;
using rmsnorm::to_f;
using rmsnorm::warp_sum;

constexpr int kGroupThreads = 256;     // threads a block of the lane-group kernel
constexpr int kMaxBlockThreads = 512;
constexpr int kMaxPacksPerThread = 4;  // the row pipeline's reach: 2048 packs a row

// ------------------------------------------------------------- scalar kernels

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

// Scalar, d <= 1024: a warp per row.
template <typename T, typename WT>
__global__ void rmsnorm_warp_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                                    T* __restrict__ y, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together; no block barrier below
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = warp_sum(partial_sumsq<T, 1>(xr, d, lane, 32));
  float r = 1.0f / sqrtf(ss / (float)d + eps);
  scale_row<T, WT, 1>(xr, w, yr, d, r, lane, 32);
}

// Scalar rows wider than 1024, and rows in packs past the pipeline's reach: a block
// per row.
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

// ------------------------------------------------------ kernels in 16-byte packs

// w[0, VEC) as floats, read as 16-byte packs (w in x's type: one; float beside a
// 16-bit x: two).
template <typename WT, int VEC>
__device__ __forceinline__ void load_w(const WT* w, float (&wf)[VEC]) {
  constexpr int kPer = 16 / sizeof(WT);
#pragma unroll
  for (int c = 0; c < VEC / kPer; ++c) {
    const Pack<WT, kPer> pw = *reinterpret_cast<const Pack<WT, kPer>*>(w + c * kPer);
#pragma unroll
    for (int j = 0; j < kPer; ++j) wf[c * kPer + j] = to_f<WT>(pw.v[j]);
  }
}

// A thread's packs of one row: the ones where has[k] holds, at columns col[k].
template <typename T, int VEC, int N>
__device__ __forceinline__ void load_row(const T* xr, const int (&col)[N], const bool (&has)[N],
                                         Pack<T, VEC> (&px)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (has[k]) px[k] = *reinterpret_cast<const Pack<T, VEC>*>(xr + col[k]);
}

template <typename T, int VEC, int N>
__device__ __forceinline__ float sumsq(const Pack<T, VEC> (&px)[N], const bool (&has)[N]) {
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (has[k])
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f<T>(px[k].v[j]);
        ss += f * f;
      }
  return ss;
}

template <typename T, int VEC, int N>
__device__ __forceinline__ void store_row(T* yr, const Pack<T, VEC> (&px)[N],
                                          const float (&wf)[N][VEC], const int (&col)[N],
                                          const bool (&has)[N], float r) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (has[k]) {
      Pack<T, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j) out.v[j] = from_f<T>(to_f<T>(px[k].v[j]) * r * wf[k][j]);
      *reinterpret_cast<Pack<T, VEC>*>(yr + col[k]) = out;
    }
}

// Thread `tw` of `nt` owns packs tw, tw + nt, ... (N of them) of every row; w's in wf.
template <typename WT, int VEC, int N>
__device__ __forceinline__ void own_packs(const WT* w, int packs, int tw, int nt, int (&col)[N],
                                          bool (&has)[N], float (&wf)[N][VEC]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = tw + k * nt;
    has[k] = i < packs;
    col[k] = i * VEC;
    if (has[k]) {
      load_w<WT, VEC>(w + col[k], wf[k]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) wf[k][j] = 0.f;
    }
  }
}

// d <= 1024: a group of G lanes a row, PPL packs a lane.  The loop runs over the
// warp's rows (32 / G at a time, a grid stride apart), so every lane of a warp takes
// part in every shuffle; a group past the last row computes nothing it stores.
template <typename T, typename WT, int VEC, int G, int PPL>
__global__ void __launch_bounds__(kGroupThreads)
    rmsnorm_group_kernel(const T* __restrict__ x, const WT* __restrict__ w, T* __restrict__ y,
                         int rows, int d, float eps) {
  using P = Pack<T, VEC>;
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  int col[PPL];
  bool has[PPL];
  float wf[PPL][VEC];
  own_packs<WT, VEC, PPL>(w, d / VEC, lane % G, G, col, has, wf);
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long stride = (((long long)gridDim.x * blockDim.x) >> 5) * kRowsPerWarp;
  const long long first = warp * kRowsPerWarp;  // the warp's first row
  const int grp = lane / G;
  P cur[PPL], nxt[PPL];
  if (first + grp < rows) load_row<T, VEC, PPL>(x + (first + grp) * d, col, has, cur);
  for (long long base = first; base < rows; base += stride) {
    const long long row = base + grp, next = row + stride;
    if (next < rows) load_row<T, VEC, PPL>(x + next * d, col, has, nxt);  // in flight
    float ss = row < rows ? sumsq<T, VEC, PPL>(cur, has) : 0.f;
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = 1.0f / sqrtf(ss / (float)d + eps);
    if (row < rows) store_row<T, VEC, PPL>(y + row * d, cur, wf, col, has, r);
#pragma unroll
    for (int k = 0; k < PPL; ++k) cur[k] = nxt[k];
  }
}

// d > 1024: the row pipeline, a block per worker; thread t owns packs t + k *
// blockDim.x (k < PPT) of every row.
template <typename T, typename WT, int VEC, int PPT>
__global__ void __launch_bounds__(kMaxBlockThreads)
    rmsnorm_rows_kernel(const T* __restrict__ x, const WT* __restrict__ w, T* __restrict__ y,
                        int rows, int d, float eps) {
  using P = Pack<T, VEC>;
  __shared__ float red[2][kMaxBlockThreads / 32];  // [row parity][warp]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int col[PPT];
  bool has[PPT];
  float wf[PPT][VEC];
  own_packs<WT, VEC, PPT>(w, d / VEC, threadIdx.x, blockDim.x, col, has, wf);
  P cur[PPT], nxt[PPT];
  long long row = blockIdx.x;
  if (row < rows) load_row<T, VEC, PPT>(x + row * d, col, has, cur);
  for (int it = 0; row < rows; row += gridDim.x, ++it) {
    const int buf = it & 1;
    if (row + gridDim.x < rows)  // in flight across this row's barrier
      load_row<T, VEC, PPT>(x + (row + gridDim.x) * d, col, has, nxt);
    const float part = warp_sum(sumsq<T, VEC, PPT>(cur, has));
    if (lane == 0) red[buf][warp] = part;
    // One barrier a row: row i + 2 writes this buffer again only after every thread
    // has passed row i + 1's barrier, so after every thread has read it here.
    __syncthreads();
    float ss = 0.f;
    for (int i = 0; i < nw; ++i) ss += red[buf][i];
    const float r = 1.0f / sqrtf(ss / (float)d + eps);
    store_row<T, VEC, PPT>(y + row * d, cur, wf, col, has, r);
#pragma unroll
    for (int k = 0; k < PPT; ++k) cur[k] = nxt[k];
  }
}

// ------------------------------------------------------------------------- host

// The number of SMs of device `dev`, read once per device.
cudaError_t sm_count(int dev, int& sms) {
  static std::atomic<int> cache[64];
  const bool cached = dev >= 0 && dev < 64;
  if (cached && (sms = cache[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && cached) cache[dev].store(sms, std::memory_order_relaxed);
  return e;
}

// Blocks of `threads` threads of Kern that one SM holds at once, asked once per
// kernel and block size (the last size asked is kept).
template <auto Kern>
cudaError_t resident_blocks(int threads, int& blocks) {
  static std::atomic<long long> cache{0};  // threads << 32 | blocks
  const long long c = cache.load(std::memory_order_relaxed);
  if ((int)(c >> 32) == threads) {
    blocks = (int)(c & 0xffffffff);
    return cudaSuccess;
  }
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kern, threads, 0);
  if (e != cudaSuccess) return e;
  if (blocks < 1) blocks = 1;
  cache.store((long long)threads << 32 | blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// Launch a persistent kernel on `threads`-thread blocks: as many as the card holds
// at once, and no more than `wanted`.
template <auto Kern, typename T, typename WT>
cudaError_t launch_persistent(int threads, long long wanted, int dev, const T* x, const WT* w,
                              T* y, int rows, int d, float eps, cudaStream_t st) {
  int sms = 0, per_sm = 0;
  cudaError_t e = sm_count(dev, sms);
  if (e == cudaSuccess) e = resident_blocks<Kern>(threads, per_sm);
  if (e != cudaSuccess) return e;
  const long long most = (long long)sms * per_sm;
  Kern<<<(unsigned)(wanted < most ? wanted : most), threads, 0, st>>>(x, w, y, rows, d, eps);
  return cudaGetLastError();
}

// Rows in whole 16-byte packs (VEC elements each).
template <typename T, typename WT, int VEC>
cudaError_t launch_packs(const T* x, const WT* w, T* y, int rows, int d, float eps, int dev,
                         cudaStream_t st) {
  const int packs = d / VEC;
  if (d <= 1024) {
#define REPRO_RMS_GROUP(G, PPL)                                                               \
  launch_persistent<rmsnorm_group_kernel<T, WT, VEC, G, PPL>>(                                \
      kGroupThreads, ((long long)rows + kGroupThreads / G - 1) / (kGroupThreads / G), dev, x, \
      w, y, rows, d, eps, st)
    if (packs <= 4) return REPRO_RMS_GROUP(4, 1);
    if (packs <= 8) return REPRO_RMS_GROUP(8, 1);
    if (packs <= 16) return REPRO_RMS_GROUP(16, 1);
    if (packs <= 32) return REPRO_RMS_GROUP(32, 1);
    if (packs <= 64) return REPRO_RMS_GROUP(32, 2);
    if (packs <= 128) return REPRO_RMS_GROUP(32, 4);
    return REPRO_RMS_GROUP(32, 8);  // fp32: up to 256 packs
#undef REPRO_RMS_GROUP
  }
  if (packs <= kMaxPacksPerThread * kMaxBlockThreads) {
    const int ppt = packs <= kMaxBlockThreads ? 1 : packs <= 2 * kMaxBlockThreads ? 2 : 4;
    const int threads = ((packs + ppt - 1) / ppt + 31) / 32 * 32;
    if (ppt == 1)
      return launch_persistent<rmsnorm_rows_kernel<T, WT, VEC, 1>>(threads, rows, dev, x, w, y,
                                                                     rows, d, eps, st);
    if (ppt == 2)
      return launch_persistent<rmsnorm_rows_kernel<T, WT, VEC, 2>>(threads, rows, dev, x, w, y,
                                                                     rows, d, eps, st);
    return launch_persistent<rmsnorm_rows_kernel<T, WT, VEC, 4>>(threads, rows, dev, x, w, y,
                                                                   rows, d, eps, st);
  }
  rmsnorm_block_kernel<T, WT, VEC><<<dim3(rows), kMaxBlockThreads, 0, st>>>(x, w, y, rows, d, eps);
  return cudaGetLastError();
}

template <typename T, typename WT>
cudaError_t launch_vec(const void* x, const void* w, void* y, int rows, int d, float eps,
                       int dev, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const WT* wp = static_cast<const WT*>(w);
  T* yp = static_cast<T*>(y);
  const bool wide = d % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (wide) return launch_packs<T, WT, VEC>(xp, wp, yp, rows, d, eps, dev, st);
  if (d <= 1024) {
    const int rows_per_block = 8;
    dim3 grid((rows + rows_per_block - 1) / rows_per_block);
    rmsnorm_warp_kernel<T, WT><<<grid, rows_per_block * 32, 0, st>>>(xp, wp, yp, rows, d, eps);
  } else {
    int threads = (d + 31) / 32 * 32;
    if (threads > kMaxBlockThreads) threads = kMaxBlockThreads;
    rmsnorm_block_kernel<T, WT, 1><<<dim3(rows), threads, 0, st>>>(xp, wp, yp, rows, d, eps);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_w(const void* x, const void* w, void* y, int rows, int d, float eps, int x_dtype,
             int w_dtype, int dev, cudaStream_t st) {
  if (w_dtype == x_dtype) return (int)launch_vec<T, T>(x, w, y, rows, d, eps, dev, st);
  if (w_dtype == 0) return (int)launch_vec<T, float>(x, w, y, rows, d, eps, dev, st);
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
  const int dev = c->device;
  switch (c->x_dtype) {
    case 0:
      return launch_w<float>(c->x, c->w, c->y, c->rows, c->d, c->eps, 0, c->w_dtype, dev, st);
    case 1:
      return launch_w<__nv_bfloat16>(c->x, c->w, c->y, c->rows, c->d, c->eps, 1, c->w_dtype, dev,
                                     st);
    case 2:
      return launch_w<__half>(c->x, c->w, c->y, c->rows, c->d, c->eps, 2, c->w_dtype, dev, st);
    default: return -2;
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
