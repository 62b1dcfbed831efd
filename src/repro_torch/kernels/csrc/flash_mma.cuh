// mma.sync building blocks shared by the fused attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu) for 16-bit inputs: the m16n8k16 product with
// fp32 accumulation, the fragment loads from padded shared memory and the cp.async
// tile copies.
//
// The kernels built from them replace the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, and the backward that _flash_vjp_bwd derives from mha_reference).
// Bound on this card: operations (see flash_attention.cu); nothing here decides a
// tile shape.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A (16 x 16): a[0] (row g, cols 2t..2t+1), a[1] (row g+8, same cols),
//                a[2] (row g, cols 2t+8..), a[3] (row g+8, cols 2t+8..);
//   B (16 x 8):  b0 (k rows 2t..2t+1, col g), b1 (k rows 2t+8..2t+9, col g);
//   C (16 x 8):  c[0..1] (row g, cols 2t..2t+1), c[2..3] (row g+8, same cols).
// So the accumulators of two neighbouring 8-column blocks are, register for register,
// the A fragment of one 16-deep step (pack_a below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {
namespace {

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <typename T> __device__ __forceinline__ uint32_t lds32(const T* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// The A fragment (16 rows x 16 columns) of one k-step from a row-major tile: `ptr`
// is this lane's element (row g, column 2t) of the block, `lds` the row stride.
template <typename T>
__device__ __forceinline__ void load_q_fragment(uint32_t (&a)[4], const T* ptr, int lds) {
  a[0] = lds32(ptr);
  a[1] = lds32(ptr + 8 * lds);
  a[2] = lds32(ptr + 8);
  a[3] = lds32(ptr + 8 * lds + 8);
}

// The A fragment of the k-step over columns [16kk, 16kk + 16) from two accumulator
// blocks c[2kk], c[2kk+1] (rounded to 16 bits).
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = Mma<T>::pack(lo[0], lo[1]);
  a[1] = Mma<T>::pack(lo[2], lo[3]);
  a[2] = Mma<T>::pack(hi[0], hi[1]);
  a[3] = Mma<T>::pack(hi[2], hi[3]);
}

// Four 8x8 b16 matrices from shared memory, each transposed on the way: lane l
// gives the address of row (l & 7) of matrix (l >> 3).  With lane l pointing at row
// (k0 + (l & 15)), column (n0 + (l >> 4) * 8) of a row-major [k][n] tile, r[0], r[1]
// are the B fragment of columns [n0, n0+8) and r[2], r[3] that of [n0+8, n0+16).
template <typename T>
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const T* row_ptr) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Start the asynchronous copy of `rows` rows of HD 16-bit values (16 bytes a
// thread and request) from a strided global tensor into padded shared memory;
// rows at or past `limit` are zero-filled (a cp.async with source size 0).  The
// copies belong to the caller's next cp.async commit group.
template <typename T, int HD, int LDS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, long long row_stride,
                                                int first, int limit, int rows, int tid,
                                                int nthreads) {
  constexpr int VPR = HD / 8;
  for (int i = tid; i < rows * VPR; i += nthreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = first + r < limit;
    const T* from = src + (ok ? (long long)(first + r) * row_stride + c : 0);
    const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LDS + c));
    const int bytes = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(from),
                 "r"(bytes)
                 : "memory");
  }
}

// The same for `n` consecutive floats src[first..first+n) (4 bytes a request);
// entries at or past `limit` are zero-filled.
__device__ __forceinline__ void load_floats_async(float* dst, const float* src, int first,
                                                  int limit, int n, int tid, int nthreads) {
  for (int i = tid; i < n; i += nthreads) {
    const bool ok = first + i < limit;
    const float* from = src + (ok ? first + i : 0);
    const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst + i));
    const int bytes = ok ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to), "l"(from),
                 "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raise a kernel's dynamic shared-memory limit once per instantiation when it needs
// more than the default 48 KB.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kern, int bytes, bool& raised) {
  if (bytes <= 48 * 1024 || raised) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) raised = true;
  return e;
}

}  // namespace
}  // namespace flash
