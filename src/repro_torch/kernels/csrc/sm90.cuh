// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels of fused
// attention: the forward (flash_attention_sm90.cu) and the backward
// (flash_attention_bwd_sm90.cu).
//
// Both replace the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel,
// and the backward its _flash_vjp_bwd derives from mha_reference).
// Bound on this card: operations (see the two kernels' notes); nothing here decides
// a tile shape.
//
// What is here: shared-memory addresses, mbarriers (every wait traps after 4 s
// instead of hanging the card), 4-D TMA tile loads and a 1-D bulk copy, the wgmma
// descriptor (128-byte swizzle; 64-byte for head_dim 32's 32-column box; 32-byte for
// 16-column boxes: head_dim 80's last 16 columns, the whole head at 16 and in the
// backward at 32), the wgmma instructions
// (m64nNk16, fp32 accumulator; A and B from shared memory, either operand K-major or
// MN-major; or A from registers with B MN-major), the MUFU's base-2 exponential and
// the host's tensor-map encoder, looked up through the runtime (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {
namespace {

constexpr int kBoxCols = 64;      // 128 bytes of 16-bit values: one swizzle row
constexpr int kNarrowCols = 16;   // 32 bytes: one row of the 32-byte swizzle
// wgmma descriptors' layout types: the swizzle the tile was stored with
constexpr int kSwizzle128B = 1, kSwizzle64B = 2, kSwizzle32B = 3;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One arrival on `bar` from the threads where `pred` holds.  The predicate sits
// inside the instruction: a branch around it while a wgmma is in flight would make
// the compiler serialise the wgmmas.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 state;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.  The loop
// is in PTX, for the same reason.  A phase that never completes (a lost arrival
// or byte count) traps after 4 s: the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "LOOP:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4000000000;\n"
      "@p trap;\n"
      "bra LOOP;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 4-D TMA tile load (coordinates innermost first) that completes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// A bulk copy of `bytes` contiguous bytes (a multiple of 16, both addresses on
// 16-byte boundaries) from global to shared memory that completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1) unless told
// otherwise.  Offsets in bytes.  K-major operands: LBO unused, SBO the stride of
// 8-row groups (8 x 128 B; 8 x 32 B = 256 under the 32-byte swizzle, type 3).
// MN-major operands: LBO the stride of swizzle boxes along M or N (64 elements a
// box; 16 under the 32-byte swizzle), SBO that of 8-row groups along K.  Every box
// starts on a multiple of its swizzle's period (1024 or 256 bytes), so the
// descriptor's base offset stays 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout = kSwizzle128B) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)layout << 62;
  return d;
}

// The value, as something the compiler cannot compute ahead: used on a k-step's
// base descriptor so each step's descriptor is made where it is used instead of
// all of them being made before the loop and kept live (there are no registers
// for that beside the accumulators).
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across a wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ wgmma instructions
// m64nNk16, fp32 accumulator d (N/2 registers a thread).  SS (N = 16, 32, 64, 128):
// A and B from shared memory, TA / TB = 1 where that operand is MN-major
// (transposed), 0 where it is K-major.  RS (N = 16, 32, 64, 128): A from registers, B
// from shared memory MN-major.

#define D8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define D16 D8(0), D8(8)
#define D32 D16, D8(16), D8(24)
#define D64 D32, D8(32), D8(40), D8(48), D8(56)
#define R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define R32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define R64                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define DEFINE_WGMMA(TAG, AB)                                                               \
  template <int TA, int TB>                                                                 \
  __device__ __forceinline__ void ss_n16_##TAG(float (&d)[8], uint64_t da, uint64_t db,     \
                                               int acc) {                                   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " " R8             \
                 ", %8, %9, p, 1, 1, %11, %12;\n}\n"                                      \
                 : D8(0)                                                                    \
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));                           \
  }                                                                                         \
  template <int TA, int TB>                                                                 \
  __device__ __forceinline__ void ss_n32_##TAG(float (&d)[16], uint64_t da, uint64_t db,    \
                                               int acc) {                                   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " " R16            \
                 ", %16, %17, p, 1, 1, %19, %20;\n}\n"                                    \
                 : D16                                                                      \
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));                           \
  }                                                                                         \
  template <int TA, int TB>                                                                 \
  __device__ __forceinline__ void ss_n64_##TAG(float (&d)[32], uint64_t da, uint64_t db,    \
                                               int acc) {                                   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " R32            \
                 ", %32, %33, p, 1, 1, %35, %36;\n}\n"                                      \
                 : D32                                                                      \
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));                           \
  }                                                                                         \
  template <int TA, int TB>                                                                 \
  __device__ __forceinline__ void ss_n128_##TAG(float (&d)[64], uint64_t da, uint64_t db,   \
                                                int acc) {                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " " R64           \
                 ", %64, %65, p, 1, 1, %67, %68;\n}\n"                                      \
                 : D64                                                                      \
                 : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));                           \
  }                                                                                         \
  __device__ __forceinline__ void rs_n16_##TAG(float (&d)[8], const uint32_t (&a)[4],       \
                                               uint64_t db, int acc) {                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " " R8             \
                 ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                            \
                 : D8(0)                                                                    \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));         \
  }                                                                                         \
  __device__ __forceinline__ void rs_n32_##TAG(float (&d)[16], const uint32_t (&a)[4],      \
                                               uint64_t db, int acc) {                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " " R16            \
                 ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                          \
                 : D16                                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));         \
  }                                                                                         \
  __device__ __forceinline__ void rs_n64_##TAG(float (&d)[32], const uint32_t (&a)[4],      \
                                               uint64_t db, int acc) {                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " R32            \
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                          \
                 : D32                                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));         \
  }                                                                                         \
  __device__ __forceinline__ void rs_n128_##TAG(float (&d)[64], const uint32_t (&a)[4],     \
                                                uint64_t db, int acc) {                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                             \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " " R64           \
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                          \
                 : D64                                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));         \
  }

DEFINE_WGMMA(bf16, "bf16")
DEFINE_WGMMA(f16, "f16")

#undef DEFINE_WGMMA
#undef R64
#undef R32
#undef R16
#undef R8
#undef D64
#undef D32
#undef D16
#undef D8

template <typename T> struct Wg;

template <> struct Wg<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  template <int N, int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
    if constexpr (N == 16) ss_n16_bf16<TA, TB>(d, da, db, acc);
    else if constexpr (N == 32) ss_n32_bf16<TA, TB>(d, da, db, acc);
    else if constexpr (N == 64) ss_n64_bf16<TA, TB>(d, da, db, acc);
    else ss_n128_bf16<TA, TB>(d, da, db, acc);
  }
  template <int N>
  static __device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    if constexpr (N == 16) rs_n16_bf16(d, a, db, acc);
    else if constexpr (N == 32) rs_n32_bf16(d, a, db, acc);
    else if constexpr (N == 64) rs_n64_bf16(d, a, db, acc);
    else rs_n128_bf16(d, a, db, acc);
  }
};

template <> struct Wg<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  template <int N, int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
    if constexpr (N == 16) ss_n16_f16<TA, TB>(d, da, db, acc);
    else if constexpr (N == 32) ss_n32_f16<TA, TB>(d, da, db, acc);
    else if constexpr (N == 64) ss_n64_f16<TA, TB>(d, da, db, acc);
    else ss_n128_f16<TA, TB>(d, da, db, acc);
  }
  template <int N>
  static __device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    if constexpr (N == 16) rs_n16_f16(d, a, db, acc);
    else if constexpr (N == 32) rs_n32_f16(d, a, db, acc);
    else if constexpr (N == 64) rs_n64_f16(d, a, db, acc);
    else rs_n128_f16(d, a, db, acc);
  }
};

// ------------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A 4-D map over (hd, seq, heads, batch) of a tensor of `elem` bytes an element
// (16-bit unless told otherwise) with element strides (ss, sh, sb), boxes of `cols`
// columns x `rows` rows of one head: 64 16-bit columns under the 128-byte swizzle, or
// 16 (head_dim 80's last box, every box at 32 and 16) under the 32-byte one; in float32
// (flash_attention_fp32.cu)
// 32 columns under the 128-byte swizzle or 16 under the 64-byte one.  Rows past `seq`
// read as zeros.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int hd,
            int seq, int heads, int batch, long long ss, long long sh, long long sb, int rows,
            int cols = kBoxCols, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B,
            int elem = 2) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  // a dimension of extent 1 is never stepped over: give it a stride TMA accepts
  const long long any = 128 / elem;  // 128 bytes
  const long long st[3] = {seq > 1 ? ss : any, heads > 1 ? sh : any, batch > 1 ? sb : any};
  const cuuint64_t strides[3] = {(cuuint64_t)(st[0] * elem), (cuuint64_t)(st[1] * elem),
                                 (cuuint64_t)(st[2] * elem)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The number of SMs of the current device: the persistent grids' size.
cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

}  // namespace
}  // namespace flash
