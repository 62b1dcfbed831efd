// Shared between the fused attention kernels: the forward's (flash_attention.cu:
// mma.sync and scalar; flash_attention_sm90.cu: TMA + wgmma) and the backward's
// (flash_attention_bwd.cu: mma.sync and scalar; flash_attention_bwd_sm90.cu: TMA +
// wgmma).
//
// They replace the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel,
// launched by _flash_fwd_kernel_call, and the VJP _flash_vjp_bwd takes of
// mha_reference) and compute its contract, stated in flash_attention.cu.  This
// header holds what they must agree on: the calls' parameters, the kv range a query
// tile can see and the query range a key tile can see, the scalar score rule and the
// choice of kernel by type and head_dim, forward and backward.
//
// Bound on this card: operations (see flash_attention.cu); nothing here moves data.

#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) log-sum-exp per query row, or null: not written
  int B, Sq, Skv, H, KV;
  // strides in elements of (batch, sequence, head); the head_dim stride is 1
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float softcap, scale;
};

// One backward call: the forward's inputs, its output o and per-row lse, dO, and the
// gradients.  delta is float32 scratch: (B, H, Sq) D = rowsum(dO o O) for the
// scalar and mma.sync kernels; for the wgmma kernel D then lse * log2(e), each
// (B, H, sq_pad(Sq)), rows past Sq padded (D 0, lse +inf), and dq_acc its float32
// dq accumulator of B * H * sq_pad(Sq) * hd floats, laid out as that kernel states
// (unused by the others, and by the wgmma kernel at kDqPassHeadDim, whose dq pass
// writes dq itself: null there).
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq), contiguous
  float* delta;
  float* dq_acc;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, H, KV;
  // strides in elements of (batch, sequence, head); the head_dim stride is 1
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int causal, window;
  float softcap, scale;
};

// The wgmma backward's padded query count: every query tile it loads (64 or 128
// rows) lies inside it.
constexpr int kSqPad = 128;
__host__ __device__ inline int sq_pad(int sq) { return (sq + kSqPad - 1) / kSqPad * kSqPad; }
// The head_dim at which the wgmma backward computes dq in a pass of its own.
constexpr int kDqPassHeadDim = 256;

// Kernel variants, as repro_flash_attention_variant and
// repro_flash_attention_bwd_variant report them.
enum Variant { kScalar = 0, kMmaSync = 1, kSm90Wgmma = 2 };

// The head_dims compiled in, forward and backward, and the 16-bit ones the TMA +
// wgmma kernels take: the forward and the backward at 64, 80, 128 and 256 (16 and 32
// keep the mma.sync kernels).  Head_dim 80 (zamba2's shared attention): its 160-byte
// 16-bit row is wider than one 128-byte swizzle atom, so both wgmma kernels cut it
// into a 64-column box and a 16-column one under the 32-byte swizzle
// (flash_attention_sm90.cu, flash_attention_bwd_sm90.cu).
constexpr int kHeadDims[] = {16, 32, 64, 80, 128, 256};
constexpr int kBwdHeadDims[] = {16, 32, 64, 80, 128, 256};
constexpr int kSm90HeadDims[] = {64, 80, 128, 256};
constexpr int kSm90BwdHeadDims[] = {64, 80, 128, 256};

template <int N>
inline bool one_of(const int (&set)[N], int hd) {
  for (int x : set)
    if (x == hd) return true;
  return false;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  The split by shape: 16-bit
// inputs at the wgmma head_dims above take the TMA + wgmma kernel; the other 16-bit
// head_dims the mma.sync kernel; float32 the scalar one.  -1: not compiled in.
inline int variant_for(int hd, int dtype, bool backward) {
  if (!(backward ? one_of(kBwdHeadDims, hd) : one_of(kHeadDims, hd))) return -1;
  if (dtype == 0) return kScalar;
  if (dtype != 1 && dtype != 2) return -1;
  const bool wgmma = backward ? one_of(kSm90BwdHeadDims, hd) : one_of(kSm90HeadDims, hd);
  return wgmma ? kSm90Wgmma : kMmaSync;
}

// Range of kv positions that a tile of query rows [q0, q0 + rows) can see, as
// [lo, hi) with lo rounded down to a multiple of `bn`.
// (Any parameter block with Sq, Skv, causal and window: the backward's too.)
template <typename P>
__device__ __forceinline__ void kv_range(const P& p, int q0, int rows, int bn, int& lo,
                                         int& hi) {
  const int offset = p.Skv - p.Sq;
  const int rows_end = min(q0 + rows, p.Sq);
  hi = p.causal ? min(p.Skv, rows_end + offset) : p.Skv;
  lo = 0;
  if (p.window > 0) {
    lo = max(0, q0 + offset - p.window + 1);
    lo = (lo / bn) * bn;
  }
}

// The query rows [lo, hi) that can see some key of [n0, n0 + bn); lo is rounded down
// to a multiple of `bm`.  Empty when hi <= lo.
template <typename P>
__device__ __forceinline__ void q_range(const P& p, int n0, int bn, int bm, int& lo, int& hi) {
  const int offset = p.Skv - p.Sq;
  lo = p.causal ? max(0, n0 - offset) : 0;
  lo = (lo / bm) * bm;
  hi = p.Sq;
  if (p.window > 0) hi = min(hi, n0 + bn - 1 + p.window - offset);
}

__device__ __forceinline__ float masked_score(const Params& p, float raw, int qpos, int kpos) {
  float x = raw * p.scale;
  if (p.softcap != 0.f) x = tanhf(x / p.softcap) * p.softcap;
  bool ok = kpos < p.Skv;
  if (p.causal) ok = ok && (qpos >= kpos);
  if (p.window > 0) ok = ok && (qpos - kpos < p.window);
  return ok ? x : kNegInf;
}

// The TMA + wgmma kernel's launcher (flash_attention_sm90.cu).  Returns 0, a
// cudaError_t (> 0), or a negative code: -1 head_dim not compiled in, -3 a tensor
// map could not be encoded, -4 the driver's cuTensorMapEncodeTiled is unavailable.
int launch_sm90(const Params& p, int hd, int dtype, cudaStream_t st);

// The TMA + wgmma backward's launcher (flash_attention_bwd_sm90.cu): D and the
// padded lse, dk/dv with dq accumulated in dq_acc, then dq.  The same codes.
int launch_bwd_sm90(const BwdParams& p, int hd, int dtype, cudaStream_t st);

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

}  // namespace flash
