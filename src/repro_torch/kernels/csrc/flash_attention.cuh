// Shared between the fused attention forward's two 16-bit kernels
// (flash_attention.cu: mma.sync; flash_attention_sm90.cu: TMA + wgmma).
//
// Both replace the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel,
// launched by _flash_fwd_kernel_call) and compute its contract, stated in
// flash_attention.cu.  This header holds what the two must agree on: the call's
// parameters, the kv range a query tile can see, the scalar score rule and the
// choice of kernel by type and head_dim.
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
  int B, Sq, Skv, H, KV;
  // strides in elements of (batch, sequence, head); the head_dim stride is 1
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float softcap, scale;
};

// Kernel variants, as repro_flash_attention_variant reports them.
enum Variant { kScalar = 0, kMmaSync = 1, kSm90Wgmma = 2 };

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  The split by shape:
// 16-bit inputs at head_dim 64 and 128 take the TMA + wgmma kernel; the other
// 16-bit head_dims (16, 32, 256) the mma.sync kernel; float32 the scalar one.
// -1: not compiled in.
inline int variant_for(int hd, int dtype) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256) return -1;
  if (dtype == 0) return kScalar;
  if (dtype != 1 && dtype != 2) return -1;
  return (hd == 64 || hd == 128) ? kSm90Wgmma : kMmaSync;
}

// Range of kv positions that a tile of query rows [q0, q0 + rows) can see, as
// [lo, hi) with lo rounded down to a multiple of `bn`.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int rows, int bn, int& lo,
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
