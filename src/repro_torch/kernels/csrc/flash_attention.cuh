// Shared between the fused attention kernels: the 16-bit forward's
// (flash_attention_sm90.cu: TMA + wgmma) and backward's (flash_attention_bwd_sm90.cu:
// TMA + wgmma), the float32 forward and backward (flash_attention_fp32.cu: 3xTF32), and
// their C entries (flash_attention.cu, flash_attention_bwd.cu).
//
// They replace the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel,
// launched by _flash_fwd_kernel_call, and the VJP _flash_vjp_bwd takes of
// mha_reference) and compute its contract, stated in flash_attention.cu.  This
// header holds what they must agree on: the calls' parameters, the kv range a query
// tile can see and the query range a key tile can see, the score rule and the
// choice of kernel by type and head_dim, forward and backward.
//
// Bound on this card: operations (see flash_attention_sm90.cu); nothing here moves
// data.

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
  int hd;  // the tensors' head_dim: a kernel of a wider one loads and stores hd columns
};

// One backward call: the forward's inputs, its output o and per-row lse, dO, and the
// gradients.  delta is float32 scratch: (B, H, Sq) D = rowsum(dO o O) for the
// tf32x3 kernels; for the wgmma kernel D then lse * log2(e), each
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
  int hd;  // as Params::hd
};

// The wgmma backward's padded query count: every query tile it loads (64 or 128
// rows) lies inside it.
constexpr int kSqPad = 128;
__host__ __device__ inline int sq_pad(int sq) { return (sq + kSqPad - 1) / kSqPad * kSqPad; }
// The head_dim at which the wgmma backward computes dq in a pass of its own.
constexpr int kDqPassHeadDim = 256;

// Kernel variants, as repro_flash_attention_variant and
// repro_flash_attention_bwd_variant report them.
enum Variant { kTf32x3 = 0, kSm90Wgmma = 1 };

// The head_dims compiled in, forward and backward, in every type.  Both wgmma kernels
// cut a 16-bit row into 64-column boxes under the 128-byte swizzle and 16-column ones
// under the 32-byte swizzle (flash_attention_sm90.cu, flash_attention_bwd_sm90.cu):
// head_dim 80 (zamba2's shared attention), whose 160-byte row is wider than one
// 128-byte swizzle atom, as one of each; 32 and 16, narrower than one, as narrow boxes
// only (the forward's one 32-column box under the 64-byte swizzle at 32).  Head_dim
// 224 (zamba2-7b's shared attention) runs on head_dim 256's kernels (kernel_head_dim)
// with tensor maps 224 columns wide: TMA fills the last 32 columns of every tile it
// loads with zeros, which add nothing to a product, and the stores leave them out.
constexpr int kHeadDims[] = {16, 32, 64, 80, 128, 224, 256};
constexpr int kBwdHeadDims[] = {16, 32, 64, 80, 128, 224, 256};

// The head_dim whose 16-bit kernels run a call at head_dim hd.
constexpr int kernel_head_dim(int hd) { return hd == 224 ? 256 : hd; }

template <int N>
inline bool one_of(const int (&set)[N], int hd) {
  for (int x : set)
    if (x == hd) return true;
  return false;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  The split by type: 16-bit
// inputs take the TMA + wgmma kernels at every compiled head_dim; float32, at every
// head_dim, the 3xTF32 kernels (flash_attention_fp32.cu).  -1: not compiled in.
inline int variant_for(int hd, int dtype, bool backward) {
  if (!(backward ? one_of(kBwdHeadDims, hd) : one_of(kHeadDims, hd))) return -1;
  if (dtype == 0) return kTf32x3;
  if (dtype != 1 && dtype != 2) return -1;
  return kSm90Wgmma;
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

// The scaled (and capped) score, before the mask.
__device__ __forceinline__ float scaled_score(const Params& p, float raw) {
  float x = raw * p.scale;
  if (p.softcap != 0.f) x = tanhf(x / p.softcap) * p.softcap;
  return x;
}

// Whether every pair of query rows [r0, r0 + rows) and keys [k0, k0 + keys) is inside
// both tensors and the masks: the first row sees the last key (causal) and the last
// row the first key (window).  (Any parameter block: the backward's too.)
template <typename P>
__device__ __forceinline__ bool all_visible(const P& p, int r0, int rows, int k0, int keys) {
  const int offset = p.Skv - p.Sq;
  if (r0 + rows > p.Sq || k0 + keys > p.Skv) return false;
  if (p.causal && r0 + offset < k0 + keys - 1) return false;
  return p.window <= 0 || r0 + rows - 1 + offset - k0 < p.window;
}

__device__ __forceinline__ float masked_score(const Params& p, float raw, int qpos, int kpos) {
  const float x = scaled_score(p, raw);
  bool ok = kpos < p.Skv;
  if (p.causal) ok = ok && (qpos >= kpos);
  if (p.window > 0) ok = ok && (qpos - kpos < p.window);
  return ok ? x : kNegInf;
}

// Whether the pair (query row, key) is visible: inside both tensors and the masks.
__device__ __forceinline__ bool visible(const BwdParams& p, int row, int key) {
  const int qpos = row + (p.Skv - p.Sq);
  bool ok = row < p.Sq && key < p.Skv;
  if (p.causal) ok = ok && qpos >= key;
  if (p.window > 0) ok = ok && qpos - key < p.window;
  return ok;
}

// p and ds of one pair from its raw score, the row's lse and D, and dp.
__device__ __forceinline__ void prob_and_grad(const BwdParams& p, bool ok, float raw,
                                              float lse, float dlt, float dp, float& pe,
                                              float& ds) {
  float x = raw * p.scale, capd = 1.f;
  if (p.softcap != 0.f) {
    const float th = tanhf(x / p.softcap);
    x = th * p.softcap;
    capd = 1.f - th * th;
  }
  pe = ok ? __expf(x - lse) : 0.f;
  ds = pe * (dp - dlt) * capd;
}

// The TMA + wgmma kernel's launcher (flash_attention_sm90.cu).  Returns 0, a
// cudaError_t (> 0), or a negative code: -1 head_dim not compiled in, -3 a tensor
// map could not be encoded, -4 the driver's cuTensorMapEncodeTiled is unavailable.
int launch_sm90(const Params& p, int hd, int dtype, cudaStream_t st);

// The TMA + wgmma backward's launcher (flash_attention_bwd_sm90.cu): D and the
// padded lse, dk/dv with dq accumulated in dq_acc, then dq.  The same codes.
int launch_bwd_sm90(const BwdParams& p, int hd, int dtype, cudaStream_t st);

// The float32 kernels' launchers (flash_attention_fp32.cu): the forward, and the
// backward's two passes (dq with D = rowsum(dO o O) into delta, then dk/dv).  The
// same codes as the wgmma launchers; a refusal launches nothing.
int launch_fwd_tf32x3(const Params& p, int hd, cudaStream_t st);
int launch_bwd_tf32x3(const BwdParams& p, int hd, cudaStream_t st);

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
