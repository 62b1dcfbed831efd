// Fused attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the backward of the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel's VJP: _flash_diff / _flash_vjp_fwd / _flash_vjp_bwd).  The reference
// has no backward kernel: _flash_vjp_bwd differentiates mha_reference, which on the
// card would materialise the (B, H, Sq, Skv) fp32 scores and their gradient.  The
// kernels this file launches compute the same gradients without them, from the
// forward's inputs, its output o and its per-row log-sum-exp lse (the forward,
// flash_attention.cu, writes it):
//   D  = rowsum(dO o O)                         (fp32, one value per query row)
//   s  = q k^T * scale (the caller's), capped s = tanh(s / c) * c when softcap c != 0
//   p  = exp(s - lse) where the mask (causal / window / ragged tail) lets the pair
//        through, else 0
//   dv = p^T dO      dp = dO v^T      ds = p o (dp - D) [o (1 - tanh^2) when capped]
//   dq = ds k * scale                 dk = ds^T q * scale
// with dk and dv summed over the G = H / KV query heads of each KV head.
//
// Bound on this card: operations.  Per visible (query, key) pair the gradients need
// 10 * hd flops (q k^T, dO v^T, p^T dO, ds k, ds^T q); at the training shape (S =
// 4096, hd = 128, causal) that is ~0.6 TFLOP, against ~0.3 GB of inputs and outputs:
// far above the ~295 flop/byte ridge, so the scores must stay out of device memory and
// every product must run on the tensor cores.  At head_dim 32 and 16 the one
// exponential a pair (16 a clock an SM) takes about as long as the products.
//
// The C entry point below picks the kernels by type with the backward's rule
// (flash::variant_for): 16-bit inputs at every compiled head_dim take the TMA + wgmma
// kernels of flash_attention_bwd_sm90.cu (a prep kernel for D, one pass for dk, dv and
// dq, dq summed by TMA reduce-adds and cast; at head_dim 256 a dk/dv pass and a dq
// pass); float32, at every head_dim, the 3xTF32 passes of flash_attention_fp32.cu (TMA
// tiles in a two-stage ring, each operand split into TF32 high and low parts, D
// computed by its dq pass, then dk/dv; deterministic; bound by operations at 165
// TFLOP/s of float32-accurate work).  A split by type, not a fallback.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_attention.cuh"

// One backward call's arguments, passed as one block (there are too many for a plain
// argument list).  dtype codes: 0 = float32, 1 = bfloat16, 2 = float16, shared by
// q, k, v, o, dout, dq, dk and dv.  lse is the forward's (B, H, Sq) float32 output;
// delta and dq_acc are float32 scratch as flash::BwdParams states (flash_attention.cuh:
// for the wgmma kernel 2 x (B, H, sq_pad(Sq)) and (B, H, sq_pad(Sq), hd), for tf32x3
// (B, H, Sq) and unused); all contiguous.  Strides in elements, head_dim
// stride 1, 16-bit rows on 16-byte boundaries (the Python wrapper checks both).
struct FlashBwdCall {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const void* lse;
  void* delta;
  void* dq_acc;
  void* dq;
  void* dk;
  void* dv;
  void* stream;
  int B;
  int Sq;
  int Skv;
  int H;
  int KV;
  int hd;
  long long q_sb;
  long long q_ss;
  long long q_sh;
  long long k_sb;
  long long k_ss;
  long long k_sh;
  long long v_sb;
  long long v_ss;
  long long v_sh;
  long long o_sb;
  long long o_ss;
  long long o_sh;
  long long do_sb;
  long long do_ss;
  long long do_sh;
  long long dq_sb;
  long long dq_ss;
  long long dq_sh;
  long long dk_sb;
  long long dk_ss;
  long long dk_sh;
  long long dv_sb;
  long long dv_ss;
  long long dv_sh;
  int causal;
  int window;
  float softcap;
  float scale;
  int dtype;
  int device;
};

// The kernels a backward call of that type and head_dim launches: 0 tf32x3,
// 1 TMA + wgmma (the backward's rule); -1 if none is compiled in.
extern "C" int repro_flash_attention_bwd_variant(int hd, int dtype) {
  return flash::variant_for(hd, dtype, true);
}

// Launches the backward's kernels on `stream` of CUDA device `device`: the wgmma
// kernel's prep, one pass and dq cast, or the tf32x3 passes.  Returns 0, a cudaError_t
// (> 0) from a launch, -1 for a head_dim that is not compiled in, -2 for an unknown
// type, -3 / -4 when the TMA kernels' tensor maps cannot be made (nothing launched).
// No variant ever stands in for another.
extern "C" int repro_flash_attention_bwd(const FlashBwdCall* c) {
  if (c->B <= 0 || c->H <= 0 || c->Sq <= 0 || c->Skv <= 0) return 0;
  if (repro_flash_attention_bwd_variant(c->hd, c->dtype) < 0)
    return (c->dtype < 0 || c->dtype > 2) ? -2 : -1;
  flash::BwdParams p;
  p.q = c->q; p.k = c->k; p.v = c->v; p.o = c->o; p.dout = c->dout;
  p.lse = static_cast<const float*>(c->lse);
  p.delta = static_cast<float*>(c->delta);
  p.dq_acc = static_cast<float*>(c->dq_acc);
  p.dq = c->dq; p.dk = c->dk; p.dv = c->dv;
  p.B = c->B; p.Sq = c->Sq; p.Skv = c->Skv; p.H = c->H; p.KV = c->KV;
  p.q_sb = c->q_sb; p.q_ss = c->q_ss; p.q_sh = c->q_sh;
  p.k_sb = c->k_sb; p.k_ss = c->k_ss; p.k_sh = c->k_sh;
  p.v_sb = c->v_sb; p.v_ss = c->v_ss; p.v_sh = c->v_sh;
  p.o_sb = c->o_sb; p.o_ss = c->o_ss; p.o_sh = c->o_sh;
  p.do_sb = c->do_sb; p.do_ss = c->do_ss; p.do_sh = c->do_sh;
  p.dq_sb = c->dq_sb; p.dq_ss = c->dq_ss; p.dq_sh = c->dq_sh;
  p.dk_sb = c->dk_sb; p.dk_ss = c->dk_ss; p.dk_sh = c->dk_sh;
  p.dv_sb = c->dv_sb; p.dv_ss = c->dv_ss; p.dv_sh = c->dv_sh;
  p.causal = c->causal; p.window = c->window;
  p.softcap = c->softcap;
  p.scale = c->scale;
  p.hd = c->hd;
  flash::DeviceGuard guard(c->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  if (flash::variant_for(c->hd, c->dtype, true) == flash::kSm90Wgmma)
    return flash::launch_bwd_sm90(p, c->hd, c->dtype, st);
  return flash::launch_bwd_tf32x3(p, c->hd, st);
}
