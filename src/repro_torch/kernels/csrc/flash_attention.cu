// Fused attention forward (online softmax) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel,
// launched by _flash_fwd_kernel_call): q (B,Sq,H,hd), k/v (B,Skv,KV,hd), H % KV == 0,
// scale given by the caller (1/sqrt(hd) unless the model says otherwise), optional softcap tanh(s/c)*c applied BEFORE the mask, causal
// mask qpos >= kpos with qpos offset by Skv - Sq, window mask qpos - kpos < window
// (applied whether or not causal is set), fp32 (acc, m, l), p forced to 0 where
// s <= -5e29, result acc / max(l, 1e-30), and on request lse = m + log(l) per row
// for the backward.  Contract: Sq <= Skv under a causal mask or a window; any Sq
// without either (the offset Skv - Sq, negative then, is read only by those masks).
//
// The C entry point below picks one of two kernels by type (the rule is
// flash::variant_for in flash_attention.cuh; it is a split by type, not a fallback):
// bf16/fp16 at every compiled head_dim (16, 32, 64, 80, 128, 256) take the TMA +
// wgmma kernel of flash_attention_sm90.cu; float32, at every head_dim, the 3xTF32
// kernel of flash_attention_fp32.cu (TMA tiles in a two-stage ring, mma.sync.m16n8k8
// on TF32 with each operand split into a high and a low part, so the tensor cores give
// float32's accuracy; bound by operations at 165 TFLOP/s of float32-accurate work).
//
// Bound on this card: operations.  At the prefill shape (S = 2048, hd = 128) the
// kernel does ~S*hd/2 flops per byte of q/k/v/o it must move, well above the ~295
// flop/byte ridge, so the S x S score matrix must never reach device memory and the
// two products must run on the tensor cores; at head_dim 32 and 16 the exponentials
// (one per visible pair, 16 a clock an SM) take longer than the products, and the
// wgmma kernel's design says what it does about that.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_attention.cuh"

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and o share one type).
// The kernel a call of that type and head_dim launches: 0 tf32x3
// (flash_attention_fp32.cu), 1 TMA + wgmma (flash_attention_sm90.cu); -1 if none is
// compiled in.
extern "C" int repro_flash_attention_variant(int hd, int dtype) {
  return flash::variant_for(hd, dtype, false);
}

// Strides are in elements; the head_dim stride must be 1 and every row must start
// on a 16-byte boundary (the Python wrapper checks both).
// `lse`, when not null, receives each query row's log-sum-exp of its scaled (and
// capped) visible scores, natural log, as a contiguous (B, H, Sq) float32 tensor:
// what the backward (flash_attention_bwd.cu) recomputes the probabilities from.
// Serving passes null and writes nothing.
// Launches on `stream` of CUDA device `device`.  Returns 0, a cudaError_t (> 0)
// from the launch, -1 for a head_dim that is not compiled in, -2 for an unknown
// type, -3 / -4 when the TMA kernels' tensor maps cannot be made (see
// flash_attention.cuh).  No variant ever stands in for another.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Skv,
    int H, int KV,
    int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float softcap, float scale,
    int dtype, int device, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  flash::Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.hd = hd;
  flash::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (flash::variant_for(hd, dtype, false)) {
    case flash::kTf32x3: return flash::launch_fwd_tf32x3(p, hd, st);
    case flash::kSm90Wgmma: return flash::launch_sm90(p, hd, dtype, st);
    default: return (dtype < 0 || dtype > 2) ? -2 : -1;
  }
}
