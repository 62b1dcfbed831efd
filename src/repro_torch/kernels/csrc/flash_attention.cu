// Fused attention forward (online softmax) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel,
// launched by _flash_fwd_kernel_call): q (B,Sq,H,hd), k/v (B,Skv,KV,hd), H % KV == 0,
// scale 1/sqrt(hd), optional softcap tanh(s/c)*c applied BEFORE the mask, causal
// mask qpos >= kpos with qpos offset by Skv - Sq, window mask qpos - kpos < window
// (applied whether or not causal is set), fp32 (acc, m, l), p forced to 0 where
// s <= -5e29, result acc / max(l, 1e-30), and on request lse = m + log(l) per row
// for the backward.  Contract: Sq <= Skv under a causal mask or a window; any Sq
// without either (the offset Skv - Sq, negative then, is read only by those masks).
//
// The C entry point below picks one of three kernels by type and head_dim (the
// rule is flash::variant_for in flash_attention.cuh; it is a split by shape, not a
// fallback): bf16/fp16 at head_dim 64, 80, 128 and 256 -- the serving and training
// paths' shapes, zamba2's shared attention at 80 among them -- take the TMA + wgmma
// kernel of flash_attention_sm90.cu; bf16/fp16 at head_dim 16 and 32 the mma.sync
// kernel of this file; float32, at every head_dim, the 3xTF32 kernel of
// flash_attention_fp32.cu (TMA tiles in a two-stage ring, mma.sync.m16n8k8 on TF32
// with each operand split into a high and a low part, so the tensor cores give
// float32's accuracy; bound by operations at 165 TFLOP/s of float32-accurate work).
//
// Bound on this card: operations.  At the prefill shape (S = 2048, hd = 128) the
// kernel does ~S*hd/2 flops per byte of q/k/v/o it must move, well above the ~295
// flop/byte ridge, so the S x S score matrix must never reach device memory and
// the two products must run on the tensor cores.  What the mma.sync design does:
//   * one block per (batch, q-head, 64-row q tile); the sequential kv grid axis of
//     the TPU kernel is the loop inside the block, and (acc, m, l) stay in
//     registers for the whole loop;
//   * both products are mma.sync m16n8k16 with fp32 accumulation, one warp per 16
//     query rows; the score fragment is re-packed in registers as the A operand of
//     p*v, so p never touches shared memory; K and V tiles are staged through
//     padded shared memory (V fragments by ldmatrix.trans);
//   * the K/V tiles are double-buffered: cp.async fetches tile i+1 into the
//     second stage while tile i is computed, so global-memory latency is hidden
//     behind the products; the Q fragments are read from shared memory once and
//     stay in registers for the whole kv loop;
//   * the kv loop starts at the window's edge and stops at the diagonal instead
//     of visiting fully masked tiles, and heavy (late) q tiles are scheduled first;
//   * ragged tails are masked (rows >= Sq are not stored, keys >= Skv are masked),
//     so no divisibility of Sq or Skv is required;
//   * GQA is pointer arithmetic: head h reads kv head h / (H / KV) through the
//     strides it is given; K/V are never repeated or transposed in memory.
// It is latency-bound inside the warp (PERF.md), which is why the serving
// shapes moved to wgmma; no main path runs it (every 16-bit head_dim a model has
// is a wgmma one).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "flash_mma.cuh"

namespace {

using flash::kNegInf;
using flash::kv_range;
using flash::masked_score;
using flash::Params;
using flash::Mma;
using flash::lds32;
using flash::load_q_fragment;
using flash::ldmatrix_x4_trans;
using flash::load_tile_async;
using flash::cp_async_commit;
using flash::cp_async_wait;

// ---------------------------------------------------------------------------
// 16-bit inputs: tensor cores through mma.sync.m16n8k16 (helpers in flash_mma.cuh)
// ---------------------------------------------------------------------------

template <typename T, int HD, int BM, int BN>
__global__ void __launch_bounds__(BM * 2) flash_fwd_mma_kernel(const Params p) {
  constexpr int NT = BM * 2;    // one warp per 16 query rows
  constexpr int LDS = HD + 8;   // padded row: fragment loads hit 32 distinct banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sKV = sQ + BM * LDS;  // two stages, each a K tile followed by a V tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // late tiles do the most work: start them first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * BM;
  const int offset = p.Skv - p.Sq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  int kv_lo, kv_hi;
  kv_range(p, q0, BM, BN, kv_lo, kv_hi);

  // first commit group: the Q tile and the first K/V tile
  load_tile_async<T, HD, LDS>(sQ, qg, p.q_ss, q0, p.Sq, BM, tid, NT);
  if (kv_lo < kv_hi) {
    load_tile_async<T, HD, LDS>(sKV, kg, p.k_ss, kv_lo, p.Skv, BN, tid, NT);
    load_tile_async<T, HD, LDS>(sKV + BN * LDS, vg, p.v_ss, kv_lo, p.Skv, BN, tid, NT);
  }
  cp_async_commit();

  float o_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};  // per-thread partial sums, reduced over the quad at the end

  const int row_q[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int qpos[2] = {row_q[0] + offset, row_q[1] + offset};
  const T* q_frag = sQ + (warp * 16 + g) * LDS + t * 2;
  uint32_t q_regs[HD / 16][4];

  int stage = 0;
  for (int n0 = kv_lo; n0 < kv_hi; n0 += BN, stage ^= 1) {
    // start fetching the next tile into the other stage (every warp left it at
    // the barrier that ended the previous iteration), then wait for this one
    if (n0 + BN < kv_hi) {
      T* next = sKV + (stage ^ 1) * 2 * BN * LDS;
      load_tile_async<T, HD, LDS>(next, kg, p.k_ss, n0 + BN, p.Skv, BN, tid, NT);
      load_tile_async<T, HD, LDS>(next + BN * LDS, vg, p.v_ss, n0 + BN, p.Skv, BN, tid, NT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and, the first time round, sQ) is visible to all
    const T* sK = sKV + stage * 2 * BN * LDS;
    const T* sV = sK + BN * LDS;
    if (n0 == kv_lo) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) load_q_fragment(q_regs[kk], q_frag + kk * 16, LDS);
    }

    // s = q k^T for this warp's 16 rows and the tile's BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const T* k_frag = sK + (j * 8 + g) * LDS + kk * 16 + t * 2;
        Mma<T>::mma(s[j], q_regs[kk], lds32(k_frag), lds32(k_frag + 8));
      }
    }

    // scale, softcap, mask; running max
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = n0 + j * 8 + t * 2 + (e & 1);
        s[j][e] = masked_score(p, s[j][e], qpos[e >> 1], kpos);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);
      alpha[r] = __expf(m_row[r] - m_new);
      m_row[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = s[j][e] <= 0.5f * kNegInf ? 0.f : __expf(s[j][e] - m_row[e >> 1]);
        s[j][e] = pe;
        rs[e >> 1] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_row[r] = l_row[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }

    // acc += p v : the score fragments of two neighbouring 8-key blocks are the
    // A fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const T* v_rows = sV + (kk * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
      for (int jn = 0; jn < HD / 8; jn += 2) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, v_rows + jn * 8);
        Mma<T>::mma(o_acc[jn], a, bfrag[0], bfrag[1]);
        Mma<T>::mma(o_acc[jn + 1], a, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();  // this stage is free: the next iteration refills it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    if (row_q[r] < p.Sq) {
      T* orow = og + (long long)row_q[r] * p.o_ss + t * 2;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            Mma<T>::pack(o_acc[j][2 * r] * inv, o_acc[j][2 * r + 1] * inv);
      if (p.lse != nullptr && t == 0)
        p.lse[((long long)b * p.H + h) * p.Sq + row_q[r]] = m_row[r] + logf(fmaxf(l, 1e-30f));
    }
  }
}

// A tile needs (BM + 4 * BN) * (HD + 8) * 2 bytes; a kernel that needs more than the
// default 48 KB is allowed more dynamic shared memory first (once).
template <typename T, int HD, int BM, int BN>
cudaError_t launch_mma(const Params& p, cudaStream_t st) {
  constexpr int smem = (BM + 4 * BN) * (HD + 8) * (int)sizeof(T);  // Q + 2 stages of K, V
  static_assert(HD % 16 == 0 && (HD / 8) % 2 == 0, "k-steps of 16, pairs of 8-column tiles");
  static_assert(smem <= 227 * 1024, "fits one block's shared memory");
  auto kern = flash_fwd_mma_kernel<T, HD, BM, BN>;
  static bool raised = false;  // per instantiation
  cudaError_t e = flash::allow_smem(kern, smem, raised);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + BM - 1) / BM, p.H, p.B);
  kern<<<grid, BM * 2, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_mma(const Params& p, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return (int)launch_mma<T, 16, 64, 64>(p, st);
    case 32: return (int)launch_mma<T, 32, 64, 64>(p, st);
    default: return -1;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and o share one type).
// The kernel a call of that type and head_dim launches: 0 tf32x3
// (flash_attention_fp32.cu), 1 mma.sync, 2 TMA + wgmma (flash_attention_sm90.cu);
// -1 if none is compiled in.
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
    long long o_ss, long long o_sh, int causal, int window, float softcap, int dtype,
    int device, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window;
  p.softcap = softcap;
  p.scale = 1.0f / sqrtf((float)hd);
  flash::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (flash::variant_for(hd, dtype, false)) {
    case flash::kTf32x3: return flash::launch_fwd_tf32x3(p, hd, st);
    case flash::kMmaSync:
      return dtype == 1 ? dispatch_mma<__nv_bfloat16>(p, hd, st) : dispatch_mma<__half>(p, hd, st);
    case flash::kSm90Wgmma: return flash::launch_sm90(p, hd, dtype, st);
    default: return (dtype < 0 || dtype > 2) ? -2 : -1;
  }
}
