// Fused attention in float32 for Hopper (sm_90a): the forward and the backward's two
// passes, on the tensor cores through 3xTF32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel,
// launched by _flash_fwd_kernel_call, and the VJP _flash_vjp_bwd takes of
// mha_reference) for float32 inputs, and computes its contract as stated in
// flash_attention.cu (the masks, the softcap before the mask, lse on request) and
// flash_attention_bwd.cu (the gradients from o and lse, dk and dv summed over each
// KV group).  The C entries of those two files call flash::launch_fwd_tf32x3 and
// flash::launch_bwd_tf32x3 for every float32 call.
//
// Bound on this card: operations.  The tensor cores take float32 only as TF32 (10
// mantissa bits), so each product a * b is three TF32 products accumulated in
// float32: a = a_hi + a_lo with a_hi = a & 0xFFFFE000 (the top 19 bits) and
// a_lo = a - a_hi, and a * b ~ a_lo * b_hi + a_hi * b_lo + a_hi * b_hi (the a_lo * b_lo
// term is below float32's rounding).  That keeps float32's accuracy at 495 / 3 = 165
// TFLOP/s of float32-accurate work against 67 TFLOP/s of float32 FMAs, so the least
// time is 3 x 4 * hd (forward) or 3 x 10 * hd (backward) TF32 operations a visible
// (query, key) pair over 495 TFLOP/s, or the bytes over 3.35 TB/s if that is larger.
// What the design does:
//   * every product is mma.sync.m16n8k8 (TF32 in, float32 accumulated), one warp per
//     16 rows, operands split into hi / lo in registers.  wgmma takes TF32 only K-major
//     from shared memory: the products over keys (P V) and over queries (P^T dO,
//     dS^T Q) would each need a transposed hi / lo copy of their tile, which register
//     fragments do without;
//   * a score fragment becomes the A fragment of the next product in place: its
//     thread holds keys 2t and 2t + 1 of each 8-key block, which the product reads as
//     its k columns t and t + 4, and the B fragment is read from the same two rows
//     (2t, 2t + 1) of the V (dO, Q, K) tile: the keys are summed in another order,
//     with no shuffle;
//   * tiles reach shared memory by TMA, a box for each 32 columns (128-byte swizzle;
//     head_dim 80's and 16's last 16 columns a 64-byte-swizzled box), issued by one
//     thread and completed on mbarriers; two stages, so tile i + 1 lands while tile i
//     is computed.  The swizzle puts every fragment load on 32 distinct banks (sw());
//     rows past the tensor read as zeros, which the masks give zero weight.  (One
//     bulk copy a row into padded rows cost ~40 us a launch_reduced call on an H100
//     80GB HBM3: the TMA unit's per-request cost, 576 requests a block);
//   * the blocks are two groups of 4 warps that split the reduction of each tile or
//     step and add their sums once at the end: each warp's chain of dependent products
//     is half as long, and twice the warps hide it;
//   * forward: one block per (batch, q head, 64-row q tile); the kv loop runs from the
//     window's edge to the diagonal, (acc, m, l) stay in registers, the groups take
//     half of each key tile, and the late (heavy) q tiles start first;
//   * backward: two passes, deterministic (no atomics, no float32 scratch beyond D), so
//     two calls give the same bits.  Pass B (dq) runs first and writes each row's
//     D = rowsum(dO o O) too: one block per (batch, q head, 64-row q tile), dq in
//     registers, the groups taking half of each key tile.  Pass A (dk, dv): one block
//     per (batch, KV head, key tile), looping over the G query heads of the group and
//     the query steps that see its keys; it computes S^T = K Q^T and dP^T = V dO^T, so
//     that P^T and dS^T are already the A operands of dV += P^T dO and dK += dS^T Q,
//     with dK and dV in registers and the groups taking half of each step's rows.  At
//     head_dim 224 and 256 those accumulators do not fit a warp's registers at 16 keys: the
//     tile is 32 keys, two warps of a group on each 16, each holding half of the
//     columns (and each computing S^T and dP^T in full).  Head_dims up to 64 take the
//     same 32-key tiles, so that a short sequence (launch_reduced's 256 keys) spreads
//     over twice the blocks: there a block's issue slots, not its loads, set the pace;
//   * the backward's running sums (dk, dv over the query rows, dq over the keys) are
//     added to with ordinary float adds, one step's products at a time (mma_pn's
//     kParts): the tensor core's accumulation rounds toward zero, and over 28,672
//     rows that drifted past the float32 tolerance;
//   * the mask is applied only where a warp's rows and keys cross its edge
//     (all_visible).
// Tile sizes per head_dim (FwdCfg, DkdvCfg, DqCfg) keep a block of 8 warps within 227
// KB of shared memory; at head_dim 224 and 256 the forward takes 32-key tiles, pass A
// 32-row steps and pass B 16-key tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention.cuh"
#include "sm90.cuh"

namespace {

using flash::BwdParams;
using flash::kNegInf;
using flash::kv_range;
using flash::masked_score;
using flash::Params;
using flash::prob_and_grad;
using flash::all_visible;
using flash::q_range;
using flash::scaled_score;
using flash::visible;
using flash::EncodeTiled;
using flash::mbar_expect_tx;
using flash::mbar_init;
using flash::mbar_wait;
using flash::smem_u32;

// Two groups of four warps: each warp of a group owns 16 rows of the block's output,
// and the two groups split the product's reduction (the keys of each tile, or in
// pass A the query rows of each step), each group summing its own part, added
// together once at the end (merge_*).  That halves the serial work of each warp.
constexpr int kWarps = 4;                // a group's warps
constexpr int kThreads = 2 * kWarps * 32;
constexpr uint32_t kTf32Mask = 0xFFFFE000u;

// ------------------------------------------------------------------ arithmetic

// An A fragment of m16n8k8 (a0: row g, col t; a1: row g + 8, col t; a2: row g,
// col t + 4; a3: row g + 8, col t + 4), split into its TF32 high and low parts.
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ Frag frag(float a0, float a1, float a2, float a3) {
  Frag f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32, b's fragment (b0: k row t, col g; b1: k row t + 4, col g)
// given as float32: the small products first.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// Tiles in shared memory are TMA boxes, one after another: ROWS x 32 floats (128
// bytes a row) under the 128-byte swizzle for each 32 columns, and ROWS x 16 (64
// bytes) under the 64-byte swizzle for head_dim 80's and 16's last 16.  The swizzle
// XORs a row's 16-byte chunk index with the row (bits 7-9 of the address into bits
// 4-6; 64-byte: bits 7-8 into 4-5), so a fragment's eight rows at one column, or its
// four columns of two rows, fall on 32 distinct banks.  The offset in floats of
// column cb + cl of row r, cb a multiple of 8 (known when the loops unroll) and
// cl < 8:
template <int HD, int ROWS>
__device__ __forceinline__ int sw(int r, int cb, int cl) {
  constexpr int kWide = HD / 32 * 32;
  if (HD % 32 == 0 || cb < kWide) {
    const int c = (cb & 31) + cl;
    return (cb >> 5) * (ROWS * 32) + r * 32 + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
  }
  const int c = cb - kWide + cl;
  return kWide * ROWS + r * 16 + (((c >> 2) ^ ((r >> 1) & 3)) << 2) + (c & 3);
}

// acc (16 x N) = A B^T over HD: A rows [ra, ra + 16) of a tile of RA rows at `a`, B
// rows [rb, rb + N) of one of RB rows at `b` (both read along the head_dim: the "NT"
// product of Q K^T, dO V^T, K Q^T and V dO^T).
template <int HD, int N, int RA, int RB>
__device__ __forceinline__ void mma_nt(float (&acc)[N / 8][4], const float* a, int ra,
                                       const float* b, int rb, int g, int t) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const int r0 = ra + g, r1 = ra + g + 8;
    const Frag fa = frag(a[sw<HD, RA>(r0, kk * 8, t)], a[sw<HD, RA>(r1, kk * 8, t)],
                         a[sw<HD, RA>(r0, kk * 8, t + 4)], a[sw<HD, RA>(r1, kk * 8, t + 4)]);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int r = rb + j * 8 + g;
      mma3(acc[j], fa, b[sw<HD, RB>(r, kk * 8, t)], b[sw<HD, RB>(r, kk * 8, t + 4)]);
    }
  }
}

// acc (16 x N) += P B over K, with P in registers as score fragments (C layout:
// p[kk][0..1] row g, keys 8kk + 2t, 2t + 1; p[kk][2..3] row g + 8) and B the K rows
// [rb, rb + K) of a tile of RB rows at `b`, columns [c0, c0 + N).  The k columns t,
// t + 4 of each step are keys 2t, 2t + 1, so B's fragment is read from those rows.
// kParts: the products go to a zeroed part of two output blocks at a time, which is
// then added to acc with ordinary float adds.  The tensor core's own accumulation
// rounds toward zero; over the backward's long sums (dk and dv over every query row
// of a KV group: 28,672 at qwen2-7b's 4096 tokens) that drifts: on an H100 80GB
// HBM3, 1.36e-4 of the largest dk there with acc inside the mma, against at most
// 1e-5 at a few hundred rows.
template <int HD, int K, int N, int RB, bool kParts = false>
__device__ __forceinline__ void mma_pn(float (&acc)[N / 8][4], const float (&p)[K / 8][4],
                                       const float* b, int rb, int c0, int g, int t) {
  Frag fa[K / 8];
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) fa[kk] = frag(p[kk][0], p[kk][2], p[kk][1], p[kk][3]);
  if constexpr (!kParts) {
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      const int r0 = rb + kk * 8 + 2 * t;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        mma3(acc[j], fa[kk], b[sw<HD, RB>(r0, c0 + j * 8, g)],
             b[sw<HD, RB>(r0 + 1, c0 + j * 8, g)]);
    }
  } else {
    constexpr int C = N / 8 < 2 ? N / 8 : 2;
#pragma unroll
    for (int j0 = 0; j0 < N / 8; j0 += C) {
      float part[C][4];
      zero(part);
#pragma unroll
      for (int kk = 0; kk < K / 8; ++kk) {
        const int r0 = rb + kk * 8 + 2 * t;
#pragma unroll
        for (int jj = 0; jj < C; ++jj) {
          const int col = c0 + (j0 + jj) * 8;
          mma3(part[jj], fa[kk], b[sw<HD, RB>(r0, col, g)], b[sw<HD, RB>(r0 + 1, col, g)]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < C; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j0 + jj][e] += part[jj][e];
    }
  }
}

// ------------------------------------------------------------------ loads

// The tensor maps of one call: for q, k, v (and dO), one with 32-column boxes and,
// at head_dim 80 and 16, one with the last 16 columns' box (zeros where unused).
struct Maps {
  CUtensorMap wide[4], narrow[4];
};
enum { kMq = 0, kMk = 1, kMv = 2, kMdo = 3 };

// The TMA loads of rows [row0, row0 + ROWS) of head `h`, batch `b` of tensor `m` into
// a tile at `dst` (rows past the tensor read as zeros); they complete on `bar`, which
// counts ROWS * HD * 4 bytes.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const Maps& maps, int m, uint32_t bar,
                                          int row0, int h, int b) {
#pragma unroll
  for (int x = 0; x < HD / 32; ++x)
    flash::tma_load_4d(smem_u32(dst + x * ROWS * 32), &maps.wide[m], bar, x * 32, row0, h, b);
  if constexpr (HD % 32 != 0)
    flash::tma_load_4d(smem_u32(dst + HD / 32 * ROWS * 32), &maps.narrow[m], bar, HD / 32 * 32,
                       row0, h, b);
}

// The block's shared memory from its first 1024-byte boundary (the swizzle's period),
// and its barriers, all initialised (one arrival each: the expect_tx).
__device__ __forceinline__ float* aligned_base(unsigned char* raw) {
  return reinterpret_cast<float*>(raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u));
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The end of a split: group 1 leaves its accumulators in `x` (tile memory that no
// load writes any more, 128 * N * 4 floats), and group 0 adds them to its own, in
// that order (the same bits every call).  Every thread of the block calls it.
template <int N>
__device__ __forceinline__ void merge_sum(float (&acc)[N][4], float* x, int grp, int gt) {
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[(j * 4 + e) * 128 + gt] = acc[j][e];
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += x[(j * 4 + e) * 128 + gt];
  }
}

// ------------------------------------------------------------------ forward

template <int HD>
struct FwdCfg {
  static constexpr int BM = 16 * kWarps;               // query rows a block
  static constexpr int BN = HD >= 224 ? 32 : 64;       // keys a tile, half a group
  static constexpr int kStages = 2;                    // K/V tiles in flight
  static constexpr int kQ = BM * HD, kTile = BN * HD;  // floats
  static constexpr int kBars = 1 + kStages;            // Q, each K/V stage
  static constexpr int kSmem = 1024 + (kQ + 2 * kStages * kTile) * 4 + kBars * 8;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tf32x3_kernel(const __grid_constant__ Maps maps, const Params p) {
  using C = FwdCfg<HD>;
  constexpr int BM = C::BM, BN = C::BN, kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* sQ = aligned_base(smem_raw);
  float* sKV = sQ + C::kQ;  // stage s: its K tile, then its V tile
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + 2 * kStages * C::kTile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // group grp takes keys [grp * KH, grp * KH + KH) of each tile; warp wq of each group
  // rows [16 wq, 16 wq + 16)
  constexpr int KH = BN / 2;
  const int grp = warp / kWarps, wq = warp % kWarps, gt = tid % (kWarps * 32);
  const int qt = gridDim.x - 1 - blockIdx.x;  // late tiles do the most work: start them first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * BM;
  const int offset = p.Skv - p.Sq;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  int kv_lo, kv_hi;
  kv_range(p, q0, BM, BN, kv_lo, kv_hi);
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BN - 1) / BN : 0;

  init_barriers(bars, C::kBars);
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto issue_kv = [&](int s, int n0) {  // one thread
    const uint32_t bar = smem_u32(&bars[1 + s]);
    mbar_expect_tx(bar, 2 * BN * HD * 4);
    float* sK = sKV + s * 2 * C::kTile;
    load_tile<HD, BN>(sK, maps, kMk, bar, n0, kvh, b);
    load_tile<HD, BN>(sK + C::kTile, maps, kMv, bar, n0, kvh, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, BM * HD * 4);
    load_tile<HD, BM>(sQ, maps, kMq, bar_q, q0, h, b);
    for (int i = 0; i < kStages - 1 && i < ntiles; ++i) issue_kv(i, kv_lo + i * BN);
  }

  float o_acc[HD / 8][4];
  zero(o_acc);
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};  // per-thread partial sums, reduced over the quad at the end
  const int row_q[2] = {q0 + wq * 16 + g, q0 + wq * 16 + g + 8};
  const int qpos[2] = {row_q[0] + offset, row_q[1] + offset};

  mbar_wait(bar_q, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages, n0 = kv_lo + i * BN;
    // tile i + kStages - 1 goes into the stage that the barrier ending the previous
    // iteration freed
    const int ahead = i + kStages - 1;
    if (tid == 0 && ahead < ntiles) issue_kv(ahead % kStages, kv_lo + ahead * BN);
    mbar_wait(smem_u32(&bars[1 + s]), (i / kStages) & 1);
    const float* sK = sKV + s * 2 * C::kTile;
    const float* sV = sK + C::kTile;

    float sc[KH / 8][4];
    mma_nt<HD, KH, BM, BN>(sc, sQ, wq * 16, sK, grp * KH, g, t);

    float mx[2] = {kNegInf, kNegInf};
    // the mask only where the warp's rows and the group's keys cross its edge
    auto mask = [&](auto inside) {
#pragma unroll
      for (int j = 0; j < KH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = n0 + grp * KH + j * 8 + t * 2 + (e & 1);
          sc[j][e] = decltype(inside)::value ? scaled_score(p, sc[j][e])
                                             : masked_score(p, sc[j][e], qpos[e >> 1], kpos);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
    };
    if (all_visible(p, q0 + wq * 16, 16, n0 + grp * KH, KH)) mask(std::true_type{});
    else mask(std::false_type{});
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);
      alpha[r] = expf(m_row[r] - m_new);
      m_row[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = sc[j][e] <= 0.5f * kNegInf ? 0.f : expf(sc[j][e] - m_row[e >> 1]);
        sc[j][e] = pe;
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
    mma_pn<HD, KH, HD, BN>(o_acc, sc, sV, grp * KH, 0, g, t);
    __syncthreads();  // this stage is free: the next iteration refills it
  }

  // group 1's (m, l, acc) into group 0's, both rescaled to the larger maximum (the
  // stages hold no tile any more: every load issued was waited for)
  float* x = sKV;
  if (grp == 1) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[(j * 4 + e) * 128 + gt] = o_acc[j][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      x[(HD / 2 + r) * 128 + gt] = m_row[r];
      x[(HD / 2 + 2 + r) * 128 + gt] = l_row[r];
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = x[(HD / 2 + r) * 128 + gt], l1 = x[(HD / 2 + 2 + r) * 128 + gt];
    const float m = fmaxf(m_row[r], m1);
    const float a0 = expf(m_row[r] - m), a1 = expf(m1 - m);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e)
        o_acc[j][e] = o_acc[j][e] * a0 + x[(j * 4 + e) * 128 + gt] * a1;
    l_row[r] = l_row[r] * a0 + l1 * a1;
    m_row[r] = m;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    if (row_q[r] < p.Sq) {
      float* orow = og + (long long)row_q[r] * p.o_ss + t * 2;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(orow + j * 8) =
            make_float2(o_acc[j][2 * r] * inv, o_acc[j][2 * r + 1] * inv);
      if (p.lse != nullptr && t == 0)
        p.lse[((long long)b * p.H + h) * p.Sq + row_q[r]] = m_row[r] + logf(fmaxf(l, 1e-30f));
    }
  }
}

// ------------------------------------------------------------------ backward

// Pass A (dk, dv): BN keys a block (16 a warp of each group; at head_dim 256 two
// warps on each 16, kCols columns each), BMQ query rows a step, half of them for
// each group.
template <int HD>
struct DkdvCfg {
  static constexpr int kSplit = HD <= 64 || HD >= 224 ? 2 : 1;  // warps sharing 16 keys
  static constexpr int BN = 16 * kWarps / kSplit;
  static constexpr int kCols = HD / kSplit;             // dk / dv columns a warp holds
  static constexpr int BMQ = HD >= 224 ? 32 : 64;
  static constexpr int kStages = 2;                      // Q/dO steps in flight
  static constexpr int kKV = BN * HD, kStep = BMQ * HD;  // floats
  static constexpr int kBars = 1 + kStages;              // K/V, each Q/dO stage
  static constexpr int kSmem = 1024 + (2 * kKV + 2 * kStages * kStep) * 4 + kBars * 8;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_tf32x3_kernel(const __grid_constant__ Maps maps, const BwdParams p) {
  using C = DkdvCfg<HD>;
  constexpr int BN = C::BN, BMQ = C::BMQ, NC = C::kCols, kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* sK = aligned_base(smem_raw);
  float* sV = sK + C::kKV;
  float* sQD = sV + C::kKV;  // stage s: its Q tile, then its dO tile
  uint64_t* bars = reinterpret_cast<uint64_t*>(sQD + 2 * kStages * C::kStep);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // group grp takes query rows [grp * MH, grp * MH + MH) of each step
  constexpr int MH = BMQ / 2;
  const int grp = warp / kWarps, wq = warp % kWarps, gt = tid % (kWarps * 32);
  const int kw = wq % (kWarps / C::kSplit);  // the warp's 16 keys
  const int c0 = C::kSplit == 1 ? 0 : (wq / (kWarps / C::kSplit)) * NC;  // ... its first column
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n0 = blockIdx.x * BN;  // early key tiles see the most rows: they start first
  const int G = p.H / p.KV;

  int lo, hi;
  q_range(p, n0, BN, BMQ, lo, hi);
  const int per_head = hi > lo ? (hi - lo + BMQ - 1) / BMQ : 0;
  const int nsteps = G * per_head;

  init_barriers(bars, C::kBars);
  auto issue_qd = [&](int s, int i) {  // one thread
    const int h = kvh * G + i / per_head, m0 = lo + (i % per_head) * BMQ;
    const uint32_t bar = smem_u32(&bars[1 + s]);
    mbar_expect_tx(bar, 2 * BMQ * HD * 4);
    float* sQ = sQD + s * 2 * C::kStep;
    load_tile<HD, BMQ>(sQ, maps, kMq, bar, m0, h, b);
    load_tile<HD, BMQ>(sQ + C::kStep, maps, kMdo, bar, m0, h, b);
  };
  if (tid == 0) {
    const uint32_t bar = smem_u32(&bars[0]);
    mbar_expect_tx(bar, 2 * BN * HD * 4);
    load_tile<HD, BN>(sK, maps, kMk, bar, n0, kvh, b);
    load_tile<HD, BN>(sV, maps, kMv, bar, n0, kvh, b);
    for (int i = 0; i < kStages - 1 && i < nsteps; ++i) issue_qd(i, i);
  }

  float dk[NC / 8][4], dv[NC / 8][4];
  zero(dk);
  zero(dv);
  const int key[2] = {n0 + kw * 16 + g, n0 + kw * 16 + g + 8};

  mbar_wait(smem_u32(&bars[0]), 0);
  for (int i = 0; i < nsteps; ++i) {
    const int s = i % kStages;
    const int h = kvh * G + i / per_head, m0 = lo + (i % per_head) * BMQ;
    const int ahead = i + kStages - 1;  // into the stage the last barrier freed
    if (tid == 0 && ahead < nsteps) issue_qd(ahead % kStages, ahead);
    // this thread's query columns' lse and D (rows 8j + 2t, 8j + 2t + 1 of its half)
    const long long row0 = ((long long)b * p.H + h) * p.Sq;
    const int mg = m0 + grp * MH;
    float lse[MH / 8][2], dlt[MH / 8][2];
#pragma unroll
    for (int j = 0; j < MH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = mg + j * 8 + 2 * t + e;
        lse[j][e] = row < p.Sq ? p.lse[row0 + row] : 0.f;
        dlt[j][e] = row < p.Sq ? p.delta[row0 + row] : 0.f;
      }
    mbar_wait(smem_u32(&bars[1 + s]), (i / kStages) & 1);
    const float* sQ = sQD + s * 2 * C::kStep;
    const float* sD = sQ + C::kStep;

    float st[MH / 8][4], dpt[MH / 8][4];  // S^T and dP^T: keys x query rows
    mma_nt<HD, MH, BN, BMQ>(st, sK, kw * 16, sQ, grp * MH, g, t);
    mma_nt<HD, MH, BN, BMQ>(dpt, sV, kw * 16, sD, grp * MH, g, t);
    auto grads = [&](auto inside) {  // the mask only where the step crosses its edge
#pragma unroll
      for (int j = 0; j < MH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mg + j * 8 + 2 * t + (e & 1);
          float pe, ds;
          prob_and_grad(p, decltype(inside)::value || visible(p, row, key[e >> 1]), st[j][e],
                        lse[j][e & 1], dlt[j][e & 1], dpt[j][e], pe, ds);
          st[j][e] = pe;
          dpt[j][e] = ds;
        }
    };
    if (all_visible(p, mg, MH, n0 + kw * 16, 16)) grads(std::true_type{});
    else grads(std::false_type{});
    mma_pn<HD, MH, NC, BMQ, true>(dv, st, sD, grp * MH, c0, g, t);
    mma_pn<HD, MH, NC, BMQ, true>(dk, dpt, sQ, grp * MH, c0, g, t);
    __syncthreads();  // this stage is free: the next iteration refills it
  }
  merge_sum(dk, sQD, grp, gt);
  merge_sum(dv, sQD, grp, gt);
  if (grp == 1) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.Skv) continue;
    float* dkr = static_cast<float*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh +
                 (long long)key[r] * p.dk_ss + c0 + 2 * t;
    float* dvr = static_cast<float*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh +
                 (long long)key[r] * p.dv_ss + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      *reinterpret_cast<float2*>(dkr + j * 8) =
          make_float2(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<float2*>(dvr + j * 8) = make_float2(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// Pass B (dq): 64 query rows a block (16 a warp of each group), BN keys a tile, half
// of them for each group.  It computes D for its rows too, and runs before pass A.
template <int HD>
struct DqCfg {
  static constexpr int BM = 16 * kWarps;
  static constexpr int BN = HD >= 224 ? 16 : 64;
  static constexpr int kStages = 2;                       // K/V tiles in flight
  static constexpr int kRows = BM * HD, kTile = BN * HD;  // floats
  static constexpr int kBars = 1 + kStages;               // Q/dO, each K/V stage
  static constexpr int kSmem = 1024 + (2 * kRows + 2 * kStages * kTile) * 4 + kBars * 8;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tf32x3_kernel(const __grid_constant__ Maps maps, const BwdParams p) {
  using C = DqCfg<HD>;
  constexpr int BM = C::BM, BN = C::BN, kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* sQ = aligned_base(smem_raw);
  float* sD = sQ + C::kRows;
  float* sKV = sD + C::kRows;  // stage s: its K tile, then its V tile
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + 2 * kStages * C::kTile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int KH = BN / 2;
  const int grp = warp / kWarps, wq = warp % kWarps, gt = tid % (kWarps * 32);
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * BM;
  int kv_lo, kv_hi;
  kv_range(p, q0, BM, BN, kv_lo, kv_hi);
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BN - 1) / BN : 0;

  init_barriers(bars, C::kBars);
  auto issue_kv = [&](int s, int n0) {  // one thread
    const uint32_t bar = smem_u32(&bars[1 + s]);
    mbar_expect_tx(bar, 2 * BN * HD * 4);
    float* sK = sKV + s * 2 * C::kTile;
    load_tile<HD, BN>(sK, maps, kMk, bar, n0, kvh, b);
    load_tile<HD, BN>(sK + C::kTile, maps, kMv, bar, n0, kvh, b);
  };
  if (tid == 0) {
    const uint32_t bar = smem_u32(&bars[0]);
    mbar_expect_tx(bar, 2 * BM * HD * 4);
    load_tile<HD, BM>(sQ, maps, kMq, bar, q0, h, b);
    load_tile<HD, BM>(sD, maps, kMdo, bar, q0, h, b);
    for (int i = 0; i < kStages - 1 && i < ntiles; ++i) issue_kv(i, kv_lo + i * BN);
  }

  const int row[2] = {q0 + wq * 16 + g, q0 + wq * 16 + g + 8};
  const long long row0 = ((long long)b * p.H + h) * p.Sq;
  float lse[2], dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) lse[r] = row[r] < p.Sq ? p.lse[row0 + row[r]] : 0.f;
  {
    // D = rowsum(dO o O) of the warp's 16 rows, two lanes a row (half of its columns
    // each, 16-byte loads); group 0 leaves it in delta for pass A, which runs after
    // this pass
    const int r = q0 + wq * 16 + (lane >> 1);
    float d = 0.f;
    if (r < p.Sq) {
      const int c0 = (lane & 1) * (HD / 2);
      const float* orow = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
      const float* drow = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
      const float4* o4 = reinterpret_cast<const float4*>(orow + (long long)r * p.o_ss + c0);
      const float4* d4 = reinterpret_cast<const float4*>(drow + (long long)r * p.do_ss + c0);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const float4 x = o4[c], y = d4[c];
        d += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    dlt[0] = __shfl_sync(0xffffffffu, d, 2 * g);
    dlt[1] = __shfl_sync(0xffffffffu, d, 2 * g + 16);
    if (grp == 0 && (lane & 1) == 0 && r < p.Sq) p.delta[row0 + r] = d;
  }
  float dq[HD / 8][4];
  zero(dq);

  mbar_wait(smem_u32(&bars[0]), 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages, n0 = kv_lo + i * BN;
    const int ahead = i + kStages - 1;  // into the stage the last barrier freed
    if (tid == 0 && ahead < ntiles) issue_kv(ahead % kStages, kv_lo + ahead * BN);
    mbar_wait(smem_u32(&bars[1 + s]), (i / kStages) & 1);
    const float* sK = sKV + s * 2 * C::kTile;
    const float* sV = sK + C::kTile;

    float sc[KH / 8][4], dp[KH / 8][4];
    mma_nt<HD, KH, BM, BN>(sc, sQ, wq * 16, sK, grp * KH, g, t);
    mma_nt<HD, KH, BM, BN>(dp, sD, wq * 16, sV, grp * KH, g, t);
    auto grads = [&](auto inside) {  // the mask only where the tile crosses its edge
#pragma unroll
      for (int j = 0; j < KH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = n0 + grp * KH + j * 8 + 2 * t + (e & 1);
          float pe, ds;
          prob_and_grad(p, decltype(inside)::value || visible(p, row[r], key), sc[j][e], lse[r],
                        dlt[r], dp[j][e], pe, ds);
          sc[j][e] = ds;
        }
    };
    if (all_visible(p, q0 + wq * 16, 16, n0 + grp * KH, KH)) grads(std::true_type{});
    else grads(std::false_type{});
    mma_pn<HD, KH, HD, BN, true>(dq, sc, sK, grp * KH, 0, g, t);
    __syncthreads();  // this stage is free: the next iteration refills it
  }
  merge_sum(dq, sKV, grp, gt);
  if (grp == 1) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Sq) continue;
    float* dqr = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
                 (long long)row[r] * p.dq_ss + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(dqr + j * 8) =
          make_float2(dq[j][2 * r] * p.scale, dq[j][2 * r + 1] * p.scale);
  }
}

// ------------------------------------------------------------------ launchers

// The maps of one float32 tensor with element strides (ss, sh, sb): its 32-column
// boxes under the 128-byte swizzle and, where the head_dim has 16 more, that box
// under the 64-byte one.  False when TMA cannot describe the tensor (a row off a
// 16-byte boundary).
bool encode_f32(EncodeTiled fn, Maps& maps, int m, const void* ptr, int hd, int seq, int heads,
                int batch, long long ss, long long sh, long long sb, int rows) {
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (hd >= 32 && !flash::encode(fn, &maps.wide[m], ptr, f32, hd, seq, heads, batch, ss, sh, sb,
                                 rows, 32, CU_TENSOR_MAP_SWIZZLE_128B, 4))
    return false;
  return hd % 32 == 0 || flash::encode(fn, &maps.narrow[m], ptr, f32, hd, seq, heads, batch, ss,
                                       sh, sb, rows, 16, CU_TENSOR_MAP_SWIZZLE_64B, 4);
}

// Raises the kernel's dynamic shared-memory limit once (when it needs more than the
// default 48 KB), then launches it.
template <typename P>
cudaError_t launch(void (*kern)(Maps, P), int smem, bool& raised, dim3 grid, const Maps& maps,
                   const P& p, cudaStream_t st) {
  if (smem > 48 * 1024 && !raised) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  kern<<<grid, kThreads, smem, st>>>(maps, p);
  return cudaGetLastError();
}

template <int HD>
int launch_fwd(const Params& p, cudaStream_t st) {
  using C = FwdCfg<HD>;
  static_assert(C::kSmem <= 227 * 1024, "fits one block's shared memory");
  EncodeTiled fn = flash::encode_tiled();
  if (fn == nullptr) return -4;
  Maps maps{};
  if (!encode_f32(fn, maps, kMq, p.q, HD, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, C::BM) ||
      !encode_f32(fn, maps, kMk, p.k, HD, p.Skv, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, C::BN) ||
      !encode_f32(fn, maps, kMv, p.v, HD, p.Skv, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, C::BN))
    return -3;
  static bool raised = false;
  dim3 grid((p.Sq + C::BM - 1) / C::BM, p.H, p.B);
  return (int)launch(flash_fwd_tf32x3_kernel<HD>, C::kSmem, raised, grid, maps, p, st);
}

// Pass B (dq, and D for pass A) runs first, then pass A (dk, dv).  Pass A reads Q and
// dO in steps of BMQ rows and K and V in tiles of its BN keys; pass B the other way
// round: two sets of maps.
template <int HD>
int launch_bwd(const BwdParams& p, cudaStream_t st) {
  using A = DkdvCfg<HD>;
  using Q = DqCfg<HD>;
  static_assert(A::kSmem <= 227 * 1024 && Q::kSmem <= 227 * 1024, "fits shared memory");
  EncodeTiled fn = flash::encode_tiled();
  if (fn == nullptr) return -4;
  Maps ma{}, mq{};
  auto encode_all = [&](Maps& m, int q_rows, int kv_rows) {
    return encode_f32(fn, m, kMq, p.q, HD, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, q_rows) &&
           encode_f32(fn, m, kMdo, p.dout, HD, p.Sq, p.H, p.B, p.do_ss, p.do_sh, p.do_sb,
                      q_rows) &&
           encode_f32(fn, m, kMk, p.k, HD, p.Skv, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, kv_rows) &&
           encode_f32(fn, m, kMv, p.v, HD, p.Skv, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, kv_rows);
  };
  // o is read by 16-byte loads (pass B's D): its rows on 16-byte boundaries too
  const bool o_rows = reinterpret_cast<uintptr_t>(p.o) % 16 == 0 && p.o_sb % 4 == 0 &&
                      p.o_ss % 4 == 0 && p.o_sh % 4 == 0;
  if (!o_rows || !encode_all(ma, A::BMQ, A::BN) || !encode_all(mq, Q::BM, Q::BN)) return -3;
  static bool raised_a = false, raised_q = false;
  cudaError_t e = launch(flash_bwd_dq_tf32x3_kernel<HD>, Q::kSmem, raised_q,
                         dim3((p.Sq + Q::BM - 1) / Q::BM, p.H, p.B), mq, p, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch(flash_bwd_dkdv_tf32x3_kernel<HD>, A::kSmem, raised_a,
                     dim3((p.Skv + A::BN - 1) / A::BN, p.KV, p.B), ma, p, st);
}

}  // namespace

namespace flash {

int launch_fwd_tf32x3(const Params& p, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_fwd<16>(p, st);
    case 32: return launch_fwd<32>(p, st);
    case 64: return launch_fwd<64>(p, st);
    case 80: return launch_fwd<80>(p, st);
    case 128: return launch_fwd<128>(p, st);
    case 224: return launch_fwd<224>(p, st);
    case 256: return launch_fwd<256>(p, st);
    default: return -1;
  }
}

int launch_bwd_tf32x3(const BwdParams& p, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_bwd<16>(p, st);
    case 32: return launch_bwd<32>(p, st);
    case 64: return launch_bwd<64>(p, st);
    case 80: return launch_bwd<80>(p, st);
    case 128: return launch_bwd<128>(p, st);
    case 224: return launch_bwd<224>(p, st);
    case 256: return launch_bwd<256>(p, st);
    default: return -1;
  }
}

}  // namespace flash
