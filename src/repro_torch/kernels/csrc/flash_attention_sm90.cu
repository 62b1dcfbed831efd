// Fused attention forward for Hopper (sm_90a): TMA + wgmma, warp-specialised.
// 16-bit inputs (bf16, fp16) at head_dim 64 and 128; plain C++ launcher called
// from repro_flash_attention_fwd (flash_attention.cu) through flash::launch_sm90.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel,
// launched by _flash_fwd_kernel_call) for those shapes, with its contract as
// flash_attention.cu states it: q (B,Sq,H,hd), k/v (B,Skv,KV,hd), H % KV == 0,
// scale 1/sqrt(hd), softcap before the mask, causal qpos >= kpos with qpos offset
// by Skv - Sq, window qpos - kpos < window with or without causal, p = 0 where
// s <= -5e29, result acc / max(l, 1e-30), lse = m + log(l) per row when asked,
// Sq <= Skv, ragged Sq and Skv.
//
// Bound on this card: operations.  At the prefill shape (S = 2048, hd = 128) the
// two products do ~S*hd/2 flops per byte of q/k/v/o, far above the ~295 flop/byte
// ridge; the tensor cores are the limit, and only wgmma reaches their full rate.
// What the mma.sync kernel ran into (PERF.md): every warp loaded its
// fragments from shared memory and issued its products in order, so it was bound
// by latency inside the warp at ~3,050 cycles per 64x64 tile against ~1,100 for
// the tensor cores.  What this design does about it (FlashAttention-3's shape):
//   * a persistent grid, one block per SM, each walking work tiles of (128-row q
//     tile, q head, batch), latest q tiles first so the heaviest go out first;
//     3 warpgroups: warpgroup 0 is the producer (setmaxnreg.dec to 40; one thread
//     issues every TMA load), warpgroups 1 and 2 are consumers of 64 query rows
//     each (setmaxnreg.inc 232);
//   * two Q buffers: the next work tile's Q and first K/V tiles land while the
//     consumers finish the current one's last P V and store its output, so a
//     short causal work tile does not pay its loads in the open;
//   * TMA brings each Q tile once and K/V tiles of 128 keys through a two-stage
//     ring in shared memory, 128-byte swizzled, a 128-wide head as two 64-column
//     boxes; full[stage] barriers count the bytes, empty[stage] barriers one
//     arrival per consumer warp, separately for K and V so the next K tile can
//     land while the current V tile is still read;
//   * S = Q K^T is wgmma m64n128k16 with both operands read from shared memory
//     through descriptors (no fragment loads at all), fp32 accumulation;
//   * the online softmax stays in registers; tiles that no mask touches (not on
//     the diagonal, the window's edge or the ragged tail, no softcap) skip the
//     per-element mask, and scale * log2(e) is folded into one FFMA before ex2;
//   * inside a warpgroup, tile i's softmax runs while tile i-1's P V product is
//     on the tensor cores (S_i and P_{i-1} V_{i-1} are issued together, only S_i
//     is waited for before the softmax), and O is rescaled once P V is done;
//   * O += P V is wgmma m64n{hd}k16 with A = P taken from registers (the score
//     accumulator re-packed to 16 bits, the layouts line up register for
//     register) and B = V from shared memory, MN-major (transpose bit set);
//   * the kv loop runs from the window's edge to the diagonal;
//   * rows past Sq / Skv are zero-filled by TMA; the kpos < Skv mask term stays
//     (a zero key scores 0, not -inf); rows >= Sq are not stored.
// Not done yet (ROADMAP K2-fast): head_dim 256; wider kv tiles for head_dim 64.
// Letting the two consumer warpgroups take strict turns at the tensor cores
// (named barriers) was measured and gained nothing at the prefill shape.
// A barrier wait that never completes traps after 4 s instead of hanging the card.
// The PTX helpers, wgmma instructions and the tensor-map encoder are sm90.cuh's,
// shared with the backward (flash_attention_bwd_sm90.cu).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "sm90.cuh"

namespace flash {
namespace {

constexpr int kBM = 128;          // query rows per block (two consumer warpgroups)
constexpr int kBN = 128;          // keys per K/V tile
constexpr int kStages = 2;
constexpr int kThreads = 384;     // producer + two consumer warpgroups

// ----------------------------------------------------------------------- kernel

template <int HD>
struct Smem {
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;   // one K or one V tile
  static constexpr int kQ = 0;                    // two Q tiles: the next tile's Q
  static constexpr int kK = kQ + 2 * kQBytes;     // lands while this one's runs
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // barriers: q_full[2], q_empty[2], k_full[2], v_full[2], k_empty[2], v_empty[2]
  static constexpr int kBytes = kBar + 16 * 8;
  static constexpr int kAlloc = kBytes + 1024;    // room to align the base to 1024
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using S = Smem<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // every tile starts on a 1024-byte boundary: the swizzle pattern's period
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + S::kBar;
  auto sQ = [&](int u) { return base + S::kQ + u * S::kQBytes; };
  auto q_full = [&](int u) { return bar + 8 * (0 + u); };
  auto q_empty = [&](int u) { return bar + 8 * (2 + u); };
  auto k_full = [&](int s) { return bar + 8 * (4 + s); };
  auto v_full = [&](int s) { return bar + 8 * (6 + s); };
  auto k_empty = [&](int s) { return bar + 8 * (8 + s); };
  auto v_empty = [&](int s) { return bar + 8 * (10 + s); };
  auto sK = [&](int s) { return base + S::kK + s * S::kKVBytes; };
  auto sV = [&](int s) { return base + S::kV + s * S::kKVBytes; };

  // Persistent: work tile w is (q tile, head, batch) with the q tile outermost
  // and latest first, so the heaviest tiles of every head are handed out first.
  // Round j gives the blocks the next gridDim.x work tiles, in turn forwards and
  // backwards (a block that got a heavier tile in one round gets a lighter one in
  // the next): the most work a block gets is ~1.5 % above the mean at the
  // prefill shape, against ~7 % for plain round robin.
  const int n_qt = (p.Sq + kBM - 1) / kBM;
  const int n_work = n_qt * p.H * p.B;
  struct Work {
    int q0, h, b, kvh, kv_lo, n_tiles;
  };
  auto work_index = [&](int j) {
    const int n = gridDim.x, i = blockIdx.x;
    return j * n + ((j & 1) ? n - 1 - i : i);
  };
  auto work = [&](int w) {
    Work t;
    const int hb = w % (p.H * p.B);
    t.q0 = (n_qt - 1 - w / (p.H * p.B)) * kBM;
    t.h = hb % p.H;
    t.b = hb / p.H;
    t.kvh = t.h / (p.H / p.KV);
    int kv_hi;
    kv_range(p, t.q0, kBM, kBN, t.kv_lo, kv_hi);
    t.n_tiles = kv_hi > t.kv_lo ? (kv_hi - t.kv_lo + kBN - 1) / kBN : 0;
    return t;
  };

  if (threadIdx.x == 0) {
    for (int u = 0; u < 2; ++u) {
      mbar_init(q_full(u), 1);
      mbar_init(q_empty(u), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_k))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_v))
                   : "memory");
      // j: this block's work tiles so far; g: K/V tiles so far (the ring's
      // position and phase run on across work tiles)
      int g = 0;
      for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
        const Work t = work(w);
        const int u = j & 1;
        mbar_wait(q_empty(u), ((j >> 1) & 1) ^ 1);  // work tiles 0, 1: fresh barriers pass
        mbar_expect_tx(q_full(u), S::kQBytes);
#pragma unroll
        for (int x = 0; x < S::kBoxes; ++x)
          tma_load_4d(sQ(u) + x * kBM * 128, &tm_q, q_full(u), x * kBoxCols, t.q0, t.h, t.b);
        for (int i = 0; i < t.n_tiles; ++i, ++g) {
          const int s = g & 1;
          const uint32_t parity = ((g >> 1) & 1) ^ 1;
          const int n0 = t.kv_lo + i * kBN;
          mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), S::kKVBytes);
#pragma unroll
          for (int x = 0; x < S::kBoxes; ++x)
            tma_load_4d(sK(s) + x * kBN * 128, &tm_k, k_full(s), x * kBoxCols, n0, t.kvh, t.b);
          mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), S::kKVBytes);
#pragma unroll
          for (int x = 0; x < S::kBoxes; ++x)
            tma_load_4d(sV(s) + x * kBN * 128, &tm_v, v_full(s), x * kBoxCols, n0, t.kvh, t.b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;                     // which 64 rows of the tile
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int offset = p.Skv - p.Sq;
    const float sl2 = p.scale * kLog2e;
    // of the current work tile: its Q buffer, this warpgroup's first query row,
    // this thread's two rows and their positions
    uint32_t q_tile;
    int r_lo, row[2], qpos[2];

    float o[HD / 2];
    float m_row[2];  // in units of the scaled score
    float l_row[2];  // this thread's partial sums

    float sc[kBN / 2];  // scores, then probabilities, of the current tile
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;

    uint32_t pa[kBN / 16][4];  // P of the previous tile, the A operand of its P V

    // S = Q K^T for the tile in stage s: 64 rows x 128 keys, K-major A and B,
    // 32 bytes a k16 step, the second 64 columns of a 128-wide head in the next box
    auto issue_qk = [&](int s) {
      const uint64_t qd = opaque(smem_desc(q_tile + c * 64 * 128, 16, 1024));
      const uint64_t kd = opaque(smem_desc(sK(s), 16, 1024));
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t box = (kk >> 2) * 128, in = (kk & 3) * 32;  // bytes; >> 4 below
        Wg<T>::template ss<kBN>(sc, qd + ((box * kBM + in) >> 4), kd + ((box * kBN + in) >> 4),
                                kk > 0);
      }
      wgmma_commit();
    };
    // O += P V for the tile in stage s: V is MN-major, 16 keys are two 8-row
    // groups (SBO 1024), the second 64 columns of a 128-wide head the next box (LBO)
    auto issue_pv = [&](int s) {
      const uint64_t vd = opaque(smem_desc(sV(s), kBN * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        Wg<T>::template rs<HD>(o, pa[kk], vd + ((kk * 16 * 128) >> 4), 1);
      wgmma_commit();
    };
    // after a P V group was waited on: O and P may be touched again
    auto pv_done = [&](int s) {
      pin(o);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
      mbar_arrive_if(v_empty(s), lane == 0);
    };

    // Online softmax of the tile at n0, in place in sc (scores -> probabilities);
    // updates the running max and sums and returns O's rescale factors in alpha.
    auto softmax = [&](int n0, float (&alpha)[2]) {
      // which masks can touch this warpgroup's 64 rows in this tile
      const bool need_mask = p.softcap != 0.f || n0 + kBN > p.Skv ||
                             (p.causal && n0 + kBN - 1 > r_lo + offset) ||
                             (p.window > 0 && r_lo + 63 + offset - n0 >= p.window);
      float mx[2] = {kNegInf, kNegInf};
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = n0 + j * 8 + tq * 2 + (e & 1);
            sc[4 * j + e] = masked_score(p, sc[4 * j + e], qpos[e >> 1], kpos);
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
        mx[0] *= p.scale;  // raw scores: the scale is positive, so max commutes
        mx[1] *= p.scale;
      }
      float m_l2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_row[r], mx[r]);
        alpha[r] = ex2((m_row[r] - m_new) * kLog2e);
        m_row[r] = m_new;
        m_l2[r] = m_new * kLog2e;
      }
      float rs[2] = {0.f, 0.f};
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = sc[4 * j + e];
            const float pe = x <= 0.5f * kNegInf ? 0.f : ex2(x * kLog2e - m_l2[e >> 1]);
            sc[4 * j + e] = pe;
            rs[e >> 1] += pe;
          }
      } else {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = ex2(fmaf(sc[4 * j + e], sl2, -m_l2[e >> 1]));
            sc[4 * j + e] = pe;
            rs[e >> 1] += pe;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_row[r] = l_row[r] * alpha[r] + rs[r];
    };
    // O *= alpha, then P (the score accumulator of keys [16kk, 16kk + 16) is,
    // register for register, the A fragment of one k16 step) packed to 16 bits
    auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pa[kk][0] = Wg<T>::pack(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = Wg<T>::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = Wg<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = Wg<T>::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    // Tile i's softmax overlaps tile i-1's P V on the tensor cores: issue S_i, then
    // P_{i-1} V_{i-1}; wait for S_i only; softmax; then wait for P V, rescale O.
    // The first tile and the last P V are peeled off, so no wgmma is issued under
    // a branch (the compiler would serialise them there).  gt counts the K/V tiles
    // of all work tiles so far: the ring's stage and phase.
    int gt = 0;
    for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
      const Work tw = work(w);
      const int u = j & 1;
      q_tile = sQ(u);
      r_lo = tw.q0 + c * 64;
      row[0] = r_lo + warp * 16 + g;
      row[1] = row[0] + 8;
      qpos[0] = row[0] + offset;
      qpos[1] = row[1] + offset;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      m_row[0] = m_row[1] = kNegInf;
      l_row[0] = l_row[1] = 0.f;

      mbar_wait(q_full(u), (j >> 1) & 1);
      if (tw.n_tiles > 0) {
        float alpha[2];
        mbar_wait(k_full(gt & 1), (gt >> 1) & 1);
        wgmma_fence();
        issue_qk(gt & 1);
        wgmma_wait0();
        pin(sc);
        mbar_arrive_if(k_empty(gt & 1), lane == 0);
        softmax(tw.kv_lo, alpha);
        rescale_and_pack(alpha);
        for (int i = 1; i < tw.n_tiles; ++i) {
          const int gi = gt + i, s = gi & 1;
          mbar_wait(k_full(s), (gi >> 1) & 1);
          wgmma_fence();  // sc, o and pa were last touched by ordinary instructions
          issue_qk(s);
          mbar_wait(v_full(s ^ 1), ((gi - 1) >> 1) & 1);
          issue_pv(s ^ 1);
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S_i only
          pin(sc);
          mbar_arrive_if(k_empty(s), lane == 0);
          softmax(tw.kv_lo + i * kBN, alpha);
          wgmma_wait0();  // P_{i-1} V_{i-1} is in O: only now may O be rescaled
          pv_done(s ^ 1);
          rescale_and_pack(alpha);
        }
        mbar_arrive_if(q_empty(u), lane == 0);  // Q is read by the S products only
        const int last = gt + tw.n_tiles - 1;
        mbar_wait(v_full(last & 1), (last >> 1) & 1);
        wgmma_fence();
        issue_pv(last & 1);
        wgmma_wait0();
        pv_done(last & 1);
        gt += tw.n_tiles;
      } else {
        mbar_arrive_if(q_empty(u), lane == 0);
      }

      // the epilogue runs while the producer already loads the next work tile
      T* og = static_cast<T*>(p.o) + tw.b * p.o_sb + tw.h * p.o_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_row[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.0f / fmaxf(l, 1e-30f);
        if (row[r] < p.Sq) {
          T* orow = og + (long long)row[r] * p.o_ss + tq * 2;
#pragma unroll
          for (int jj = 0; jj < HD / 8; ++jj)
            *reinterpret_cast<uint32_t*>(orow + jj * 8) =
                Wg<T>::pack(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
          // m_row is in units of the scaled score (the exponentials only run in
          // base 2), so this is the natural-log lse the backward expects
          if (p.lse != nullptr && tq == 0)
            p.lse[((long long)tw.b * p.H + tw.h) * p.Sq + row[r]] =
                m_row[r] + logf(fmaxf(l, 1e-30f));
        }
      }
    }
  }
}

// ------------------------------------------------------------------------- host

template <typename T, int HD>
int launch(const Params& p, CUtensorMapDataType type, cudaStream_t st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -4;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, p.q, type, HD, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, kBM) ||
      !encode(fn, &tk, p.k, type, HD, p.Skv, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, kBN) ||
      !encode(fn, &tv, p.v, type, HD, p.Skv, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, kBN))
    return -3;
  auto kern = flash_fwd_sm90_kernel<T, HD>;
  constexpr int smem = Smem<HD>::kAlloc;
  static bool raised = false;  // per instantiation
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  int sms = 0;
  cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const long long work = (long long)((p.Sq + kBM - 1) / kBM) * p.H * p.B;
  const int blocks = (int)(work < sms ? work : sms);  // one block per SM walks the work tiles
  kern<<<blocks, kThreads, smem, st>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_sm90(const Params& p, int hd, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    if (hd == 64) return launch<__nv_bfloat16, 64>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
    if (hd == 128) return launch<__nv_bfloat16, 128>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
  } else if (dtype == 2) {
    if (hd == 64) return launch<__half, 64>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    if (hd == 128) return launch<__half, 128>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
  }
  return -1;
}

}  // namespace flash
