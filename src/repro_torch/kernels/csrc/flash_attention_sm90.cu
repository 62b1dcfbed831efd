// Fused attention forward for Hopper (sm_90a): TMA + wgmma, warp-specialised.
// 16-bit inputs (bf16, fp16) at head_dim 16, 32, 64, 80, 128 and 256; plain C++
// launcher called from repro_flash_attention_fwd (flash_attention.cu) through
// flash::launch_sm90.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel,
// launched by _flash_fwd_kernel_call) for those shapes, with its contract as
// flash_attention.cu states it: q (B,Sq,H,hd), k/v (B,Skv,KV,hd), H % KV == 0,
// scale 1/sqrt(hd), softcap before the mask, causal qpos >= kpos with qpos offset
// by Skv - Sq, window qpos - kpos < window with or without causal, p = 0 where
// s <= -5e29, result acc / max(l, 1e-30), lse = m + log(l) per row when asked,
// Sq <= Skv under a causal mask or a window (any Sq without either), ragged Sq and
// Skv.
//
// Bound on this card: operations.  At the prefill shape (S = 2048, hd = 128) the
// two products do ~S*hd/2 flops per byte of q/k/v/o, far above the ~295 flop/byte
// ridge; the tensor cores are the limit, and only wgmma reaches their full rate.
// (A warp that loads its own fragments from shared memory and issues mma.sync in
// order is bound by latency inside the warp: ~3,050 cycles per 64x64 tile against
// ~1,100 for the tensor cores, PERF.md.)  What this design does (FlashAttention-3's
// shape):
//   * a persistent grid, one block per SM, each walking work tiles of (128-row q
//     tile, q head, batch), latest q tiles first so the heaviest go out first,
//     and with one query head a KV head, groups of neighbouring q tiles of one head
//     out together, so that K/V tiles are read from L2 by ~8 blocks;
//     3 warpgroups: warpgroup 0 is the producer (setmaxnreg.dec to 40; one thread
//     issues every TMA load), warpgroups 1 and 2 are consumers of 64 query rows
//     each (setmaxnreg.inc 232);
//   * two Q buffers: the next work tile's Q and first K/V tiles land while the
//     consumers finish the current one's last P V and store its output, so a
//     short causal work tile does not pay its loads in the open;
//   * TMA brings each Q tile once and K/V tiles of 128 keys through a two-stage
//     ring in shared memory, 128-byte swizzled, a head as 64-column boxes (two at
//     head_dim 128); full[stage] barriers count the bytes, empty[stage] barriers one
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
// Head_dim 256 (gemma-7b) keeps the same shape with its own shared-memory and
// register budget (Cfg<256>): two Q buffers of 128 x 256 would take 128 KB and a
// 128-key K or V tile 64 KB a stage, so it has
//   * one Q buffer (64 KB): the next work tile's Q lands once the consumers have
//     issued the current one's last S product, still during its last P V and
//     epilogue;
//   * K/V tiles of 64 keys (32 KB each, four 64-column boxes) in the two-stage ring
//     (128 KB): 192 KB in all of the 227 KB;
//   * S = Q K^T as wgmma m64n64k16 over 16 k-steps, O += P V as two m64n128k16
//     register-sourced products a k-step, one over each 128-column half of V;
//   * O takes 128 fp32 registers a consumer thread, so the producer gives up all it
//     can (setmaxnreg.dec 24) and the consumers take 240; S (32), P (16) and O (128)
//     fit beside each other, so the overlap of S_i with P_{i-1} V_{i-1} stays.
// Head_dim 80 (zamba2-2.7b's shared attention, H = KV = 32, window 4096) keeps
// head_dim 128's shape (two Q buffers, 128-key tiles, kQGroup grouping, the
// S_i / P_{i-1} V_{i-1} overlap, setmaxnreg 40/232, two consumer warpgroups).  What
// differs is the row: 80 16-bit values are 160 bytes, wider than the 128-byte swizzle
// row the other head_dims' 64-column boxes fill, and 80 is not a multiple of 64.  So
// a tile's head is cut into boxes of two kinds (Cfg<80>::kBoxes64 / kBoxesN):
//   * columns 0-63 one 64-column box under the 128-byte swizzle, as at 64 and 128;
//     columns 64-79 one 16-column box (32-byte rows) under the 32-byte swizzle,
//     each box with its own tensor map (tm_* / tn_*) and wgmma descriptors of its
//     layout type (8-row groups 1024 and 256 bytes apart);
//   * S = Q K^T is five k16 steps: four over the 64-column boxes, one over the
//     16-column boxes (a whole 32-byte row a step);
//   * O += P V a k16 step is m64n64k16 over V's 64-column box into O's registers
//     0-31 and m64n16k16 over its 16-column box into registers 32-39;
//   * O takes 40 fp32 registers a thread and S 64; a Q tile and a 128-key K or V
//     tile are 20 KB each, so the K/V ring has room for three stages (160 KB in all);
//   * the products shrink with the head but the exponentials do not, so the softmax
//     sets the pace: the two consumer warpgroups take turns at issuing their
//     products (named barriers, Cfg<80>::kTurns), so that one's softmax runs beside
//     the other's products.
// Nothing is padded: the products do 80 columns' work.  tools/flash_hd80_variants.py
// times this layout beside patched copies of it at zamba2's shapes (PERF.md): without
// turns, with two stages, and head_dim 128's body over maps of 80 columns whose
// second box TMA fills with zeros (1.6x the products); all three are slower.  A
// steady kv step still takes ~3,000 SM cycles against 1,280 for its products at
// peak, the softmax ~1,150-1,450 of them (tools/flash_fwd_phases.py --shape zamba2).
// Measured at gemma's shape (tools/flash_fwd_phases.py, PERF.md): a steady kv step
// takes ~3,200 SM cycles against 2,048 for its products at the tensor cores' peak,
// and hardly less (~3,150) with the exponentials taken out, so the products, not
// the softmax, set the pace.  Tried there and dropped: 80-key tiles (m64n80k16),
// a third K stage, one m64n256k16 product for P V, no overlap inside a warpgroup,
// a second producer thread for V, strict turns of the two warpgroups (named
// barriers: 1.6x slower).  What did
// gain (~10 % at H = KV) was handing out neighbouring q tiles of a head together.
// Not done yet (ROADMAP K2-fast): wider kv tiles for head_dim 64.
// Letting the two consumer warpgroups take strict turns at the tensor cores
// (named barriers) was measured and gained nothing at the prefill shape either.
// Head_dim 32 and 16 (any 16-bit model at those head_dims; a reduced model's 32) keep
// head_dim 128's shape (two Q buffers, 128-key tiles, a two-stage K/V ring, the S_i /
// P_{i-1} V_{i-1} overlap, setmaxnreg 40/232); their 64- or 32-byte rows are narrower
// than the 128-byte swizzle atom, so kBoxes64 = 0 and a tile's head is one narrow box:
//   * at 32, 32 columns under the 64-byte swizzle: S = Q K^T two k16 steps in the box
//     (the first starts S), O += P V one m64n32k16 a k16 step;
//   * at 16, 16 columns under the 32-byte swizzle, as head_dim 80's last columns: S one
//     k16 step, O += P V one m64n16k16 a k16 step (as two 16-column boxes at 32, 4-5 %
//     slower there: sixteen small products a tile instead of eight);
//   * the products are short and the exponentials are not: one a visible pair at 16 a
//     clock an SM is ~2x the products' time at peak at 32 and ~4x at 16 (the floor
//     chip_smoke.py and tools/flash_bench.py give beside each time);
//   * O takes 16 (8) registers a thread, S 64, P 32.
// A steady kv step takes ~2,550-2,900 SM cycles against the MUFU's 1,024 for its
// exponentials: the softmax ~1,300-1,650 of them, the products' issue ~400-700
// (tools/flash_fwd_phases.py --shape small, PERF.md).  tools/flash_small_variants.py
// times this layout beside patched copies of it; all of these were slower or mixed:
// the warpgroups taking turns at the products or at the softmax (35 % slower: a
// softmax alone is latency-bound inside its warps), a third consumer warpgroup (28 %
// slower), a share of the exponentials on the FMA pipe, four stages, 192-key tiles,
// the row max as a tree.
// An mbarrier wait that never completes traps after 4 s instead of hanging the card
// (head_dim 80's turns wait on named barriers, which have no such limit).
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

constexpr int kQGroup = 8;        // neighbouring q tiles handed out together (H = KV)
constexpr int kConsumers = 2;     // consumer warpgroups of 64 query rows each

// What differs by head_dim: keys per K/V tile, Q buffers, the warpgroups' share of
// the register file (head_dim 256: see the note at the top), the K/V ring's stages,
// whether the consumer warpgroups take turns at the tensor cores, and how a tile's
// head is cut into TMA boxes: 64-column boxes under the 128-byte swizzle (kBoxes64),
// then narrow boxes (kBoxesN of kNarrow columns: 16 under the 32-byte swizzle at
// head_dim 80 and 16, 32 under the 64-byte one at 32; see the note).
template <int HD>
struct Cfg {
  static constexpr bool kWide = HD == 256;
  static constexpr bool kSmall = HD <= 32;     // head_dim 32 and 16: narrow boxes only
  static constexpr int kBM = 64 * kConsumers;            // query rows a block
  static constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer
  static constexpr int kBN = kWide ? 64 : 128;
  static constexpr int kQBufs = kWide ? 1 : 2;
  static constexpr int kProducerRegs = kWide ? 24 : 40;
  static constexpr int kConsumerRegs = kWide ? 240 : 232;
  static constexpr int kStages = HD == 80 ? 3 : 2;   // of the K/V ring
  static constexpr bool kTurns = HD == 80;
  static constexpr int kBoxes64 = HD / kBoxCols;
  // then the narrow boxes: 16 columns under the 32-byte swizzle (head_dim 80's last
  // columns, 16's whole head), or head_dim 32's one box of 32 under the 64-byte one
  static constexpr int kNarrow = HD == 32 ? 32 : kNarrowCols;
  static constexpr int kNarrowBytes = 2 * kNarrow;       // a row of one
  static constexpr int kSwizzleN = kNarrow == 32 ? kSwizzle64B : kSwizzle32B;
  static constexpr int kBoxesN = HD % kBoxCols / kNarrow;
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536,
                "register file");
  static_assert(kBoxes64 * kBoxCols + kBoxesN * kNarrow == HD, "boxes cover the head");
};

// ----------------------------------------------------------------------- kernel

template <int HD>
struct Smem {
  static constexpr int kBN = Cfg<HD>::kBN;
  // byte offsets of a tile's boxes: the 64-column boxes (rows x 128 B each), then
  // the narrow ones (rows x 32 or 64 B); all on 1024-byte boundaries at these row counts
  __host__ __device__ static constexpr uint32_t box64(int rows, int x) { return x * rows * 128; }
  __host__ __device__ static constexpr uint32_t boxN(int rows, int y) {
    return Cfg<HD>::kBoxes64 * rows * 128 + y * rows * Cfg<HD>::kNarrowBytes;
  }
  static constexpr int kBM = Cfg<HD>::kBM;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;   // one K or one V tile
  static constexpr int kQ = 0;                    // Q tiles: with two, the next tile's
  static constexpr int kK = kQ + Cfg<HD>::kQBufs * kQBytes;  // lands while this one's runs
  static constexpr int kStages = Cfg<HD>::kStages;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // barriers: q_full[2], q_empty[2], then k_full, v_full, k_empty, v_empty of each stage
  static constexpr int kBytes = kBar + (4 + 4 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;    // room to align the base to 1024
  static_assert(kAlloc <= 232448, "shared memory a block can use");
};

// tm_*: the maps of the 64-column boxes; tn_*: those of the narrow boxes (only
// where the head has them: head_dim 80, 32 and 16)
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tn_q,
                          const __grid_constant__ CUtensorMap tn_k,
                          const __grid_constant__ CUtensorMap tn_v, const Params p) {
  using S = Smem<HD>;
  using C = Cfg<HD>;
  constexpr int kBN = C::kBN, kBM = C::kBM;
  constexpr int kB64 = C::kBoxes64, kNB = C::kBoxesN, kNR = C::kNarrowBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // every tile starts on a 1024-byte boundary: the swizzle pattern's period
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + S::kBar;
  auto sQ = [&](int u) { return base + S::kQ + u * S::kQBytes; };
  auto q_full = [&](int u) { return bar + 8 * (0 + u); };
  auto q_empty = [&](int u) { return bar + 8 * (2 + u); };
  constexpr int kStages = S::kStages;
  auto k_full = [&](int s) { return bar + 8 * (4 + s); };
  auto v_full = [&](int s) { return bar + 8 * (4 + kStages + s); };
  auto k_empty = [&](int s) { return bar + 8 * (4 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar + 8 * (4 + 3 * kStages + s); };
  // K/V tile g of this block (counted across its work tiles) sits in stage
  // stage(g), and its barriers' phase is phase(g)
  auto stage = [&](int g) { return (int)((uint32_t)g % kStages); };
  auto phase = [&](int g) { return ((uint32_t)g / kStages) & 1u; };
  auto sK = [&](int s) { return base + S::kK + s * S::kKVBytes; };
  auto sV = [&](int s) { return base + S::kV + s * S::kKVBytes; };

  // Persistent: work tile w is (q tile, head, batch) with the q tile outermost
  // and latest first, so the heaviest tiles of every head are handed out first.
  // Round j gives the blocks the next gridDim.x work tiles, in turn forwards and
  // backwards (a block that got a heavier tile in one round gets a lighter one in
  // the next): the most work a block gets is ~1.5 % above the mean at the
  // prefill shape, against ~7 % for plain round robin.
  // K/V tiles come from L2 when the blocks reading one KV head run together.  With
  // several query heads a KV head, neighbouring work tiles already share it; with
  // one (H = KV: gemma, whisper), kQGroup neighbouring q tiles of a head are handed
  // out together (q tile inside the group, then head and batch).  Measured: ~10 %
  // faster at gemma's shape; the same grouping made 7:1 GQA ~4 % slower.
  const int n_qt = (p.Sq + kBM - 1) / kBM;
  const int n_work = n_qt * p.H * p.B;
  const int HB = p.H * p.B;
  const int qg = p.H == p.KV ? kQGroup : 1;
  const int qg_full = n_qt / qg * qg;  // q tiles in whole groups
  struct Work {
    int q0, h, b, kvh, kv_lo, n_tiles;
  };
  auto work_index = [&](int j) {
    const int n = gridDim.x, i = blockIdx.x;
    return j * n + ((j & 1) ? n - 1 - i : i);
  };
  auto work = [&](int w) {
    Work t;
    int qi, hb;  // the q tile (0 = the latest) and (head, batch)
    if (w < qg_full * HB) {
      qi = w / (qg * HB) * qg + w % qg;
      hb = w / qg % HB;
    } else {     // the last, partial group
      const int r = w - qg_full * HB, rest = n_qt - qg_full;
      qi = qg_full + r % rest;
      hb = r / rest;
    }
    t.q0 = (n_qt - 1 - qi) * kBM;
    t.h = hb % p.H;
    t.b = hb / p.H;
    t.kvh = t.h / (p.H / p.KV);
    int kv_hi;
    kv_range(p, t.q0, kBM, kBN, t.kv_lo, kv_hi);
    t.n_tiles = kv_hi > t.kv_lo ? (kv_hi - t.kv_lo + kBN - 1) / kBN : 0;
    return t;
  };

  if (threadIdx.x == 0) {
    for (int u = 0; u < C::kQBufs; ++u) {
      mbar_init(q_full(u), 1);
      mbar_init(q_empty(u), 4 * kConsumers);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * kConsumers);
      mbar_init(v_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      auto prefetch = [](const CUtensorMap* m) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m))
                     : "memory");
      };
      if constexpr (kB64 > 0) prefetch(&tm_k), prefetch(&tm_v);
      if constexpr (kNB > 0) prefetch(&tn_k), prefetch(&tn_v);
      // one tile of `rows` rows from row r0 of (head h, batch b) into dst: its
      // 64-column boxes, then its narrow ones, all completing on barrier `full`
      auto load = [&](uint32_t dst, const CUtensorMap* wide, const CUtensorMap* narrow,
                      uint32_t full, int rows, int r0, int h, int b) {
#pragma unroll
        for (int x = 0; x < kB64; ++x)
          tma_load_4d(dst + S::box64(rows, x), wide, full, x * kBoxCols, r0, h, b);
#pragma unroll
        for (int y = 0; y < kNB; ++y)
          tma_load_4d(dst + S::boxN(rows, y), narrow, full, kB64 * kBoxCols + y * C::kNarrow,
                      r0, h, b);
      };
      // j: this block's work tiles so far; g: K/V tiles so far (the ring's
      // position and phase run on across work tiles)
      int g = 0;
      for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
        const Work t = work(w);
        const int u = j % C::kQBufs;
        // each buffer's first work tile: a fresh barrier passes
        mbar_wait(q_empty(u), ((j / C::kQBufs) & 1) ^ 1);
        mbar_expect_tx(q_full(u), S::kQBytes);
        load(sQ(u), &tm_q, &tn_q, q_full(u), kBM, t.q0, t.h, t.b);
        for (int i = 0; i < t.n_tiles; ++i, ++g) {
          const int s = stage(g);
          const uint32_t parity = phase(g) ^ 1;
          const int n0 = t.kv_lo + i * kBN;
          mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), S::kKVBytes);
          load(sK(s), &tm_k, &tn_k, k_full(s), kBN, n0, t.kvh, t.b);
          mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), S::kKVBytes);
          load(sV(s), &tm_v, &tn_v, v_full(s), kBN, n0, t.kvh, t.b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs) : "memory");
    const int c = wg - 1;                     // which 64 rows of the tile
    // With C::kTurns the two consumer warpgroups take turns at issuing their
    // products (named barriers 1 and 2 of 256 threads: each waits on its own and
    // passes to the other's), so that one's softmax runs beside the other's products.
    // The first turn is warpgroup 0's: warpgroup 1 opens it.  Both warpgroups must
    // make the same number of turns in every work tile (one a K/V tile: tw.n_tiles is
    // the block's), or one waits for ever: these barriers, unlike the mbarriers, have
    // no time limit.
    auto turn_wait = [&] {
      if constexpr (C::kTurns) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
    };
    auto turn_pass = [&] {
      if constexpr (C::kTurns) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
    };
    if constexpr (C::kTurns)
      if (c == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
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

    // S = Q K^T for the tile in stage s: 64 rows x kBN keys, K-major A and B,
    // 32 bytes a k16 step: four steps in each 64-column box, then one in each
    // narrow box (32 bytes of its row a step; 8-row groups 8 rows apart); with no
    // 64-column box (head_dim 32, 16) the first narrow step starts S
    auto issue_qk = [&](int s) {
      if constexpr (kB64 > 0) {
        const uint64_t qd = opaque(smem_desc(q_tile + c * 64 * 128, 16, 1024));
        const uint64_t kd = opaque(smem_desc(sK(s), 16, 1024));
#pragma unroll
        for (int kk = 0; kk < 4 * kB64; ++kk) {
          const uint32_t box = (kk >> 2) * 128, in = (kk & 3) * 32;  // bytes; >> 4 below
          Wg<T>::template ss<kBN>(sc, qd + ((box * kBM + in) >> 4),
                                  kd + ((box * kBN + in) >> 4), kk > 0);
        }
      }
      if constexpr (kNB > 0) {
        const uint64_t qd = opaque(
            smem_desc(q_tile + S::boxN(kBM, 0) + c * 64 * kNR, 16, 8 * kNR, C::kSwizzleN));
        const uint64_t kd = opaque(smem_desc(sK(s) + S::boxN(kBN, 0), 16, 8 * kNR, C::kSwizzleN));
#pragma unroll
        for (int y = 0; y < kNB; ++y)
#pragma unroll
          for (int ks = 0; ks < C::kNarrow / 16; ++ks)  // 32 bytes a k16 step
            Wg<T>::template ss<kBN>(sc, qd + ((y * kBM * kNR + ks * 32) >> 4),
                                    kd + ((y * kBN * kNR + ks * 32) >> 4),
                                    kB64 > 0 || y > 0 || ks > 0);
      }
      wgmma_commit();
    };
    // O += P V for the tile in stage s: V is MN-major, 16 keys are two 8-row
    // groups (SBO 1024), the second 64 columns of a 128-wide slice the next box
    // (LBO); head_dim 256 as two 128-wide slices, each its own product into its
    // half of O (columns 128h.. are O's registers 64h..); head_dim 80 as the
    // note at the top says; head_dim 32 and 16 as one m64n{32,16}k16 a k16 step over
    // each narrow box of V (columns kNarrow y.. are O's registers kNarrow / 2 y..; 8-row
    // groups 8 rows apart)
    auto issue_pv = [&](int s) {
      if constexpr (C::kSmall) {
        constexpr int kN = C::kNarrow;
        const uint64_t vn = opaque(smem_desc(sV(s), kBN * kNR, 8 * kNR, C::kSwizzleN));
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
          for (int y = 0; y < kNB; ++y)
            Wg<T>::template rs<kN>(*reinterpret_cast<float(*)[kN / 2]>(o + kN / 2 * y), pa[kk],
                                   vn + ((y * kBN * kNR + kk * 16 * kNR) >> 4), 1);
      } else {
        const uint64_t vd = opaque(smem_desc(sV(s), kBN * 128, 1024));
        if constexpr (HD == 80) {
          // columns 0-63 (O's registers 0-31) from the 64-column box, 64-79
          // (registers 32-39) from the 16-column box
          const uint64_t vn =
              opaque(smem_desc(sV(s) + S::boxN(kBN, 0), kBN * 32, 256, kSwizzle32B));
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk) {
            Wg<T>::template rs<64>(*reinterpret_cast<float(*)[32]>(o), pa[kk],
                                   vd + ((kk * 16 * 128) >> 4), 1);
            Wg<T>::template rs<16>(*reinterpret_cast<float(*)[8]>(o + 32), pa[kk],
                                   vn + ((kk * 16 * 32) >> 4), 1);
          }
        } else if constexpr (HD <= 128) {
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk)
            Wg<T>::template rs<HD>(o, pa[kk], vd + ((kk * 16 * 128) >> 4), 1);
        } else {
#pragma unroll
          for (int h = 0; h < HD / 128; ++h)
#pragma unroll
            for (int kk = 0; kk < kBN / 16; ++kk)
              Wg<T>::template rs<128>(*reinterpret_cast<float(*)[64]>(o + 64 * h), pa[kk],
                                      vd + ((h * 2 * kBN * 128 + kk * 16 * 128) >> 4), 1);
        }
      }
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
      const int u = j % C::kQBufs;
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

      mbar_wait(q_full(u), (j / C::kQBufs) & 1);
      if (tw.n_tiles > 0) {
        float alpha[2];
        mbar_wait(k_full(stage(gt)), phase(gt));
        wgmma_fence();
        turn_wait();
        issue_qk(stage(gt));
        turn_pass();
        wgmma_wait0();
        pin(sc);
        mbar_arrive_if(k_empty(stage(gt)), lane == 0);
        softmax(tw.kv_lo, alpha);
        rescale_and_pack(alpha);
        for (int i = 1; i < tw.n_tiles; ++i) {
          const int gi = gt + i, s = stage(gi), sp = stage(gi - 1);
          mbar_wait(k_full(s), phase(gi));
          wgmma_fence();  // sc, o and pa were last touched by ordinary instructions
          turn_wait();
          issue_qk(s);
          mbar_wait(v_full(sp), phase(gi - 1));
          issue_pv(sp);
          turn_pass();
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S_i only
          pin(sc);
          mbar_arrive_if(k_empty(s), lane == 0);
          softmax(tw.kv_lo + i * kBN, alpha);
          wgmma_wait0();  // P_{i-1} V_{i-1} is in O: only now may O be rescaled
          pv_done(sp);
          rescale_and_pack(alpha);
        }
        mbar_arrive_if(q_empty(u), lane == 0);  // Q is read by the S products only
        const int last = gt + tw.n_tiles - 1;
        mbar_wait(v_full(stage(last)), phase(last));
        wgmma_fence();
        issue_pv(stage(last));
        wgmma_wait0();
        pv_done(stage(last));
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
            if (!C::kWide || jj * 8 < p.hd)  // a narrower head's columns only
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
int launch_hd(const Params& p, CUtensorMapDataType type, cudaStream_t st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -4;
  // the 64-column boxes' maps and the narrow boxes' (zeros where a head has none
  // of that kind: the kernel never reads them)
  CUtensorMap tq{}, tk{}, tv{}, nq{}, nk{}, nv{};
  constexpr int kBN = Cfg<HD>::kBN, kBM = Cfg<HD>::kBM;
  if (Cfg<HD>::kBoxes64 > 0 &&
      (!encode(fn, &tq, p.q, type, p.hd, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, kBM) ||
       !encode(fn, &tk, p.k, type, p.hd, p.Skv, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, kBN) ||
       !encode(fn, &tv, p.v, type, p.hd, p.Skv, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, kBN)))
    return -3;
  constexpr int nc = Cfg<HD>::kNarrow;
  constexpr CUtensorMapSwizzle sw =
      nc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  if (Cfg<HD>::kBoxesN > 0 &&
      (!encode(fn, &nq, p.q, type, p.hd, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, kBM, nc, sw) ||
       !encode(fn, &nk, p.k, type, p.hd, p.Skv, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, kBN, nc, sw) ||
       !encode(fn, &nv, p.v, type, p.hd, p.Skv, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, kBN, nc, sw)))
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
  kern<<<blocks, Cfg<HD>::kThreads, smem, st>>>(tq, tk, tv, nq, nk, nv, p);
  return (int)cudaGetLastError();
}

// Head_dim HD's call on the kernels of kernel_head_dim(HD): itself, or 224 on 256's
// with tensor maps of p.hd columns.
template <typename T, int HD>
int launch(const Params& p, CUtensorMapDataType type, cudaStream_t st) {
  return launch_hd<T, kernel_head_dim(HD)>(p, type, st);
}

}  // namespace

int launch_sm90(const Params& p, int hd, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    if (hd == 16) return launch<__nv_bfloat16, 16>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
    if (hd == 32) return launch<__nv_bfloat16, 32>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
    if (hd == 64) return launch<__nv_bfloat16, 64>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
    if (hd == 80) return launch<__nv_bfloat16, 80>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
    if (hd == 128) return launch<__nv_bfloat16, 128>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
    if (hd == 224) return launch<__nv_bfloat16, 224>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
    if (hd == 256) return launch<__nv_bfloat16, 256>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
  } else if (dtype == 2) {
    if (hd == 16) return launch<__half, 16>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    if (hd == 32) return launch<__half, 32>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    if (hd == 64) return launch<__half, 64>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    if (hd == 80) return launch<__half, 80>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    if (hd == 128) return launch<__half, 128>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    if (hd == 224) return launch<__half, 224>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    if (hd == 256) return launch<__half, 256>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
  }
  return -1;
}

}  // namespace flash
