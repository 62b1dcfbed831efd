// Fused attention backward for Hopper (sm_90a): TMA + wgmma, warp-specialised.
// 16-bit inputs (bf16, fp16) at head_dim 16, 32, 64, 80, 128 and 256; plain C++
// launcher called from repro_flash_attention_bwd (flash_attention_bwd.cu) through
// flash::launch_bwd_sm90.
//
// Replaces the backward of the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel's VJP: _flash_vjp_bwd differentiates mha_reference; the reference
// has no backward kernel) for 16-bit inputs.  It computes what flash_attention_bwd.cu
// states, with the same masks (causal, window, ragged tails, query offset Skv - Sq)
// and softcap derivative: dq, dk, dv from q, k, v, o, lse and dO, dk and dv summed
// over the G = H / KV query heads of each KV head.
//
// Bound on this card: operations.  10 * hd flops per visible (query, key) pair (Q K^T,
// dO V^T, P^T dO, dS K, dS^T Q), ~0.6 TFLOP at the training shape against ~0.3 GB
// moved.  Warps that load their own fragments and issue mma.sync in order run at
// ~99 TFLOP/s of that work (latency inside the warp), and a dk/dv pass beside a dq
// pass recomputes Q K^T and dO V^T (14 * hd a pair).  What this design does
// (FlashAttention-3's backward):
//   * one pass: a persistent grid, one block per SM, walking work tiles of (batch,
//     KV head, 128-key tile), early key tiles first (under causal masking they see the
//     most queries), handed out forwards and backwards in turn;
//   * 3 warpgroups: warpgroup 0 is the producer (setmaxnreg.dec 40; one thread issues
//     every TMA load, one more every dQ add, below), warpgroups 1 and 2 are consumers
//     owning 64 of the tile's keys each (setmaxnreg.inc 232);
//   * TMA brings K and V of the tile once and, for each query tile that can see the
//     keys (64 rows at head_dim 80, 128 and 256, 128 at 64; the last first) and each
//     query head of the group, Q, dO and the rows' lse and D through a two-stage ring
//     with full/empty mbarriers (a stage is released once dV and dK have read it,
//     before dQ is done), 128-byte swizzled, over the caller's strides;
//   * S^T = K Q^T and dP^T = V dO^T are wgmma m64nBMk16 with both operands from
//     shared memory; P^T = exp(S^T scale - lse) and dS^T = P^T o (dP^T - D) (times
//     1 - tanh^2 when capped) stay in registers; the per-element mask runs only on
//     tiles the causal diagonal, the window's edge, the ragged key tail or a softcap
//     touch; query rows past Sq need no mask (their lse is +inf, so P is 0);
//   * dV += P^T dO and dK += dS^T Q are wgmma m64n{hd}k16 with A taken from registers
//     (the accumulators re-packed to 16 bits, as the forward's P) and B MN-major from
//     shared memory; dk and dv stay in registers for the whole work tile, summed over
//     the group in a fixed order: the same bit for bit from run to run;
//   * dS^T goes to shared memory (16 bits, double-buffered; each warpgroup arrives
//     on an mbarrier once its rows are there), and dQ = dS K is one more wgmma
//     m64n64k16 with A = dS read transposed and B = K MN-major: at head_dim 128 each
//     warpgroup takes 64 of the columns, at 64 each takes 64 of the 128 query rows;
//   * dQ is added into an fp32 accumulator (B H sq_pad(Sq) hd floats; for each 64
//     query rows a 64 x 64 block per 64 columns, then at head_dim 80 a 64 x 16 block,
//     each block in the consumers' fragment order): each consumer stages its block in
//     shared memory (two buffers at head_dim 80 and 128, one at 64) and the
//     producer warpgroup's writer thread adds it (at head_dim 80 the sum of the two
//     consumers' blocks, below) with a TMA bulk reduce-add
//     (cp.reduce.async.bulk .add.f32), so no consumer waits on L2 for the adds.  They
//     land in an order that changes from run to run, so dq is not bit-for-bit
//     repeatable (dk and dv are).
//     Measured and dropped (PERF.md): each thread's red.global.add (v2 on a
//     row-major accumulator, v4 in fragment order) and the bulk reduce issued by the
//     consumers themselves (their stalls on L2 were the step's longest wait); the two
//     warpgroups half a step apart, with dQ one step late, so that one's
//     exponentials overlap the other's products (slower: the products ran slower side
//     by side); a third Q / dO stage (no gain);
//   * a prep kernel writes D = rowsum(dO o O), lse * log2(e) (+inf past Sq) and zeroes
//     the accumulator; a last kernel scales it and casts it into dq (head_dim 256 has
//     no accumulator: below).
// Head_dim 80 (zamba2-2.7b's shared attention) keeps head_dim 128's shape (128-key
// work tiles, 64 query rows a step, two Q / dO stages; a third gained nothing).  Its
// 160-byte row fits no swizzle atom, so, as in the forward (flash_attention_sm90.cu),
// every tile's head is a 64-column box under the 128-byte swizzle and a 16-column box
// under the 32-byte swizzle, each with its own tensor maps (tm_* / tn_*) and
// descriptors of its layout type: S^T and dP^T take four k16 steps in the wide box
// and one in the narrow one;
// dV and dK are an m64n64k16 and an m64n16k16 product a k16 step (registers 0-31 and
// 32-39 of the accumulators).  80 columns do not split in two 64-wide halves, so dQ is
// split along the keys instead: each warpgroup multiplies its own 64 keys' dS by their
// K rows (64 x 80, again n64 + n16) and stages that partial dQ.  Two warps of the
// producer warpgroup, idle otherwise, add the second partial into the first in shared
// memory, and the writer adds that one block into the accumulator: the bulk
// reduce-adds into L2 were what held the step back (adding both partials, twice the
// bytes, is slower: tools/flash_hd80_variants.py --backward, PERF.md).  dk, dv (40 +
// 40), S^T and dP^T (32 + 32) and dQ (40) fit the consumers' registers beside each
// other.
// Head_dim 256 (gemma-7b): a warpgroup's dk and dv over 64 keys would be 256 fp32
// registers a thread, more than setmaxnreg gives.  So (FlashAttention-3 makes choices
// of this kind there):
//   * work tiles of 64 keys, and both consumer warpgroups work on all of them: each
//     computes S^T and dP^T for 32 of the step's 64 query rows (m64n32k16, 16 k16 steps)
//     and owns 128 of the head's columns of dk and dv (64 + 64 registers);
//   * P^T and dS^T go to shared memory (16 bits, double-buffered), and dV += P^T dO
//     and dK += dS^T Q are m64n128k16 products with both operands there;
//   * dQ is a pass of its own (flash_bwd_sm90_dq_pass_kernel): with 64 keys a tile, a
//     step of the one pass would add 64 KB of dQ into L2 beside the 64 KB of Q and dO
//     it reads, and those adds set the pace (as at head_dim 80, above; 3.3-3.4 ms at
//     gemma's training shape, the stage wait its longest phase,
//     tools/flash_bwd_phases.py --shape gemma, PERF.md).  The dQ pass keeps a 64-row
//     query tile and its dQ resident and streams K and V, so no dQ is added into
//     memory at all: it recomputes S and dP (14 hd flops a pair in all instead of 10)
//     and reads K and V once more, and its dq is the same bit for bit from run to run;
//   * K, V, Q and dO tiles are 32 KB each: two Q / dO stages fit beside K, V and the
//     P^T / dS^T buffers (225 KB);
//   * S^T and dP^T are zeroed before their products so that the compiler keeps them
//     live only while they are in use; at head_dim 80 too.  (Zeroing dQ there through
//     its 64- and 16-column views makes ptxas serialise the wgmmas, C7520, so there its
//     first k16 step overwrites it instead.)
// Head_dim 32 and 16 keep head_dim 64's shape: 128-key work tiles, 128 query rows a
// step, dQ split by rows between the warpgroups (64 rows of dS each times all 128
// keys), one dQ staging buffer, bulk reduce-adds into a 64 x hd block a step.  Their
// 64- or 32-byte rows are two (one) 16-column boxes under the 32-byte swizzle, as
// head_dim 80's last columns: S^T and dP^T take one k16 step a box (the first starts
// them), dV, dK and dQ one n16 product a box a k16 step into registers 8y...  dk and dv
// are 16 (8) registers each, so S^T and dP^T (64 + 64) fit as at 64.  One exponential
// a visible pair takes about as long as the 10 hd operations there at the tensor
// cores' peak, so the MUFU and the products share the pace.  dk and dv repeat bit for
// bit; dq, summed by reduce-adds in no fixed order, does not (a dQ pass would keep it
// repeatable but recompute every exponential).
// rows past Sq / Skv are zero-filled by TMA; the kpos < Skv mask term stays (a zero
// key scores 0, not -inf).  A barrier wait that never completes traps after 4 s.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention.cuh"
#include "sm90.cuh"

namespace flash {
namespace {

constexpr int kThreads = 384;     // producer + two consumer warpgroups

// Tile shapes by head_dim, as FlashAttention-3 takes them, and the share of each
// consumer warpgroup (c = 0, 1): the 64 keys of its S^T (rows kRow0 c.. of the K / V
// tile), its query columns (kQCols from kQCol0 c), its columns of dk and dv (kKVCols
// from kKVCol0 c), and its block of dQ (64 rows x kDqCols over kDqKeys keys, the
// accumulator's 64-row block at +kDqRowStep c rows and 64-column block kDqColBlk c).
template <int HD>
struct Cfg {
  // head_dim 256: both warpgroups on one 64-key tile, dQ in a pass of its own
  // (flash_bwd_sm90_dq_pass_kernel)
  static constexpr bool kWide = HD == kDqPassHeadDim;
  static constexpr bool kSmall = HD <= 32;            // head_dim 32, 16: narrow boxes only
  static constexpr int kBN = kWide ? 64 : 128;        // keys per work tile
  static constexpr int BM = HD == 64 || kSmall ? 128 : 64;  // query rows a step
  static constexpr int kStages = 2;                   // the Q / dO / lse / D ring
  static constexpr int kBoxes64 = HD / kBoxCols;      // 64-column boxes of a row
  static constexpr int kBoxes16 = HD % kBoxCols / kNarrowCols;  // then 16-column ones
  static constexpr int kRow0 = kWide ? 0 : 64;
  static constexpr int kQCols = kWide ? BM / 2 : BM;
  static constexpr int kQCol0 = kWide ? kQCols : 0;
  static constexpr int kKVCols = kWide ? HD / 2 : HD;
  static constexpr int kKVCol0 = kWide ? kKVCols : 0;
  static constexpr int kDqCols = HD == 80 ? 80 : kSmall ? HD : 64;
  static constexpr int kDqKeys = HD == 80 ? 64 : kBN;
  static constexpr int kDqKey0 = HD == 80 ? 64 : 0;   // split along the keys (the note)
  static constexpr int kDqRowStep = BM == 128 ? 64 : 0;
  static constexpr int kDqColBlk = HD == 128 ? 1 : 0;
  static constexpr int kQBytes = BM * HD * 2;      // one Q or one dO tile
  static constexpr int kKVBytes = kBN * HD * 2;    // one K or one V tile
  static constexpr int kDSBytes = kBN * BM * 2;    // one dS^T (or P^T) tile
  static constexpr int kDqBytes = 64 * kDqCols * 4;  // one staged dQ block
  // byte offset of a tile's 16-column box y (after its 64-column boxes)
  __host__ __device__ static constexpr uint32_t box16(int rows, int y = 0) {
    return kBoxes64 * rows * 128 + y * rows * 32;
  }
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;                // stage s at kQ + s * kQBytes
  static constexpr int kdO = kQ + kStages * kQBytes;
  static constexpr int kDS = kdO + kStages * kQBytes;     // two dS^T buffers
  static constexpr int kP = kDS + 2 * kDSBytes;           // two P^T buffers (kWide)
  static constexpr int kLD = kP + (kWide ? 2 * kDSBytes : 0);  // stage s: lse2[BM], D[BM]
  // dQ blocks staged for the writer thread: kDqBufs for each consumer; at head_dim 80
  // two producer warps first add consumer 1's partial dQ into consumer 0's (the note)
  static constexpr int kDqBufs = kWide ? 0 : HD == 128 || HD == 80 ? 2 : 1;
  static constexpr bool kDqSum = HD == 80;
  static constexpr int kDQ = kLD + kStages * 2 * BM * 4;
  static constexpr int kBar = kDQ + 2 * kDqBufs * kDqBytes;
  // barriers: full[kStages], empty[kStages], kv_full, kv_empty, ds_full[2],
  // dq_full[2][kDqBufs], dq_empty[2][kDqBufs], sum_full[kDqBufs]
  static constexpr int kBytes = kBar + (2 * kStages + 4 + 5 * kDqBufs) * 8;
  static constexpr int kAlloc = kBytes + 1024;            // room to align the base to 1024
  static_assert(kAlloc <= 232448, "shared memory a block can use");
  static_assert(kBoxes64 * kBoxCols + kBoxes16 * kNarrowCols == HD &&
                    (kBoxes16 <= 1 || kBoxes64 == 0),
                "boxes cover the head");
  static_assert(kDS % 1024 == 0 && kP % 1024 == 0 && kQBytes % 1024 == 0 &&
                    kKVBytes % 1024 == 0 && kDSBytes % 1024 == 0,
                "swizzled tiles on 1024-byte boundaries");
};

template <typename T> __device__ __forceinline__ float f32(T v);
template <> __device__ __forceinline__ float f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float f32<__half>(__half v) { return __half2float(v); }

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float lds32f(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float2 lds64(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

template <int N>
__device__ __forceinline__ void pin_u(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// D = rowsum(dO o O) and lse * log2(e) for every row of (B, H, sq_pad(Sq)) (rows past
// Sq: 0 and +inf), and that row of the dq accumulator zeroed: a warp per row.
template <typename T, int HD>
__global__ void flash_bwd_sm90_prep_kernel(const BwdParams p) {
  const int sq_p = sq_pad(p.Sq);
  const long long rows = (long long)p.B * p.H * sq_p;
  const long long idx = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= rows) return;
  const int row = (int)(idx % sq_p);
  const int h = (int)((idx / sq_p) % p.H);
  const int b = (int)(idx / ((long long)sq_p * p.H));
  float acc = 0.f;
  // E consecutive elements a lane (HD / 32 at 64, 128 and 256; 4 at 80, 32 and 16:
  // lanes 0-19, 0-7, 0-3), one 4-, 8- or 16-byte load each
  constexpr int E = HD % 32 == 0 && HD >= 64 ? HD / 32 : 4;
  if (row < p.Sq && lane < p.hd / E) {  // p.hd: a narrower head on HD's kernels
    using V = typename std::conditional<
        E == 8, uint4, typename std::conditional<E == 4, uint2, uint32_t>::type>::type;
    const T* o = static_cast<const T*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh + lane * E;
    const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + row * p.do_ss + h * p.do_sh + lane * E;
    const V ov = *reinterpret_cast<const V*>(o), dv = *reinterpret_cast<const V*>(d);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int i = 0; i < E; ++i) acc += f32<T>(oe[i]) * f32<T>(de[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.delta[idx] = acc;
    p.delta[rows + idx] =
        row < p.Sq ? p.lse[((long long)b * p.H + h) * p.Sq + row] * kLog2e : __int_as_float(0x7f800000);
  }
  if constexpr (!Cfg<HD>::kWide) {
    float4* z = reinterpret_cast<float4*>(p.dq_acc + idx * HD);
    for (int i = lane; i < HD / 4; i += 32) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The dq accumulator holds, for each (b, h, 64-row block rb) in that order, 64 x hd
// floats: a 64 x 64 block for each 64 columns, then (head_dim 80) a 64 x 16 block,
// each held in the consumers' fragment order (element (row, col) of a block at
// fragment_slot(row, col)).  The float offset of (b, h, rb)'s first block; block cb
// (columns 64 cb..) follows at + cb * 4096:
__device__ __forceinline__ long long dq_block(const BwdParams& p, int b, int h, int rb, int hd) {
  return (((long long)b * p.H + h) * (sq_pad(p.Sq) / 64) + rb) * 64 * hd;
}

// Where a consumer thread's accumulator element sits in its warpgroup's 64 x 64 (or
// 64 x 16) block: thread t = 32 warp + 4 g + tq holds rows 16 warp + g (+ 8 r),
// columns 8 jj + 2 tq (+ e) in register i = 4 jj + 2 r + e, stored as 16-byte chunk jj
// of thread t at float (128 jj + t) * 4.
__device__ __forceinline__ int fragment_slot(int row, int col) {
  const int warp = row >> 4, g = row & 7, r = (row >> 3) & 1;
  const int jj = col >> 3, tq = (col >> 1) & 3, e = col & 1;
  return (jj * 128 + warp * 32 + g * 4 + tq) * 4 + 2 * r + e;
}

// dq = the accumulator * scale, in the input type: a thread per 8 columns of a row.
template <typename T, int HD>
__global__ void flash_bwd_sm90_dq_kernel(const BwdParams p) {
  constexpr int V = HD / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.B * p.H * p.Sq * V) return;
  const int cv = (int)(i % V);
  const long long r = i / V;
  const int row = (int)(r % p.Sq);
  const int h = (int)((r / p.Sq) % p.H);
  const int b = (int)(r / ((long long)p.Sq * p.H));
  const float* blk = p.dq_acc + dq_block(p, b, h, row / 64, HD) + cv * 8 / 64 * 4096;
  const int slot = fragment_slot(row % 64, cv * 8 % 64);  // columns 2tq, 2tq + 1 of tq = 0..3
  const float2 a0 = *reinterpret_cast<const float2*>(blk + slot);
  const float2 a1 = *reinterpret_cast<const float2*>(blk + slot + 4);
  const float2 a2 = *reinterpret_cast<const float2*>(blk + slot + 8);
  const float2 a3 = *reinterpret_cast<const float2*>(blk + slot + 12);
  const float4 x = make_float4(a0.x, a0.y, a1.x, a1.y), y = make_float4(a2.x, a2.y, a3.x, a3.y);
  const float s = p.scale;
  uint4 out;
  out.x = Wg<T>::pack(x.x * s, x.y * s);
  out.y = Wg<T>::pack(x.z * s, x.w * s);
  out.z = Wg<T>::pack(y.x * s, y.y * s);
  out.w = Wg<T>::pack(y.z * s, y.w * s);
  *reinterpret_cast<uint4*>(static_cast<T*>(p.dq) + b * p.dq_sb + row * p.dq_ss + h * p.dq_sh +
                            cv * 8) = out;
}

// tm_*: the maps of the 64-column boxes; tn_*: those of the 16-column boxes (only
// where the head has them: head_dim 80)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tn_q,
                          const __grid_constant__ CUtensorMap tn_k,
                          const __grid_constant__ CUtensorMap tn_v,
                          const __grid_constant__ CUtensorMap tn_do, const BwdParams p) {
  using C = Cfg<HD>;
  constexpr int BM = C::BM, kBN = C::kBN, kStages = C::kStages;
  constexpr int kB64 = C::kBoxes64, kB16 = C::kBoxes16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // every tile starts on a 1024-byte boundary: the swizzle pattern's period
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + C::kBar;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };
  const uint32_t kv_full = bar + 16 * kStages, kv_empty = kv_full + 8;
  auto ds_full = [&](int u) { return kv_empty + 8 * (1 + u); };
  constexpr int kDqBufs = C::kDqBufs;
  auto dq_full = [&](int c, int b) { return kv_empty + 8 * (3 + c * kDqBufs + b); };
  auto dq_empty = [&](int c, int b) { return kv_empty + 8 * (3 + (2 + c) * kDqBufs + b); };
  auto sDQ = [&](int c, int b) { return base + C::kDQ + (c * kDqBufs + b) * C::kDqBytes; };
  auto sum_full = [&](int b) { return kv_empty + 8 * (3 + 4 * kDqBufs + b); };
  const uint32_t sK = base + C::kK, sV = base + C::kV;
  auto sQ = [&](int s) { return base + C::kQ + s * C::kQBytes; };
  auto sdO = [&](int s) { return base + C::kdO + s * C::kQBytes; };
  auto sDS = [&](int u) { return base + C::kDS + u * C::kDSBytes; };
  auto sP = [&](int u) { return base + C::kP + u * C::kDSBytes; };
  auto sLD = [&](int s) { return base + C::kLD + s * 2 * BM * 4; };

  const int G = p.H / p.KV;
  const int sq_p = sq_pad(p.Sq);
  const int n_work = (p.Skv + kBN - 1) / kBN * p.KV * p.B;
  struct Work {
    int n0, kvh, b, lo, n_qt;
  };
  // Round j gives the blocks the next gridDim.x work tiles, in turn forwards and
  // backwards (a block that got a heavier tile in one round gets a lighter one next).
  auto work_index = [&](int j) {
    const int n = gridDim.x, i = blockIdx.x;
    return j * n + ((j & 1) ? n - 1 - i : i);
  };
  auto work = [&](int w) {
    Work t;
    const int hb = w % (p.KV * p.B);
    t.n0 = w / (p.KV * p.B) * kBN;
    t.kvh = hb % p.KV;
    t.b = hb / p.KV;
    int hi;
    q_range(p, t.n0, kBN, BM, t.lo, hi);
    t.n_qt = hi > t.lo ? (hi - t.lo + BM - 1) / BM : 0;
    return t;
  };
  // Step i of a work tile: its query head and query tile, the last tile first and the
  // heads inside, so blocks that started together load the same Q / dO tiles and add
  // into the same dq rows at about the same time (faster at the training shape than
  // heads outside and the first tile first, PERF.md)
  auto step_h = [&](const Work& t, int i) { return t.kvh * G + i % G; };
  auto step_m0 = [&](const Work& t, int i) { return t.lo + (t.n_qt - 1 - i / G) * BM; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);
    for (int u = 0; u < 2; ++u) mbar_init(ds_full(u), 256);  // every consumer thread
    for (int c = 0; c < 2; ++c)
      for (int b = 0; b < kDqBufs; ++b) {
        mbar_init(dq_full(c, b), 128);  // every thread of consumer c
        mbar_init(dq_empty(c, b), 1);   // the writer
      }
    for (int b = 0; b < kDqBufs; ++b) mbar_init(sum_full(b), 64);  // the summing threads
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 32) {
      // the writer: each step's two staged dQ blocks (at head_dim 80 their sum) are
      // added into dq_acc with TMA bulk reduce-adds (rows past Sq add zeros into the
      // padding); a buffer goes back to its consumer once the adds have read it
      if constexpr (!C::kWide) {
        int it = 0;
        for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
          const Work t = work(w);
          const int n_steps = G * t.n_qt;
          for (int i = 0; i < n_steps; ++i, ++it) {
            const int h = step_h(t, i), m0 = step_m0(t, i);
            const int b = it % kDqBufs;
            for (int c = 0; c < (C::kDqSum ? 1 : 2); ++c) {
              if constexpr (C::kDqSum) mbar_wait(sum_full(b), (it / kDqBufs) & 1);
              else mbar_wait(dq_full(c, b), (it / kDqBufs) & 1);
              float* blk = p.dq_acc + dq_block(p, t.b, h, (m0 + C::kDqRowStep * c) / 64, HD) +
                           C::kDqColBlk * c * 4096;
              asm volatile(
                  "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
                  ::"l"(blk), "r"(sDQ(c, b)), "n"(C::kDqBytes)
                  : "memory");
              asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
            }
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
            mbar_arrive_if(dq_empty(0, b), true);
            mbar_arrive_if(dq_empty(1, b), true);
          }
        }
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // the adds are done
      }
    } else if (C::kDqSum && threadIdx.x >= 64) {
      // warps 2 and 3 add consumer 1's staged partial dQ into consumer 0's, so that
      // the writer adds one block a step into the accumulator
      const int u = threadIdx.x - 64;
      int it = 0;
      for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
        const Work t = work(w);
        const int n_steps = G * t.n_qt;
        for (int i = 0; i < n_steps; ++i, ++it) {
          const int b = it % kDqBufs;
          mbar_wait(dq_full(0, b), (it / kDqBufs) & 1);
          mbar_wait(dq_full(1, b), (it / kDqBufs) & 1);
          for (int x = u; x < C::kDqBytes / 16; x += 64) {
            const float4 a = lds128(sDQ(0, b) + x * 16), d = lds128(sDQ(1, b) + x * 16);
            asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(sDQ(0, b) + x * 16),
                         "f"(a.x + d.x), "f"(a.y + d.y), "f"(a.z + d.z), "f"(a.w + d.w) : "memory");
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive_if(sum_full(b), true);
        }
      }
    } else if (threadIdx.x == 0) {
      auto prefetch = [](const CUtensorMap* m) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
      };
      if constexpr (kB64 > 0) {
        prefetch(&tm_q);
        prefetch(&tm_k);
        prefetch(&tm_v);
        prefetch(&tm_do);
      }
      if constexpr (kB16 > 0) {
        prefetch(&tn_q);
        prefetch(&tn_k);
        prefetch(&tn_v);
        prefetch(&tn_do);
      }
      // one tile of `rows` rows from row r0 of (head h, batch b) into dst: its
      // 64-column boxes, then its 16-column ones, all completing on barrier `done`
      auto load = [&](uint32_t dst, const CUtensorMap* wide, const CUtensorMap* narrow,
                      uint32_t done, int rows, int r0, int h, int b) {
#pragma unroll
        for (int x = 0; x < kB64; ++x)
          tma_load_4d(dst + x * rows * 128, wide, done, x * kBoxCols, r0, h, b);
#pragma unroll
        for (int y = 0; y < kB16; ++y)
          tma_load_4d(dst + C::box16(rows, y), narrow, done, kB64 * kBoxCols + y * kNarrowCols,
                      r0, h, b);
      };
      const float* lse2 = p.delta + (long long)p.B * p.H * sq_p;
      // j: this block's work tiles so far; it: its steps so far (the ring's position
      // and phase run on across work tiles)
      int it = 0;
      for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
        const Work t = work(w);
        mbar_wait(kv_empty, (j & 1) ^ 1);  // work tile 0: a fresh barrier passes
        mbar_expect_tx(kv_full, 2 * C::kKVBytes);
        load(sK, &tm_k, &tn_k, kv_full, kBN, t.n0, t.kvh, t.b);
        load(sV, &tm_v, &tn_v, kv_full, kBN, t.n0, t.kvh, t.b);
        const int n_steps = G * t.n_qt;
        for (int i = 0; i < n_steps; ++i, ++it) {
          const int s = it % kStages;
          const int h = step_h(t, i), m0 = step_m0(t, i);
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // the first kStages pass
          mbar_expect_tx(full(s), 2 * C::kQBytes + 2 * BM * 4);
          load(sQ(s), &tm_q, &tn_q, full(s), BM, m0, h, t.b);
          load(sdO(s), &tm_do, &tn_do, full(s), BM, m0, h, t.b);
          const long long r0 = ((long long)t.b * p.H + h) * sq_p + m0;
          bulk_load(sLD(s), lse2 + r0, BM * 4, full(s));
          bulk_load(sLD(s) + BM * 4, p.delta + r0, BM * 4, full(s));
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int offset = p.Skv - p.Sq;
    const float sl2 = p.scale * kLog2e;
    constexpr int kQCols = C::kQCols, kKVCols = C::kKVCols, kDqCols = C::kDqCols;
    const int row0 = C::kRow0 * c;    // this warpgroup's first key row of the tile
    const int qc0 = C::kQCol0 * c;    // its first query column of S^T
    const int kvc0 = C::kKVCol0 * c;  // its first column of dk and dv
    const int dq_key0 = C::kDqKey0 * c;

    float dk[kKVCols / 2], dv[kKVCols / 2];
    float st[kQCols / 2], dpt[kQCols / 2];  // S^T then P^T, dP^T then dS^T: 64 keys x kQCols
    float dq[kDqCols / 2];                  // this warpgroup's 64 x kDqCols of dQ
    uint32_t pa[kQCols / 16][4], da[kQCols / 16][4];  // P^T, dS^T as the A operands

    int it = 0;  // this block's steps so far: the stage, the dS^T buffer and their phases
    for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
      const Work tw = work(w);
      const int k_lo = tw.n0 + row0;            // this warpgroup's first key
      const int key0 = k_lo + warp * 16 + g;    // this thread's keys: key0, key0 + 8
#pragma unroll
      for (int i = 0; i < kKVCols / 2; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(kv_full, j & 1);
      const int n_steps = G * tw.n_qt;
      for (int i = 0; i < n_steps; ++i, ++it) {
        const int s = it % kStages, u = it & 1;
        const int m0 = step_m0(tw, i);
        const int q_lo = m0 + qc0;              // this warpgroup's first query row
        mbar_wait(full(s), (it / kStages) & 1);

        // S^T = K Q^T and dP^T = V dO^T over this warpgroup's keys and query columns:
        // K-major A and B, 32 bytes a k16 step, four in each 64-column box, then one
        // over each 16-column box's whole 32-byte row (8-row groups 256 bytes apart;
        // with no 64-column box, head_dim 32 and 16, the first of them starts S^T)
        if constexpr ((kB16 > 0 && kB64 > 0) || C::kWide) {
          zero(st);
          zero(dpt);
        }
        wgmma_fence();
        {
          auto issue = [&](float (&acc)[kQCols / 2], uint32_t a, uint32_t b) {
            if constexpr (kB64 > 0) {
              const uint64_t ad = opaque(smem_desc(a + row0 * 128, 16, 1024));
              const uint64_t bd = opaque(smem_desc(b + qc0 * 128, 16, 1024));
#pragma unroll
              for (int kk = 0; kk < 4 * kB64; ++kk) {
                const uint32_t box = (kk >> 2) * 128, in = (kk & 3) * 32;  // bytes; >> 4 below
                Wg<T>::template ss<kQCols>(acc, ad + ((box * kBN + in) >> 4),
                                           bd + ((box * BM + in) >> 4), kk > 0);
              }
            }
#pragma unroll
            for (int y = 0; y < kB16; ++y)
              Wg<T>::template ss<kQCols>(
                  acc, opaque(smem_desc(a + C::box16(kBN, y) + row0 * 32, 16, 256, kSwizzle32B)),
                  opaque(smem_desc(b + C::box16(BM, y) + qc0 * 32, 16, 256, kSwizzle32B)),
                  kB64 > 0 || y > 0);
          };
          issue(st, sK, sQ(s));
          issue(dpt, sV, sdO(s));
        }
        wgmma_commit();
        wgmma_wait0();
        pin(st);
        pin(dpt);

        // P^T and dS^T in place: rows are keys, columns query rows q_lo + 8jj + 2tq + e
        const bool need_mask = p.softcap != 0.f || k_lo + 64 > p.Skv ||
                               (p.causal && q_lo + offset < k_lo + 63) ||
                               (p.window > 0 && q_lo + kQCols - 1 + offset - k_lo >= p.window);
        if (need_mask) {
#pragma unroll
          for (int jj = 0; jj < kQCols / 8; ++jj) {
            const float2 l2 = lds64(sLD(s) + (qc0 + jj * 8 + tq * 2) * 4);
            const float2 dd = lds64(sLD(s) + BM * 4 + (qc0 + jj * 8 + tq * 2) * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = key0 + 8 * (e >> 1);
              const int qpos = q_lo + jj * 8 + tq * 2 + (e & 1) + offset;
              bool ok = kpos < p.Skv;
              if (p.causal) ok = ok && qpos >= kpos;
              if (p.window > 0) ok = ok && qpos - kpos < p.window;
              float x = st[4 * jj + e] * p.scale, capd = 1.f;
              if (p.softcap != 0.f) {
                const float th = tanhf(x / p.softcap);
                x = th * p.softcap;
                capd = 1.f - th * th;
              }
              const float pe = ok ? ex2(x * kLog2e - ((e & 1) ? l2.y : l2.x)) : 0.f;
              st[4 * jj + e] = pe;
              dpt[4 * jj + e] = pe * (dpt[4 * jj + e] - ((e & 1) ? dd.y : dd.x)) * capd;
            }
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < kQCols / 8; ++jj) {
            const float2 l2 = lds64(sLD(s) + (qc0 + jj * 8 + tq * 2) * 4);
            const float2 dd = lds64(sLD(s) + BM * 4 + (qc0 + jj * 8 + tq * 2) * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pe = ex2(fmaf(st[4 * jj + e], sl2, -((e & 1) ? l2.y : l2.x)));
              st[4 * jj + e] = pe;
              dpt[4 * jj + e] = pe * (dpt[4 * jj + e] - ((e & 1) ? dd.y : dd.x));
            }
          }
        }
        if constexpr (C::kWide) {
          // P^T and dS^T to shared memory, 16 bits: 64 key rows of 64 query columns
          // (one 128-byte swizzled box each); this warpgroup's are columns qc0..
#pragma unroll
          for (int jj = 0; jj < kQCols / 8; ++jj)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = warp * 16 + g + 8 * r;
              const uint32_t at = row * 128 + ((((qc0 >> 3) + jj) ^ g) << 4) + tq * 4;
              sts32(sP(u) + at, Wg<T>::pack(st[4 * jj + 2 * r], st[4 * jj + 2 * r + 1]));
              sts32(sDS(u) + at, Wg<T>::pack(dpt[4 * jj + 2 * r], dpt[4 * jj + 2 * r + 1]));
            }
        } else {
          // the accumulators of query columns [16kk, 16kk + 16) are, register for
          // register, the A fragment of one k16 step
#pragma unroll
          for (int kk = 0; kk < kQCols / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pa[kk][e] = Wg<T>::pack(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
              da[kk][e] = Wg<T>::pack(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
            }
          // dS^T to shared memory: key rows, 64 query columns (128 bytes) a box,
          // 128-byte swizzle; this thread's rows are row0 + 16warp + g (+ 8).
#pragma unroll
          for (int jj = 0; jj < BM / 8; ++jj)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = row0 + warp * 16 + g + 8 * r;
              sts32(sDS(u) + (jj >> 3) * (kBN * 128) + row * 128 + (((jj & 7) ^ g) << 4) + tq * 4,
                    da[jj >> 1][(jj & 1) * 2 + r]);
            }
        }
        // Buffer u was last read by step it - 2's products, which both warpgroups
        // waited for before they arrived on ds_full for step it - 1, which this
        // warpgroup waited for.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_if(ds_full(u), true);

        // dV += P^T dO and dK += dS^T Q: dO and Q are MN-major B operands (16 query
        // rows are two 8-row groups, SBO 1024; the next 64 columns the next box, LBO)
        if constexpr (C::kWide) {
          // both halves of P^T and dS^T are needed: A from shared memory, K-major;
          // this warpgroup's 128 columns of dO and Q are boxes 2c and 2c + 1
          mbar_wait(ds_full(u), (it >> 1) & 1);
          wgmma_fence();
          const uint64_t pd = opaque(smem_desc(sP(u), 16, 1024));
          const uint64_t od = opaque(smem_desc(sdO(s) + kvc0 / 64 * BM * 128, BM * 128, 1024));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
            Wg<T>::template ss<kKVCols, 0, 1>(dv, pd + ((kk * 32) >> 4),
                                              od + ((kk * 16 * 128) >> 4), 1);
          const uint64_t sd = opaque(smem_desc(sDS(u), 16, 1024));
          const uint64_t qd = opaque(smem_desc(sQ(s) + kvc0 / 64 * BM * 128, BM * 128, 1024));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
            Wg<T>::template ss<kKVCols, 0, 1>(dk, sd + ((kk * 32) >> 4),
                                              qd + ((kk * 16 * 128) >> 4), 1);
        } else if constexpr (C::kSmall) {
          // columns 16y.. (registers 8y..) from 16-column box y (8-row groups 256 bytes
          // apart)
          wgmma_fence();
          const uint64_t on = opaque(smem_desc(sdO(s), BM * 32, 256, kSwizzle32B));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
            for (int y = 0; y < kB16; ++y)
              Wg<T>::template rs<16>(*reinterpret_cast<float(*)[8]>(dv + 8 * y), pa[kk],
                                     on + ((y * BM * 32 + kk * 16 * 32) >> 4), 1);
          const uint64_t qn = opaque(smem_desc(sQ(s), BM * 32, 256, kSwizzle32B));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
            for (int y = 0; y < kB16; ++y)
              Wg<T>::template rs<16>(*reinterpret_cast<float(*)[8]>(dk + 8 * y), da[kk],
                                     qn + ((y * BM * 32 + kk * 16 * 32) >> 4), 1);
        } else if constexpr (kB16 > 0) {
          // columns 0-63 (registers 0-31) from the 64-column box, 64-79 (32-39) from
          // the 16-column one (8-row groups 256 bytes apart)
          wgmma_fence();
          float(&dv64)[32] = *reinterpret_cast<float(*)[32]>(dv);
          float(&dv16)[8] = *reinterpret_cast<float(*)[8]>(dv + 32);
          float(&dk64)[32] = *reinterpret_cast<float(*)[32]>(dk);
          float(&dk16)[8] = *reinterpret_cast<float(*)[8]>(dk + 32);
          const uint64_t od = opaque(smem_desc(sdO(s), BM * 128, 1024));
          const uint64_t on = opaque(smem_desc(sdO(s) + C::box16(BM), BM * 32, 256, kSwizzle32B));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk) {
            Wg<T>::template rs<64>(dv64, pa[kk], od + ((kk * 16 * 128) >> 4), 1);
            Wg<T>::template rs<16>(dv16, pa[kk], on + ((kk * 16 * 32) >> 4), 1);
          }
          const uint64_t qd = opaque(smem_desc(sQ(s), BM * 128, 1024));
          const uint64_t qn = opaque(smem_desc(sQ(s) + C::box16(BM), BM * 32, 256, kSwizzle32B));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk) {
            Wg<T>::template rs<64>(dk64, da[kk], qd + ((kk * 16 * 128) >> 4), 1);
            Wg<T>::template rs<16>(dk16, da[kk], qn + ((kk * 16 * 32) >> 4), 1);
          }
        } else {
          wgmma_fence();
          const uint64_t od = opaque(smem_desc(sdO(s), BM * 128, 1024));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
            Wg<T>::template rs<HD>(dv, pa[kk], od + ((kk * 16 * 128) >> 4), 1);
          const uint64_t qd = opaque(smem_desc(sQ(s), BM * 128, 1024));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
            Wg<T>::template rs<HD>(dk, da[kk], qd + ((kk * 16 * 128) >> 4), 1);
        }
        wgmma_commit();

        if constexpr (C::kWide) {
          wgmma_wait0();  // dV and dK: Q, dO, lse and D of this stage are read
          pin(dk);
          pin(dv);
          mbar_arrive_if(empty(s), lane == 0);
        } else {
          // dQ = dS K once both warpgroups' dS^T is in shared memory: A = dS read
          // transposed (MN-major), B = K MN-major, k16 steps over kDqKeys keys from
          // dq_key0: at head_dim 64, 32 and 16 rows 64c.. of dS (at 32 and 16 each of
          // K's 16-column boxes into dQ's registers 8y..), at 128 columns 64c.. of K, at
          // 80 all 80 columns over this warpgroup's own 64 keys
          mbar_wait(ds_full(u), (it >> 1) & 1);
          wgmma_fence();
          {
            const uint64_t ad = opaque(smem_desc(
                sDS(u) + (C::kDqRowStep ? c : 0) * (kBN * 128) + dq_key0 * 128, kBN * 128, 1024));
            if constexpr (C::kSmall) {
              const uint64_t bn = opaque(smem_desc(sK, kBN * 32, 256, kSwizzle32B));
#pragma unroll
              for (int kk = 0; kk < C::kDqKeys / 16; ++kk)
#pragma unroll
                for (int y = 0; y < kB16; ++y)
                  Wg<T>::template ss<16, 1, 1>(*reinterpret_cast<float(*)[8]>(dq + 8 * y),
                                               ad + ((kk * 16 * 128) >> 4),
                                               bn + ((y * kBN * 32 + kk * 16 * 32) >> 4), kk > 0);
            } else {
              const uint64_t bd = opaque(smem_desc(
                  sK + C::kDqColBlk * c * (kBN * 128) + dq_key0 * 128, kBN * 128, 1024));
              if constexpr (kB16 > 0) {
                float(&dq64)[32] = *reinterpret_cast<float(*)[32]>(dq);
                float(&dq16)[8] = *reinterpret_cast<float(*)[8]>(dq + 32);
                const uint64_t bn = opaque(
                    smem_desc(sK + C::box16(kBN) + dq_key0 * 32, kBN * 32, 256, kSwizzle32B));
#pragma unroll
                for (int kk = 0; kk < C::kDqKeys / 16; ++kk) {
                  Wg<T>::template ss<64, 1, 1>(dq64, ad + ((kk * 16 * 128) >> 4),
                                               bd + ((kk * 16 * 128) >> 4), kk > 0);
                  Wg<T>::template ss<16, 1, 1>(dq16, ad + ((kk * 16 * 128) >> 4),
                                               bn + ((kk * 16 * 32) >> 4), kk > 0);
                }
              } else {
#pragma unroll
                for (int kk = 0; kk < C::kDqKeys / 16; ++kk)
                  Wg<T>::template ss<kDqCols, 1, 1>(dq, ad + ((kk * 16 * 128) >> 4),
                                                    bd + ((kk * 16 * 128) >> 4), kk > 0);
              }
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // dV and dK: Q, dO, lse and D of this stage are read
          pin(dk);
          pin(dv);
          pin_u(pa);
          pin_u(da);
          mbar_arrive_if(empty(s), lane == 0);
          wgmma_wait0();
          pin(dq);

          // dQ to shared memory for the writer warp, in fragment order: 16-byte chunk k
          // of thread t at (128 k + t) * 16 (no bank conflicts); the accumulator holds
          // each 64 x 64 (and 64 x 16) block in the same order
          const int b = it % kDqBufs;
          mbar_wait(dq_empty(c, b), ((it / kDqBufs) & 1) ^ 1);  // the first kDqBufs pass
#pragma unroll
          for (int k = 0; k < kDqCols / 8; ++k)
            asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(sDQ(c, b) + (k * 128 + t) * 16),
                         "f"(dq[4 * k]), "f"(dq[4 * k + 1]), "f"(dq[4 * k + 2]), "f"(dq[4 * k + 3])
                         : "memory");
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive_if(dq_full(c, b), true);
        }
      }
      mbar_arrive_if(kv_empty, lane == 0);  // K and V are read: the next tile's may land

      // the epilogue runs while the producer already loads the next work tile
      T* dkg = static_cast<T*>(p.dk) + tw.b * p.dk_sb + tw.kvh * p.dk_sh + kvc0;
      T* dvg = static_cast<T*>(p.dv) + tw.b * p.dv_sb + tw.kvh * p.dv_sh + kvc0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key < p.Skv) {
          T* krow = dkg + (long long)key * p.dk_ss + tq * 2;
          T* vrow = dvg + (long long)key * p.dv_ss + tq * 2;
#pragma unroll
          for (int jj = 0; jj < kKVCols / 8; ++jj) {
            if (C::kWide && kvc0 + jj * 8 >= p.hd) continue;  // a narrower head's columns only
            *reinterpret_cast<uint32_t*>(krow + jj * 8) =
                Wg<T>::pack(dk[4 * jj + 2 * r] * p.scale, dk[4 * jj + 2 * r + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(vrow + jj * 8) =
                Wg<T>::pack(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
          }
        }
      }
    }
  }
}

// Head_dim 256's dQ pass (the note at the top): shared memory of one block.
struct DqCfg {
  static constexpr int kBM = 64, kBN = 64, HD = 256, kStages = 2;
  static constexpr int kQBytes = kBM * HD * 2;     // a Q or a dO tile
  static constexpr int kKVBytes = kBN * HD * 2;    // a K or a V tile
  static constexpr int kDSBytes = kBM * kBN * 2;   // a dS tile
  static constexpr int kQ = 0;
  static constexpr int kdO = kQ + kQBytes;
  static constexpr int kK = kdO + kQBytes;         // stage s at kK + s * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kDS = kV + kStages * kKVBytes;   // two dS buffers
  static constexpr int kLD = kDS + 2 * kDSBytes;   // lse2[kBM], then D[kBM]
  static constexpr int kBar = kLD + 2 * kBM * 4;
  // barriers: q_full, q_empty, kv_full[2], kv_empty[2], ds_full[2]
  static constexpr int kBytes = kBar + 8 * 8;
  static constexpr int kAlloc = kBytes + 1024;     // room to align the base to 1024
  static_assert(kAlloc <= 232448, "shared memory a block can use");
};

// dq of head_dim 256, written once in the input type: a persistent grid walking work
// tiles of (64-row query tile, query head, batch), the latest query tiles first (under
// a causal mask they see the most keys).  The producer thread brings Q, dO and the
// rows' lse and D once a work tile (one buffer: the next tile's land once the last S
// and dP products have read these) and K / V tiles of 64 keys through a two-stage ring.
// A step, in each consumer warpgroup c: S and dP over keys 32c.. of the tile (m64n32k16,
// 16 k16 steps; Q, dO, K and V K-major), P and dS in registers (the rows' lse and D
// held in registers for the work tile), dS to shared memory (16 bits, double-buffered,
// one mbarrier for both halves), then dQ += dS K over columns 128c.. (m64n128k16, A =
// dS K-major, B = K MN-major); the stage goes back once dQ has read K.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_dq_pass_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const __grid_constant__ CUtensorMap tm_do, const BwdParams p) {
  using D = DqCfg;
  constexpr int kBM = D::kBM, kBN = D::kBN, HD = D::HD;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + D::kBar;
  const uint32_t q_full = bar, q_empty = bar + 8;
  auto kv_full = [&](int s) { return bar + 16 + 8 * s; };
  auto kv_empty = [&](int s) { return bar + 32 + 8 * s; };
  auto ds_full = [&](int u) { return bar + 48 + 8 * u; };
  const uint32_t sQ = base + D::kQ, sdO = base + D::kdO, sLD = base + D::kLD;
  auto sK = [&](int s) { return base + D::kK + s * D::kKVBytes; };
  auto sV = [&](int s) { return base + D::kV + s * D::kKVBytes; };
  auto sDS = [&](int u) { return base + D::kDS + u * D::kDSBytes; };

  const int sq_p = sq_pad(p.Sq);
  const int n_qt = (p.Sq + kBM - 1) / kBM;
  const int HB = p.H * p.B;
  const int n_work = n_qt * HB;
  struct Work {
    int q0, h, b, kvh, lo, n_tiles;
  };
  // Round j gives the blocks the next gridDim.x work tiles, in turn forwards and
  // backwards, as the one-pass kernel does
  auto work_index = [&](int j) {
    const int n = gridDim.x, i = blockIdx.x;
    return j * n + ((j & 1) ? n - 1 - i : i);
  };
  auto work = [&](int w) {
    Work t;
    t.q0 = (n_qt - 1 - w / HB) * kBM;
    const int hb = w % HB;
    t.h = hb % p.H;
    t.b = hb / p.H;
    t.kvh = t.h / (p.H / p.KV);
    int hi;
    kv_range(p, t.q0, kBM, kBN, t.lo, hi);
    t.n_tiles = hi > t.lo ? (hi - t.lo + kBN - 1) / kBN : 0;
    return t;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < D::kStages; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), 8);
    }
    for (int u = 0; u < 2; ++u) mbar_init(ds_full(u), 256);  // every consumer thread
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      auto prefetch = [](const CUtensorMap* m) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
      };
      prefetch(&tm_q);
      prefetch(&tm_k);
      prefetch(&tm_v);
      prefetch(&tm_do);
      auto load = [&](uint32_t dst, const CUtensorMap* m, uint32_t done, int rows, int r0, int h,
                      int b) {
#pragma unroll
        for (int x = 0; x < HD / kBoxCols; ++x)
          tma_load_4d(dst + x * rows * 128, m, done, x * kBoxCols, r0, h, b);
      };
      const float* lse2 = p.delta + (long long)p.B * p.H * sq_p;
      int g = 0;  // K/V tiles so far: the ring's position and phase
      for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
        const Work t = work(w);
        mbar_wait(q_empty, (j & 1) ^ 1);  // work tile 0: a fresh barrier passes
        mbar_expect_tx(q_full, 2 * D::kQBytes + 2 * kBM * 4);
        load(sQ, &tm_q, q_full, kBM, t.q0, t.h, t.b);
        load(sdO, &tm_do, q_full, kBM, t.q0, t.h, t.b);
        const long long r0 = ((long long)t.b * p.H + t.h) * sq_p + t.q0;
        bulk_load(sLD, lse2 + r0, kBM * 4, q_full);
        bulk_load(sLD + kBM * 4, p.delta + r0, kBM * 4, q_full);
        for (int i = 0; i < t.n_tiles; ++i, ++g) {
          const int s = g & 1;
          mbar_wait(kv_empty(s), ((g >> 1) & 1) ^ 1);  // the first two pass
          mbar_expect_tx(kv_full(s), 2 * D::kKVBytes);
          load(sK(s), &tm_k, kv_full(s), kBN, t.lo + i * kBN, t.kvh, t.b);
          load(sV(s), &tm_v, kv_full(s), kBN, t.lo + i * kBN, t.kvh, t.b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;  // which 32 keys of a tile, which 128 columns of dQ
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int offset = p.Skv - p.Sq;
    const float sl2 = p.scale * kLog2e;
    float dq[64];            // 64 rows x 128 columns
    float st[16], dpt[16];   // S then P, dP then dS: 64 rows x 32 keys

    int gi = 0;  // K/V tiles so far: the stage, the dS buffer and their phases
    for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
      const Work tw = work(w);
      zero(dq);
      mbar_wait(q_full, j & 1);
      float l2[2], dd[2];
      int qpos[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        l2[r] = lds32f(sLD + row * 4);
        dd[r] = lds32f(sLD + (kBM + row) * 4);
        qpos[r] = tw.q0 + row + offset;
      }
      mbar_arrive_if(q_empty, lane == 0 && tw.n_tiles == 0);
      for (int i = 0; i < tw.n_tiles; ++i, ++gi) {
        const int s = gi & 1, u = gi & 1;
        const int k_lo = tw.lo + i * kBN + 32 * c;  // this warpgroup's first key
        mbar_wait(kv_full(s), (gi >> 1) & 1);

        // S = Q K^T and dP = dO V^T over this warpgroup's 32 keys: K-major A and B,
        // four k16 steps in each 64-column box
        zero(st);
        zero(dpt);
        wgmma_fence();
        {
          auto issue = [&](float (&acc)[16], uint32_t a, uint32_t b) {
            const uint64_t ad = opaque(smem_desc(a, 16, 1024));
            const uint64_t bd = opaque(smem_desc(b + 32 * c * 128, 16, 1024));
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
              const uint32_t box = (kk >> 2) * 128, in = (kk & 3) * 32;  // bytes; >> 4 below
              Wg<T>::template ss<32>(acc, ad + ((box * kBM + in) >> 4),
                                     bd + ((box * kBN + in) >> 4), kk > 0);
            }
          };
          issue(st, sQ, sK(s));
          issue(dpt, sdO, sV(s));
        }
        wgmma_commit();
        wgmma_wait0();
        pin(st);
        pin(dpt);
        mbar_arrive_if(q_empty, lane == 0 && i == tw.n_tiles - 1);  // Q and dO are read

        // P and dS in place: rows q0 + 16warp + g (+ 8), keys k_lo + 8jj + 2tq + e
        const bool need_mask = p.softcap != 0.f || k_lo + 32 > p.Skv ||
                               (p.causal && k_lo + 31 > tw.q0 + offset) ||
                               (p.window > 0 && tw.q0 + kBM - 1 + offset - k_lo >= p.window);
        if (need_mask) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, kpos = k_lo + jj * 8 + tq * 2 + (e & 1);
              bool ok = kpos < p.Skv;
              if (p.causal) ok = ok && qpos[r] >= kpos;
              if (p.window > 0) ok = ok && qpos[r] - kpos < p.window;
              float x = st[4 * jj + e] * p.scale, capd = 1.f;
              if (p.softcap != 0.f) {
                const float th = tanhf(x / p.softcap);
                x = th * p.softcap;
                capd = 1.f - th * th;
              }
              const float pe = ok ? ex2(x * kLog2e - l2[r]) : 0.f;
              dpt[4 * jj + e] = pe * (dpt[4 * jj + e] - dd[r]) * capd;
            }
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const float pe = ex2(fmaf(st[4 * jj + e], sl2, -l2[r]));
              dpt[4 * jj + e] = pe * (dpt[4 * jj + e] - dd[r]);
            }
        }
        // dS to shared memory, 16 bits: 64 rows of 64 keys (one 128-byte swizzled
        // box); this warpgroup's keys are 16-byte chunks 4c.. of a row.  Buffer u was
        // last read by tile gi - 2's dQ products, which both warpgroups waited for
        // before they arrived on ds_full for tile gi - 1, which this one waited for.
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;
            sts32(sDS(u) + row * 128 + (((4 * c + jj) ^ g) << 4) + tq * 4,
                  Wg<T>::pack(dpt[4 * jj + 2 * r], dpt[4 * jj + 2 * r + 1]));
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_if(ds_full(u), true);
        mbar_wait(ds_full(u), (gi >> 1) & 1);

        // dQ += dS K: A = dS K-major, B = K MN-major over columns 128c.. (boxes 2c,
        // 2c + 1; 16 keys are two 8-row groups, SBO 1024)
        wgmma_fence();
        {
          const uint64_t ad = opaque(smem_desc(sDS(u), 16, 1024));
          const uint64_t bd = opaque(smem_desc(sK(s) + 2 * c * kBN * 128, kBN * 128, 1024));
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk)
            Wg<T>::template ss<128, 0, 1>(dq, ad + ((kk * 32) >> 4),
                                          bd + ((kk * 16 * 128) >> 4), 1);
        }
        wgmma_commit();
        wgmma_wait0();
        pin(dq);
        mbar_arrive_if(kv_empty(s), lane == 0);  // K and V of this stage are read
      }

      // dq = dQ * scale in the input type, rows past Sq not stored
      T* dqg = static_cast<T*>(p.dq) + tw.b * p.dq_sb + tw.h * p.dq_sh + 128 * c;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = tw.q0 + warp * 16 + g + 8 * r;
        if (row < p.Sq) {
          T* qrow = dqg + (long long)row * p.dq_ss + tq * 2;
#pragma unroll
          for (int jj = 0; jj < 16; ++jj)
            if (128 * c + jj * 8 < p.hd)  // a narrower head's columns only
              *reinterpret_cast<uint32_t*>(qrow + jj * 8) =
                Wg<T>::pack(dq[4 * jj + 2 * r] * p.scale, dq[4 * jj + 2 * r + 1] * p.scale);
        }
      }
    }
  }
}

template <typename T, int HD>
int launch_hd(const BwdParams& p, CUtensorMapDataType type, cudaStream_t st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -4;
  constexpr int BM = Cfg<HD>::BM, kBN = Cfg<HD>::kBN;
  // every map is encoded before anything is launched: a refusal touches nothing; the
  // 16-column boxes' maps stay zeros where a head has none (the kernel never reads them)
  CUtensorMap tq{}, tk{}, tv{}, tdo{}, nq{}, nk{}, nv{}, ndo{};
  if (Cfg<HD>::kBoxes64 > 0 &&
      (!encode(fn, &tq, p.q, type, p.hd, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, BM) ||
       !encode(fn, &tdo, p.dout, type, p.hd, p.Sq, p.H, p.B, p.do_ss, p.do_sh, p.do_sb, BM) ||
       !encode(fn, &tk, p.k, type, p.hd, p.Skv, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, kBN) ||
       !encode(fn, &tv, p.v, type, p.hd, p.Skv, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, kBN)))
    return -3;
  constexpr int n16 = kNarrowCols;
  constexpr CUtensorMapSwizzle sw32 = CU_TENSOR_MAP_SWIZZLE_32B;
  if (Cfg<HD>::kBoxes16 > 0 &&
      (!encode(fn, &nq, p.q, type, p.hd, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, BM, n16, sw32) ||
       !encode(fn, &ndo, p.dout, type, p.hd, p.Sq, p.H, p.B, p.do_ss, p.do_sh, p.do_sb, BM, n16,
               sw32) ||
       !encode(fn, &nk, p.k, type, p.hd, p.Skv, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, kBN, n16, sw32) ||
       !encode(fn, &nv, p.v, type, p.hd, p.Skv, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, kBN, n16, sw32)))
    return -3;
  auto kern = flash_bwd_sm90_kernel<T, HD>;
  constexpr int smem = Cfg<HD>::kAlloc;
  static bool raised = false;  // per instantiation
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  int sms = 0;
  cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return (int)e;

  constexpr int kPrepWarps = 8;
  const long long rows = (long long)p.B * p.H * sq_pad(p.Sq);
  flash_bwd_sm90_prep_kernel<T, HD>
      <<<(unsigned)((rows + kPrepWarps - 1) / kPrepWarps), kPrepWarps * 32, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long work = (long long)((p.Skv + kBN - 1) / kBN) * p.KV * p.B;
  const int blocks = (int)(work < sms ? work : sms);  // one block per SM walks the work tiles
  kern<<<blocks, kThreads, smem, st>>>(tq, tk, tv, tdo, nq, nk, nv, ndo, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  if constexpr (Cfg<HD>::kWide) {  // head_dim 256: dq in a pass of its own
    auto dq_pass = flash_bwd_sm90_dq_pass_kernel<T>;
    static bool raised_dq = false;
    if (!raised_dq) {
      e = cudaFuncSetAttribute(dq_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqCfg::kAlloc);
      if (e != cudaSuccess) return (int)e;
      raised_dq = true;
    }
    const long long dq_work = (long long)((p.Sq + DqCfg::kBM - 1) / DqCfg::kBM) * p.H * p.B;
    dq_pass<<<(int)(dq_work < sms ? dq_work : sms), kThreads, DqCfg::kAlloc, st>>>(tq, tk, tv,
                                                                                  tdo, p);
    return (int)cudaGetLastError();
  }

  const long long packs = (long long)p.B * p.H * p.Sq * (HD / 8);
  flash_bwd_sm90_dq_kernel<T, HD><<<(unsigned)((packs + 255) / 256), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// Head_dim HD's call on the kernels of kernel_head_dim(HD): itself, or 224 on 256's
// with tensor maps of p.hd columns.
template <typename T, int HD>
int launch(const BwdParams& p, CUtensorMapDataType type, cudaStream_t st) {
  return launch_hd<T, kernel_head_dim(HD)>(p, type, st);
}

}  // namespace

int launch_bwd_sm90(const BwdParams& p, int hd, int dtype, cudaStream_t st) {
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
