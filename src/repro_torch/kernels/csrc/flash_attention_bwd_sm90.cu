// Fused attention backward for Hopper (sm_90a): TMA + wgmma, warp-specialised.
// 16-bit inputs (bf16, fp16) at head_dim 64 and 128; plain C++ launcher called
// from repro_flash_attention_bwd (flash_attention_bwd.cu) through
// flash::launch_bwd_sm90.
//
// Replaces the backward of the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel's VJP: _flash_vjp_bwd differentiates mha_reference; the reference
// has no backward kernel) for those shapes.  It computes what flash_attention_bwd.cu
// states, with the same masks (causal, window, ragged tails, query offset Skv - Sq)
// and softcap derivative: dq, dk, dv from q, k, v, o, lse and dO, dk and dv summed
// over the G = H / KV query heads of each KV head.
//
// Bound on this card: operations.  10 * hd flops per visible (query, key) pair (Q K^T,
// dO V^T, P^T dO, dS K, dS^T Q), ~0.6 TFLOP at the training shape against ~0.3 GB
// moved.  The mma.sync kernels ran at ~99 TFLOP/s of that work: every warp loaded its
// own fragments and issued its products in order (latency inside the warp), and the
// two passes recomputed Q K^T and dO V^T (14 * hd a pair).  What this design does
// (FlashAttention-3's backward):
//   * one pass: a persistent grid, one block per SM, walking work tiles of (batch,
//     KV head, 128-key tile), early key tiles first (under causal masking they see the
//     most queries), handed out forwards and backwards in turn;
//   * 3 warpgroups: warpgroup 0 is the producer (setmaxnreg.dec 40; one thread issues
//     every TMA load, one more every dQ add, below), warpgroups 1 and 2 are consumers
//     owning 64 of the tile's keys each (setmaxnreg.inc 232);
//   * TMA brings K and V of the tile once and, for each query tile that can see the
//     keys (64 rows at head_dim 128, 128 at 64; the last first) and each query head
//     of the group, Q, dO and the rows' lse and D through a two-stage ring with
//     full/empty mbarriers (a stage is released once dV and dK have read it, before
//     dQ is done), 128-byte swizzled, over the caller's strides;
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
//   * dQ is added into an fp32 accumulator (B H sq_pad(Sq) hd floats in 64 x 64
//     blocks, each block in the consumers' fragment order): each consumer stages its
//     block in shared memory (two buffers at head_dim 128, one at 64) and the
//     producer warpgroup's writer thread adds it with a TMA bulk reduce-add
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
//     the accumulator; a last kernel scales it and casts it into dq.
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

constexpr int kBN = 128;          // keys per work tile (64 per consumer warpgroup)
constexpr int kStages = 2;        // the Q / dO / lse / D ring
constexpr int kThreads = 384;     // producer + two consumer warpgroups

// Tile shapes by head_dim, as FlashAttention-3 takes them: BM query rows a step.
template <int HD>
struct Cfg {
  static constexpr int BM = HD == 128 ? 64 : 128;
  static constexpr int kBoxes = HD / kBoxCols;     // 64-column boxes of a row
  static constexpr int kQBytes = BM * HD * 2;      // one Q or one dO tile
  static constexpr int kKVBytes = kBN * HD * 2;    // one K or one V tile
  static constexpr int kDSBytes = kBN * BM * 2;    // one dS^T tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;                // stage s at kQ + s * kQBytes
  static constexpr int kdO = kQ + kStages * kQBytes;
  static constexpr int kDS = kdO + kStages * kQBytes;     // two dS^T buffers
  static constexpr int kLD = kDS + 2 * kDSBytes;          // stage s: lse2[BM], then D[BM]
  // dQ blocks staged for the writer thread: kDqBufs for each consumer (two at head_dim
  // 128; at 64 the dS^T buffers are twice as large and one fits)
  static constexpr int kDqBufs = HD == 128 ? 2 : 1;
  static constexpr int kDQ = kLD + kStages * 2 * BM * 4;
  static constexpr int kBar = kDQ + 2 * kDqBufs * 64 * 64 * 4;
  // barriers: full[kStages], empty[kStages], kv_full, kv_empty, ds_full[2],
  // dq_full[2][kDqBufs], dq_empty[2][kDqBufs]
  static constexpr int kBytes = kBar + (2 * kStages + 4 + 4 * kDqBufs) * 8;
  static constexpr int kAlloc = kBytes + 1024;            // room to align the base to 1024
};

template <typename T> __device__ __forceinline__ float f32(T v);
template <> __device__ __forceinline__ float f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float f32<__half>(__half v) { return __half2float(v); }

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
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
  if (row < p.Sq) {  // HD / 32 consecutive elements a lane: one 4- or 8-byte load each
    constexpr int E = HD / 32;
    using V = typename std::conditional<E == 4, uint2, uint32_t>::type;
    const T* o = static_cast<const T*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh + lane * E;
    const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + row * p.do_ss + h * p.do_sh + lane * E;
    const V ov = *reinterpret_cast<const V*>(o), dv = *reinterpret_cast<const V*>(d);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int i = 0; i < E; ++i) acc += f32<T>(oe[i]) * f32<T>(de[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    p.delta[idx] = acc;
    p.delta[rows + idx] =
        row < p.Sq ? p.lse[((long long)b * p.H + h) * p.Sq + row] * kLog2e : __int_as_float(0x7f800000);
  }
  float4* z = reinterpret_cast<float4*>(p.dq_acc + idx * HD);
  for (int i = lane; i < HD / 4; i += 32) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The dq accumulator is made of 64 x 64 blocks, (b, h, 64-row block rb, 64-column
// block cb) in that order, each held in the consumers' fragment order: element
// (row, col) of a block at fragment_slot(row, col).  The float offset of a block:
__device__ __forceinline__ long long dq_block(const BwdParams& p, int b, int h, int rb, int cb,
                                              int hd) {
  return ((((long long)b * p.H + h) * (sq_pad(p.Sq) / 64) + rb) * (hd / 64) + cb) * 4096;
}

// Where a consumer thread's accumulator element sits in its warpgroup's 64 x 64 block:
// thread t = 32 warp + 4 g + tq holds rows 16 warp + g (+ 8 r), columns 8 jj + 2 tq
// (+ e) in register i = 4 jj + 2 r + e, stored as 16-byte chunk jj of thread t at
// float (128 jj + t) * 4.
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
  const float* blk = p.dq_acc + dq_block(p, b, h, row / 64, cv * 8 / 64, HD);
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do, const BwdParams p) {
  using C = Cfg<HD>;
  constexpr int BM = C::BM;
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
  auto sDQ = [&](int c, int b) { return base + C::kDQ + (c * kDqBufs + b) * 64 * 64 * 4; };
  const uint32_t sK = base + C::kK, sV = base + C::kV;
  auto sQ = [&](int s) { return base + C::kQ + s * C::kQBytes; };
  auto sdO = [&](int s) { return base + C::kdO + s * C::kQBytes; };
  auto sDS = [&](int u) { return base + C::kDS + u * C::kDSBytes; };
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 32) {
      // the writer: each step's two staged dQ blocks are added into dq_acc with TMA
      // bulk reduce-adds (rows past Sq add zeros into the padding); a buffer goes
      // back to its consumer once the adds have read it
      int it = 0;
      for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
        const Work t = work(w);
        const int n_steps = G * t.n_qt;
        for (int i = 0; i < n_steps; ++i, ++it) {
          const int h = step_h(t, i), m0 = step_m0(t, i);
          const int b = it % kDqBufs;
          for (int c = 0; c < 2; ++c) {
            mbar_wait(dq_full(c, b), (it / kDqBufs) & 1);
            float* blk = p.dq_acc + dq_block(p, t.b, h, (m0 + (BM == 128 ? 64 * c : 0)) / 64,
                                             HD == 128 ? c : 0, HD);
            asm volatile(
                "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
                ::"l"(blk), "r"(sDQ(c, b)), "n"(64 * 64 * 4)
                : "memory");
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          }
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive_if(dq_empty(0, b), true);
          mbar_arrive_if(dq_empty(1, b), true);
        }
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // the adds are done
    } else if (threadIdx.x == 0) {
      auto prefetch = [](const CUtensorMap* m) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
      };
      prefetch(&tm_q);
      prefetch(&tm_k);
      prefetch(&tm_v);
      prefetch(&tm_do);
      const float* lse2 = p.delta + (long long)p.B * p.H * sq_p;
      // j: this block's work tiles so far; it: its steps so far (the ring's position
      // and phase run on across work tiles)
      int it = 0;
      for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
        const Work t = work(w);
        mbar_wait(kv_empty, (j & 1) ^ 1);  // work tile 0: a fresh barrier passes
        mbar_expect_tx(kv_full, 2 * C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load_4d(sK + x * kBN * 128, &tm_k, kv_full, x * kBoxCols, t.n0, t.kvh, t.b);
          tma_load_4d(sV + x * kBN * 128, &tm_v, kv_full, x * kBoxCols, t.n0, t.kvh, t.b);
        }
        const int n_steps = G * t.n_qt;
        for (int i = 0; i < n_steps; ++i, ++it) {
          const int s = it % kStages;
          const int h = step_h(t, i), m0 = step_m0(t, i);
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // the first kStages pass
          mbar_expect_tx(full(s), 2 * C::kQBytes + 2 * BM * 4);
#pragma unroll
          for (int x = 0; x < C::kBoxes; ++x) {
            tma_load_4d(sQ(s) + x * BM * 128, &tm_q, full(s), x * kBoxCols, m0, h, t.b);
            tma_load_4d(sdO(s) + x * BM * 128, &tm_do, full(s), x * kBoxCols, m0, h, t.b);
          }
          const long long r0 = ((long long)t.b * p.H + h) * sq_p + m0;
          bulk_load(sLD(s), lse2 + r0, BM * 4, full(s));
          bulk_load(sLD(s) + BM * 4, p.delta + r0, BM * 4, full(s));
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;                  // which 64 keys of the tile
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int offset = p.Skv - p.Sq;
    const float sl2 = p.scale * kLog2e;
    // dQ's share of this warpgroup: at head_dim 128 columns [64c, 64c + 64) of all
    // BM = 64 rows, at 64 rows [64c, 64c + 64) of BM = 128, all 64 columns
    constexpr int kDqRowStep = BM == 128 ? 64 : 0;
    constexpr int kDqColStep = HD == 128 ? 64 : 0;

    float dk[HD / 2], dv[HD / 2];
    float st[BM / 2], dpt[BM / 2];  // S^T then P^T, dP^T then dS^T: 64 keys x BM rows
    float dq[32];                   // this warpgroup's 64 x 64 of dQ
    uint32_t pa[BM / 16][4], da[BM / 16][4];  // P^T, dS^T as the A operands

    int it = 0;  // this block's steps so far: the stage, the dS^T buffer and their phases
    for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
      const Work tw = work(w);
      const int k_lo = tw.n0 + c * 64;          // this warpgroup's first key
      const int key0 = k_lo + warp * 16 + g;    // this thread's keys: key0, key0 + 8
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(kv_full, j & 1);
      const int n_steps = G * tw.n_qt;
      for (int i = 0; i < n_steps; ++i, ++it) {
        const int s = it % kStages, u = it & 1;
        const int m0 = step_m0(tw, i);
        mbar_wait(full(s), (it / kStages) & 1);

        // S^T = K_c Q^T and dP^T = V_c dO^T: K-major A and B, 32 bytes a k16 step,
        // the second 64 columns of a 128-wide head in the next box
        wgmma_fence();
        {
          const uint64_t kd = opaque(smem_desc(sK + c * 64 * 128, 16, 1024));
          const uint64_t qd = opaque(smem_desc(sQ(s), 16, 1024));
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t box = (kk >> 2) * 128, in = (kk & 3) * 32;  // bytes; >> 4 below
            Wg<T>::template ss<BM>(st, kd + ((box * kBN + in) >> 4), qd + ((box * BM + in) >> 4),
                                   kk > 0);
          }
          const uint64_t vd = opaque(smem_desc(sV + c * 64 * 128, 16, 1024));
          const uint64_t od = opaque(smem_desc(sdO(s), 16, 1024));
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t box = (kk >> 2) * 128, in = (kk & 3) * 32;
            Wg<T>::template ss<BM>(dpt, vd + ((box * kBN + in) >> 4), od + ((box * BM + in) >> 4),
                                   kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait0();
        pin(st);
        pin(dpt);

        // P^T and dS^T in place: rows are keys, columns query rows m0 + 8jj + 2tq + e
        const bool need_mask = p.softcap != 0.f || k_lo + 64 > p.Skv ||
                               (p.causal && m0 + offset < k_lo + 63) ||
                               (p.window > 0 && m0 + BM - 1 + offset - k_lo >= p.window);
        if (need_mask) {
#pragma unroll
          for (int jj = 0; jj < BM / 8; ++jj) {
            const float2 l2 = lds64(sLD(s) + (jj * 8 + tq * 2) * 4);
            const float2 dd = lds64(sLD(s) + BM * 4 + (jj * 8 + tq * 2) * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = key0 + 8 * (e >> 1);
              const int qpos = m0 + jj * 8 + tq * 2 + (e & 1) + offset;
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
          for (int jj = 0; jj < BM / 8; ++jj) {
            const float2 l2 = lds64(sLD(s) + (jj * 8 + tq * 2) * 4);
            const float2 dd = lds64(sLD(s) + BM * 4 + (jj * 8 + tq * 2) * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pe = ex2(fmaf(st[4 * jj + e], sl2, -((e & 1) ? l2.y : l2.x)));
              st[4 * jj + e] = pe;
              dpt[4 * jj + e] = pe * (dpt[4 * jj + e] - ((e & 1) ? dd.y : dd.x));
            }
          }
        }
        // the accumulators of query columns [16kk, 16kk + 16) are, register for
        // register, the A fragment of one k16 step
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pa[kk][e] = Wg<T>::pack(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
            da[kk][e] = Wg<T>::pack(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
          }
        // dS^T to shared memory: key rows, 64 query columns (128 bytes) a box, 128-byte
        // swizzle; this thread's rows are 64c + 16warp + g (+ 8).  Buffer u was last
        // read by step it - 2's dQ products, which both warpgroups waited for before
        // they arrived on ds_full for step it - 1, which this warpgroup waited for.
#pragma unroll
        for (int jj = 0; jj < BM / 8; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = c * 64 + warp * 16 + g + 8 * r;
            sts32(sDS(u) + (jj >> 3) * (kBN * 128) + row * 128 + (((jj & 7) ^ g) << 4) + tq * 4,
                  da[jj >> 1][(jj & 1) * 2 + r]);
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_if(ds_full(u), true);

        // dV += P^T dO and dK += dS^T Q: dO and Q are MN-major B operands (16 query
        // rows are two 8-row groups, SBO 1024; the next 64 columns the next box, LBO)
        wgmma_fence();
        {
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

        // dQ = dS K once both warpgroups' dS^T is in shared memory: A = dS read
        // transposed (MN-major), B = K MN-major, k16 steps over the tile's 128 keys
        mbar_wait(ds_full(u), (it >> 1) & 1);
        wgmma_fence();
        {
          const uint64_t ad =
              opaque(smem_desc(sDS(u) + (kDqRowStep ? c : 0) * (kBN * 128), kBN * 128, 1024));
          const uint64_t bd =
              opaque(smem_desc(sK + (kDqColStep ? c : 0) * (kBN * 128), kBN * 128, 1024));
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk)
            Wg<T>::template ss<64, 1, 1>(dq, ad + ((kk * 16 * 128) >> 4),
                                         bd + ((kk * 16 * 128) >> 4), kk > 0);
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
        // each 64 x 64 block in the same order
        const int b = it % kDqBufs;
        mbar_wait(dq_empty(c, b), ((it / kDqBufs) & 1) ^ 1);  // the first kDqBufs pass
#pragma unroll
        for (int k = 0; k < 8; ++k)
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(sDQ(c, b) + (k * 128 + t) * 16),
                       "f"(dq[4 * k]), "f"(dq[4 * k + 1]), "f"(dq[4 * k + 2]), "f"(dq[4 * k + 3])
                       : "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_if(dq_full(c, b), true);
      }
      mbar_arrive_if(kv_empty, lane == 0);  // K and V are read: the next tile's may land

      // the epilogue runs while the producer already loads the next work tile
      T* dkg = static_cast<T*>(p.dk) + tw.b * p.dk_sb + tw.kvh * p.dk_sh;
      T* dvg = static_cast<T*>(p.dv) + tw.b * p.dv_sb + tw.kvh * p.dv_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key < p.Skv) {
          T* krow = dkg + (long long)key * p.dk_ss + tq * 2;
          T* vrow = dvg + (long long)key * p.dv_ss + tq * 2;
#pragma unroll
          for (int jj = 0; jj < HD / 8; ++jj) {
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

template <typename T, int HD>
int launch(const BwdParams& p, CUtensorMapDataType type, cudaStream_t st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -4;
  constexpr int BM = Cfg<HD>::BM;
  // every map is encoded before anything is launched: a refusal touches nothing
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(fn, &tq, p.q, type, HD, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, BM) ||
      !encode(fn, &tdo, p.dout, type, HD, p.Sq, p.H, p.B, p.do_ss, p.do_sh, p.do_sb, BM) ||
      !encode(fn, &tk, p.k, type, HD, p.Skv, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, kBN) ||
      !encode(fn, &tv, p.v, type, HD, p.Skv, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, kBN))
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
  kern<<<blocks, kThreads, smem, st>>>(tq, tk, tv, tdo, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long packs = (long long)p.B * p.H * p.Sq * (HD / 8);
  flash_bwd_sm90_dq_kernel<T, HD><<<(unsigned)((packs + 255) / 256), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_bwd_sm90(const BwdParams& p, int hd, int dtype, cudaStream_t st) {
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
