// Chunked SSD (Mamba2's scan) for Hopper (sm_90a), forward and backward, plain C
// interface.
//
// Replaces no TPU kernel: it stands for src/repro/models/layers.py (_mamba_scan), the
// JAX package's SSD, plain JAX that XLA fuses.  Its port (models/layers.py,
// _ssd_chunked_groups) runs as PyTorch elementwise passes and float32 einsums over
// (B, n, c, c, heads) decay ratios, recomputed in the backward: on an H100 some
// 400 ms of zamba2-7b's ~807 ms training step (18 Mamba2 layers, 2 x 4096 tokens,
// 112 heads of 64 in 2 groups, d_state 64).  It is added because the scan is that
// step's bottleneck.  Here the same algebra (kernels/ssd.py writes it out, with the
// plain versions the tests hold to autograd) runs as three kernels forward and six
// backward, and no (chunk x chunk x heads) tensor reaches device memory:
//   repro_ssd_chunk_state  per (batch, chunk, tile of kHeadTile heads of a group):
//       the running log decay logP along the chunk (a warp scan) and each head's
//       contribution to the state leaving the chunk, sum_t exp(logP_last - logP_t)
//       u_t (x) B_t (hd x N, u = dt x); in the backward also the chunk's pull on the
//       state entering it, sum_t exp(logP_t) dy_t (x) C_t;
//   repro_ssd_state_pass   a thread per state entry: the states passed over the n
//       chunks in order (forward: the state entering each chunk, in place, and the
//       final one) or in reverse (backward: the gradient of the state leaving each
//       chunk, and dh0), with each chunk's total decay exp(logP_last) as
//       repro_ssd_chunk_state wrote it; eight chunks' loads in flight at a time;
//   repro_ssd_chunk_out    per (batch, chunk, head tile): C B^T once for the tile's
//       group, then for each head the causal decay applied in shared memory and
//       y = (C B^T o decay) u + exp(logP) C h_in^T + D x, rounded to x's type as the
//       plain form rounds it (its sum, then D x, then their sum);
//   repro_ssd_chunk_grad   per (batch, chunk, head tile): dx, ddt, and per head the
//       score gradients dS summed over the tile in registers, so that dB and dC take
//       one product each with the group's C and B per tile; the state parts of dB and
//       dC per head; per-(batch, chunk, head) partials of dA_log and dD;
//   repro_ssd_group_sum    dB and dC: the head tiles' float32 partials added in a
//       fixed order, in the inputs' type;
//   repro_ssd_head_sums    dA_log and dD: the per-(batch, chunk) partials added in a
//       fixed order (a second pass, no atomics: two calls give the same bits).
//
// Precision: every product runs on the tensor cores as mma.sync.m16n8k8 in 3xTF32:
// each float32 operand split into a TF32 high part and the TF32 of the rest, three
// products accumulated in float32 (the low-by-low one is below float32's rounding),
// the scheme of flash_attention_fp32.cu.  So no operand is rounded below the type the
// plain form holds it in (x, B, C and dy are read in their own type and widened; u, the
// scores, the decays and the states are float32), and sums that run over heads or
// products (dS over a tile, dB and dC) are added with ordinary float adds between
// products.  Every decay is expf of a non-positive number.
//
// Bound on this card: operations.  At zamba2-7b's cell (2 x 4096 tokens, 112 heads of
// 64, d_state 64, 18 layers) the products this decomposition needs (the causal
// halves once) are ~1.3 MFLOP a (chunk, head) forward and ~3.2 M backward with its
// recompute: ~1.15e12 a step, 7.0 ms at the 165 TFLOP/s of float32-accurate work on
// the TF32 tensor cores (the source's chunk of 256 would be ~2.5e12, ~15 ms).  Bytes
// are small: x, B, C, dt read and y written once forward, ~0.7 GB a layer with the
// backward, 3.8 ms a step at 3.35 TB/s.  What the design does:
//   * the chunk is 64 (kChunk): the intra-chunk work grows with the chunk, the state
//     work does not, and a block's tiles of a chunk fit shared memory at d_state 128;
//   * a product's 16 x 8 output tiles are shared among the block's eight warps, a
//     warp's tiles in one row of tiles so that its A fragment serves them all;
//     operands come from shared memory whose rows are padded by 4 floats, so that a
//     fragment's loads fall on distinct banks (two ways at most when read across);
//   * the causal products (the masked W u, W^T dy, dS^T C, dS B) skip the k steps the
//     mask zeroes for the warp's rows;
//   * a block's global loads between two barriers are issued together, as raw bits,
//     and converted after (stage, ld_bits, widen): a block holds few warps, so
//     loads that each waited on the last would cost a memory latency apiece;
//   * the per-row sums the backward needs (g by rows and by columns, q, the cross
//     term, du . x) are reduced in registers and across lanes, by warp, and added by
//     warp 0;
//   * the heads of a block share their group's C B^T and, in the backward, the sum of
//     their score gradients (one c x c product per tile for dB and one for dC);
//   * the chunk states are recomputed in the backward, not saved: the Function keeps
//     its inputs only, as the checkpoint it replaces did.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "rmsnorm.cuh"

using rmsnorm::DeviceGuard;
using rmsnorm::warp_sum;

namespace {

constexpr int kChunk = 64;      // a chunk's tokens inside the kernels
constexpr int kHeadTile = 8;    // the heads of one group a block takes
constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kPassUnroll = 8;  // chunks whose loads the state pass keeps in flight
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunk == 64, "the log-decay scan takes two tokens a lane");

// The kernels' arguments (from SsdCall, with what follows from it).
struct SsdArgs {
  const void* x;
  const void* B;
  const void* C;
  const void* dt;
  const void* A_log;
  const void* D;
  const void* dy;
  void* y;
  void* dx;
  void* ddt;
  float* states;
  float* dstates;
  float* decay;
  float* part_bc;
  float* part_head;
  int batch, seqlen, heads, n, per, tiles;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss, dy_sb, dy_ss;
  int xt, dtt, at, dtyp;   // type codes: x (B, C, dy, y, dx, dB, dC), dt, A_log, D
};

// ------------------------------------------------------------------ elements

__device__ __forceinline__ float ld(const void* p, long long i, int code) {
  switch (code) {
    case 0: return static_cast<const float*>(p)[i];
    case 1: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    default: return __half2float(static_cast<const __half*>(p)[i]);
  }
}

// The bits of element i, and their value: a tile's loads are issued first, their
// conversions after, so that no load waits on another's arrival (a conversion right
// after each load would).
__device__ __forceinline__ uint32_t ld_bits(const void* p, long long i, int code) {
  switch (code) {
    case 0: return __float_as_uint(static_cast<const float*>(p)[i]);
    default: return static_cast<const unsigned short*>(p)[i];
  }
}

__device__ __forceinline__ float widen(uint32_t bits, int code) {
  switch (code) {
    case 0: return __uint_as_float(bits);
    case 1: return __uint_as_float(bits << 16);
    default: return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
  }
}

__device__ __forceinline__ void st(void* p, long long i, int code, float v) {
  switch (code) {
    case 0: static_cast<float*>(p)[i] = v; break;
    case 1: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v); break;
    default: static_cast<__half*>(p)[i] = __float2half_rn(v); break;
  }
}

// v rounded to the type of `code` and widened again
__device__ __forceinline__ float rnd(float v, int code) {
  switch (code) {
    case 0: return v;
    case 1: return __bfloat162float(__float2bfloat16_rn(v));
    default: return __half2float(__float2half_rn(v));
  }
}

// ------------------------------------------------------------------ products

// Every product is mma.sync.m16n8k8 on TF32 with each operand split in two,
// a = hi + lo with hi = a & 0xFFFFE000 (the top 19 bits) and lo = a - hi, and
// a * b ~ lo * b_hi + hi * b_lo + hi * b_hi accumulated in float32 (lo * lo is below
// float32's rounding): float32's accuracy on the tensor cores, 495 / 3 = 165 TFLOP/s.
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kTf32Mask = 0xFFFFE000u;

// Shared-memory rows are padded by 4 floats: a fragment's eight rows (stride = 4 mod
// 32 banks) and four columns then fall on 32 distinct banks read along the row, and
// on at most two ways read across it.
__host__ __device__ constexpr int pad(int n) { return n + 4; }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An M x NN product's accumulators, the 16 x 8 output tiles shared among the block's
// warps: warp w takes row tile w % WM (WM = M / 16) and every WPR-th column tile from
// w / WM (WPR = the warps that share a row tile).  In a tile the thread holds
// c[j][0..1] at row g, columns 2t, 2t + 1 and c[j][2..3] at row g + 8 (g = lane / 4,
// t = lane % 4), as the mma's C fragment.
template <int M, int NN>
struct Acc {
  static constexpr int WM = M / 16, WPR = kWarps / WM, CT = NN / 8;
  static constexpr int CTW = (CT + WPR - 1) / WPR;
  static_assert(M % 16 == 0 && NN % 8 == 0 && WM <= kWarps && kWarps % WM == 0, "tiles");
  float c[CTW][4];
  int r0, n0, g, t;

  __device__ __forceinline__ Acc() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    r0 = 16 * (warp % WM);
    n0 = 8 * (warp / WM);
    zero();
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < CTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  }
  // column tile j is the warp's (uniform across the warp)
  __device__ __forceinline__ bool has(int j) const { return n0 / 8 + WPR * j < CT; }
  __device__ __forceinline__ int row(int e) const { return r0 + g + 8 * (e >> 1); }
  __device__ __forceinline__ int col(int j, int e) const {
    return n0 + 8 * WPR * j + 2 * t + (e & 1);
  }
  // the warp's share of a row sum: v summed over the thread's elements of each of its
  // two rows, then over the four lanes of a row; lanes t == 0 write their rows'
  // sums to part[w][row] (w = which of the WPR warps of the row tile)
  __device__ __forceinline__ void row_part(float v0, float v1, float* part) const {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      v0 += __shfl_xor_sync(kFull, v0, o);
      v1 += __shfl_xor_sync(kFull, v1, o);
    }
    if (t == 0) {
      float* p = part + (n0 / 8) * M;
      p[r0 + g] = v0;
      p[r0 + g + 8] = v1;
    }
  }
  // the warp's share of column sums: v[j][k], the thread's two elements of column
  // col(j, k), summed over the eight rows of lanes; lanes g == 0 write the sums to
  // part[w][col] (w = the row tile, one of WM)
  __device__ __forceinline__ void col_part(float (&v)[CTW][2], float* part) const {
#pragma unroll
    for (int j = 0; j < CTW; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v[j][k] += __shfl_xor_sync(kFull, v[j][k], o);
    if (g == 0)
#pragma unroll
      for (int j = 0; j < CTW; ++j)
        if (has(j))
#pragma unroll
          for (int k = 0; k < 2; ++k) part[(r0 / 16) * NN + col(j, k)] = v[j][k];
  }
};

// d += A B over k in [k_lo, k_hi) (multiples of 8 up to K), with A(r, k) =
// a[r * ars + k * acs] and B(k, n) = b[k * brs + n * bcs] in shared memory (a
// transpose is a swap of strides).
template <int M, int NN>
__device__ __forceinline__ void mma(Acc<M, NN>& d, const float* a, int ars, int acs,
                                    const float* b, int brs, int bcs, int k_lo, int k_hi) {
  const int ra = d.r0 + d.g;
#pragma unroll 2
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    uint32_t ah[4], al[4];
    split(a[ra * ars + (k0 + d.t) * acs], ah[0], al[0]);
    split(a[(ra + 8) * ars + (k0 + d.t) * acs], ah[1], al[1]);
    split(a[ra * ars + (k0 + d.t + 4) * acs], ah[2], al[2]);
    split(a[(ra + 8) * ars + (k0 + d.t + 4) * acs], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < Acc<M, NN>::CTW; ++j) {
      if (!d.has(j)) continue;
      const int n = d.n0 + 8 * Acc<M, NN>::WPR * j + d.g;
      uint32_t h0, l0, h1, l1;
      split(b[(k0 + d.t) * brs + n * bcs], h0, l0);
      split(b[(k0 + d.t + 4) * brs + n * bcs], h1, l1);
      mma_tf32(d.c[j], al, h0, h1);
      mma_tf32(d.c[j], ah, l0, l1);
      mma_tf32(d.c[j], ah, h0, h1);
    }
  }
}

// ------------------------------------------------------------------ per chunk

// Warp 0: dt of head h over the chunk into dtv, and logP (the running sum of A dt)
// into lp, two tokens a lane.
__device__ __forceinline__ void log_decay(const SsdArgs& a, float* lp, float* dtv, int b,
                                          long long t0, int h, int lane) {
  const float A = -expf(ld(a.A_log, h, a.at));
  const long long base = b * a.dt_sb + (t0 + 2 * lane) * a.dt_ss + h;
  const float d0 = ld(a.dt, base, a.dtt), d1 = ld(a.dt, base + a.dt_ss, a.dtt);
  const float a0 = A * d0, a1 = A * d1;
  float incl = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  dtv[2 * lane] = d0;
  dtv[2 * lane + 1] = d1;
  lp[2 * lane] = excl + a0;
  lp[2 * lane + 1] = excl + a0 + a1;
}

struct Tile {
  int g, i, b, h_lo, h_hi;
  long long t0;
};

__device__ __forceinline__ Tile tile_of(const SsdArgs& a) {
  Tile t;
  t.g = blockIdx.x / a.tiles;
  t.i = blockIdx.y;
  t.b = blockIdx.z;
  t.h_lo = t.g * a.per + (blockIdx.x % a.tiles) * kHeadTile;
  t.h_hi = min(t.h_lo + kHeadTile, (t.g + 1) * a.per);
  t.t0 = (long long)t.i * kChunk;
  return t;
}

// Two tiles staged into shared memory together: every global load of a thread issued
// before its first store, so that their latencies overlap instead of adding up (a
// block has eight warps, and its loads run between two barriers).  get(e) reads the
// bits of element e (ld_bits), put(e, bits) converts and stores them.  When the tiles
// are one size, returns the sum over the thread's elements of their product (both
// float32).
template <int COUNT1, int COUNT2, typename G1, typename P1, typename G2, typename P2>
__device__ __forceinline__ float stage(G1 get1, P1 put1, G2 get2, P2 put2) {
  constexpr int U1 = (COUNT1 + kThreads - 1) / kThreads, U2 = (COUNT2 + kThreads - 1) / kThreads;
  uint32_t v1[U1 > 0 ? U1 : 1], v2[U2 > 0 ? U2 : 1];
#pragma unroll
  for (int u = 0; u < U1; ++u) {
    const int e = threadIdx.x + u * kThreads;
    v1[u] = e < COUNT1 ? get1(e) : 0u;
  }
#pragma unroll
  for (int u = 0; u < U2; ++u) {
    const int e = threadIdx.x + u * kThreads;
    v2[u] = e < COUNT2 ? get2(e) : 0u;
  }
  float dot = 0.f;
#pragma unroll
  for (int u = 0; u < U1; ++u) {
    const int e = threadIdx.x + u * kThreads;
    if (e < COUNT1) put1(e, v1[u]);
  }
#pragma unroll
  for (int u = 0; u < U2; ++u) {
    const int e = threadIdx.x + u * kThreads;
    if (e < COUNT2) put2(e, v2[u]);
    if constexpr (COUNT1 == COUNT2)
      dot = fmaf(__uint_as_float(v1[u]), __uint_as_float(v2[u]), dot);
  }
  return dot;
}

// element e of the chunk's rows of a group's B or C (row strides sb, ss)
template <int N>
__device__ __forceinline__ auto group_rows(const void* src, long long sb, long long ss,
                                           const Tile& tl, int code) {
  const long long base = tl.b * sb + tl.t0 * ss + (long long)tl.g * N;
  return [=](int e) { return ld_bits(src, base + (e / N) * ss + e % N, code); };
}

// element e of the chunk's rows of head h of x or dy
template <int HD>
__device__ __forceinline__ auto head_rows(const void* src, long long sb, long long ss,
                                          const Tile& tl, int h, int code) {
  const long long base = tl.b * sb + tl.t0 * ss + (long long)h * HD;
  return [=](int e) { return ld_bits(src, base + (e / HD) * ss + e % HD, code); };
}

// element e of a row-major tile of rows of COLS (bits of type `code`) into padded
// rows, scaled by the row's factor when one is given
template <int COLS>
__device__ __forceinline__ auto into_rows(float* dst, int code, const float* scale = nullptr) {
  return [=](int e, uint32_t bits) {
    const float v = widen(bits, code);
    dst[(e / COLS) * pad(COLS) + e % COLS] = scale ? scale[e / COLS] * v : v;
  };
}

// a head's float32 hd x N state: the bits of element e, and element e into its
// transpose, rows of k, padded
__device__ __forceinline__ auto state_bits(const float* src) {
  return [=](int e) { return __float_as_uint(src[e]); };
}

template <int HD, int N>
__device__ __forceinline__ auto into_state_t(float* dst) {
  return [=](int e, uint32_t bits) { dst[(e % N) * pad(HD) + e / N] = __uint_as_float(bits); };
}

template <int HD, int N>
__device__ __forceinline__ long long state_at(const SsdArgs& a, const Tile& tl, int h) {
  return (((long long)tl.b * a.n + tl.i) * a.heads + h) * (HD * N);
}

// (a): each head's contribution to the state leaving the chunk (and, kGrad, the
// chunk's pull on the state entering it); the chunk's total decay exp(logP_last) in
// `decay`.
template <int HD, int N, bool kGrad>
__global__ void __launch_bounds__(kThreads, 2) repro_ssd_chunk_state(const SsdArgs a) {
  constexpr int NP = pad(N), HP = pad(HD);
  extern __shared__ float sm[];
  float* Bs = sm;                                       // kChunk x NP
  float* Cs = Bs + kChunk * NP;                         // kChunk x NP (kGrad)
  float* us = Cs + (kGrad ? kChunk * NP : 0);           // kChunk x HP: es_t u_t
  float* ds = us + kChunk * HP;                         // kChunk x HP: exp(logP_t) dy_t
  float* lp = ds + (kGrad ? kChunk * HP : 0);           // kChunk
  float* dtv = lp + kChunk;                             // kChunk
  float* fu = dtv + kChunk;                             // kChunk: es_t dt_t
  float* fy = fu + kChunk;                              // kChunk: exp(logP_t)
  const int tid = threadIdx.x;
  const Tile tl = tile_of(a);
  if constexpr (kGrad)
    stage<kChunk * N, kChunk * N>(group_rows<N>(a.B, a.b_sb, a.b_ss, tl, a.xt), into_rows<N>(Bs, a.xt),
                                  group_rows<N>(a.C, a.c_sb, a.c_ss, tl, a.xt), into_rows<N>(Cs, a.xt));
  else
    stage<kChunk * N, 0>(group_rows<N>(a.B, a.b_sb, a.b_ss, tl, a.xt), into_rows<N>(Bs, a.xt),
                         [](int) { return 0u; }, [](int, uint32_t) {});
  for (int h = tl.h_lo; h < tl.h_hi; ++h) {
    if (tid < 32) {
      log_decay(a, lp, dtv, tl.b, tl.t0, h, tid);
      __syncwarp();
      for (int t = tid; t < kChunk; t += 32) {
        fu[t] = expf(lp[kChunk - 1] - lp[t]) * dtv[t];
        fy[t] = expf(lp[t]);
      }
    }
    __syncthreads();
    if constexpr (kGrad)
      stage<kChunk * HD, kChunk * HD>(
          head_rows<HD>(a.x, a.x_sb, a.x_ss, tl, h, a.xt), into_rows<HD>(us, a.xt, fu),
          head_rows<HD>(a.dy, a.dy_sb, a.dy_ss, tl, h, a.xt), into_rows<HD>(ds, a.xt, fy));
    else
      stage<kChunk * HD, 0>(head_rows<HD>(a.x, a.x_sb, a.x_ss, tl, h, a.xt),
                            into_rows<HD>(us, a.xt, fu), [](int) { return 0u; }, [](int, uint32_t) {});
    __syncthreads();
    const long long at = state_at<HD, N>(a, tl, h);
    Acc<HD, N> acc;
    mma(acc, us, 1, HP, Bs, NP, 1, 0, kChunk);                 // (p, k) over t
#pragma unroll
    for (int j = 0; j < acc.CTW; ++j)
      if (acc.has(j))
#pragma unroll
        for (int e = 0; e < 4; ++e) a.states[at + acc.row(e) * N + acc.col(j, e)] = acc.c[j][e];
    if (kGrad) {
      acc.zero();
      mma(acc, ds, 1, HP, Cs, NP, 1, 0, kChunk);
#pragma unroll
      for (int j = 0; j < acc.CTW; ++j)
        if (acc.has(j))
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a.dstates[at + acc.row(e) * N + acc.col(j, e)] = acc.c[j][e];
    }
    if (tid == 0) a.decay[((long long)tl.b * a.n + tl.i) * a.heads + h] = expf(lp[kChunk - 1]);
    __syncthreads();
  }
}

// (b): s' = decay_i s + buf_i over the chunks, buf_i replaced by s (the state
// entering chunk i; in reverse the gradient of the state leaving it); the last s to
// `last_out` when given.  One thread per (batch, head, state entry), walking its
// column of the chunks with one pointer each for buf and decay; kPassUnroll chunks'
// loads in flight at a time, few registers, so that many threads an SM hide them.
__global__ void __launch_bounds__(kThreads, 6)
    repro_ssd_state_pass(float* buf, const float* decay, const float* first, float* last_out,
                         int batch, int heads, int n, int hdn, int reverse) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)batch * heads * hdn) return;
  const long long bh = e / hdn, b = bh / heads;
  const int h = (int)(bh % heads);
  const long long step = reverse ? -(long long)heads : heads;   // one chunk in decay
  const float* dp = decay + b * n * heads + h + (reverse ? (long long)(n - 1) * heads : 0);
  float* bp = buf + (b * n * heads + h) * hdn + e % hdn +
              (reverse ? (long long)(n - 1) * heads * hdn : 0);
  float s = first ? first[e] : 0.f;
  for (int j0 = 0; j0 < n; j0 += kPassUnroll) {
    float part[kPassUnroll], dec[kPassUnroll];
#pragma unroll
    for (int q = 0; q < kPassUnroll; ++q)
      if (j0 + q < n) {
        part[q] = bp[q * step * hdn];
        dec[q] = dp[q * step];
      }
#pragma unroll
    for (int q = 0; q < kPassUnroll; ++q)
      if (j0 + q < n) {
        bp[q * step * hdn] = s;
        s = fmaf(dec[q], s, part[q]);
      }
    bp += kPassUnroll * step * hdn;
    dp += kPassUnroll * step;
  }
  if (last_out) last_out[e] = s;
}

// C B^T of the tile's group into CB (kChunk x CP), from Cs and Bs
template <int N>
__device__ __forceinline__ void scores(float* CB, const float* Cs, const float* Bs) {
  constexpr int NP = pad(N), CP = pad(kChunk);
  Acc<kChunk, kChunk> acc;
  mma(acc, Cs, NP, 1, Bs, 1, NP, 0, N);                       // (t, s) over k
#pragma unroll
  for (int j = 0; j < acc.CTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) CB[acc.row(e) * CP + acc.col(j, e)] = acc.c[j][e];
}

// W[t][s] = CB[t][s] exp(logP_t - logP_s) for s <= t, else 0
__device__ __forceinline__ void decay_weights(float* W, const float* CB, const float* lp) {
  constexpr int CP = pad(kChunk);
  for (int e = threadIdx.x; e < kChunk * kChunk; e += kThreads) {
    const int t = e / kChunk, s = e % kChunk;
    W[t * CP + s] = s <= t ? CB[t * CP + s] * expf(lp[t] - lp[s]) : 0.f;
  }
}

// (c): y for each head of the tile.
template <int HD, int N>
__global__ void __launch_bounds__(kThreads, 2) repro_ssd_chunk_out(const SsdArgs a) {
  constexpr int NP = pad(N), HP = pad(HD), CP = pad(kChunk);
  extern __shared__ float sm[];
  float* Cs = sm;                      // kChunk x NP
  float* Bs = Cs + kChunk * NP;        // kChunk x NP
  float* CB = Bs + kChunk * NP;        // kChunk x CP
  float* W = CB + kChunk * CP;         // kChunk x CP
  float* us = W + kChunk * CP;         // kChunk x HP: u = dt x
  float* hT = us + kChunk * HP;        // N x HP: the incoming state, transposed
  float* lp = hT + N * HP;             // kChunk
  float* dtv = lp + kChunk;            // kChunk
  const int tid = threadIdx.x;
  const Tile tl = tile_of(a);
  stage<kChunk * N, kChunk * N>(group_rows<N>(a.C, a.c_sb, a.c_ss, tl, a.xt), into_rows<N>(Cs, a.xt),
                                group_rows<N>(a.B, a.b_sb, a.b_ss, tl, a.xt), into_rows<N>(Bs, a.xt));
  __syncthreads();
  scores<N>(CB, Cs, Bs);
  for (int h = tl.h_lo; h < tl.h_hi; ++h) {
    if (tid < 32) log_decay(a, lp, dtv, tl.b, tl.t0, h, tid);
    __syncthreads();
    const float* hin = a.states + state_at<HD, N>(a, tl, h);
    stage<kChunk * HD, HD * N>(head_rows<HD>(a.x, a.x_sb, a.x_ss, tl, h, a.xt),
                               into_rows<HD>(us, a.xt, dtv), state_bits(hin),
                               into_state_t<HD, N>(hT));
    decay_weights(W, CB, lp);
    __syncthreads();
    Acc<kChunk, HD> acc;
    mma(acc, Cs, NP, 1, hT, HP, 1, 0, N);                       // C_t . h_in[p]
    const float el[2] = {expf(lp[acc.row(0)]), expf(lp[acc.row(2)])};
#pragma unroll
    for (int j = 0; j < acc.CTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.c[j][e] *= el[e >> 1];
    mma(acc, W, CP, 1, us, HP, 1, 0, acc.r0 + 16);              // + sum_{s <= t} W_ts u_s
    const float Dh = ld(a.D, h, a.dtyp);
    const long long xh = tl.b * a.x_sb + (long long)h * HD;
    uint32_t xb[Acc<kChunk, HD>::CTW][4];   // x at the thread's outputs, all loads first
#pragma unroll
    for (int j = 0; j < acc.CTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xb[j][e] = acc.has(j) ? ld_bits(a.x, xh + (tl.t0 + acc.row(e)) * a.x_ss + acc.col(j, e),
                                        a.xt)
                              : 0u;
#pragma unroll
    for (int j = 0; j < acc.CTW; ++j)
      if (acc.has(j))
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long row = tl.t0 + acc.row(e);
          const int p = acc.col(j, e);
          const float xv = widen(xb[j][e], a.xt);
          const float v = a.xt == 0 ? acc.c[j][e] + Dh * xv
                                    : rnd(acc.c[j][e], a.xt) + rnd(Dh * xv, a.xt);
          st(a.y, (((long long)tl.b * a.seqlen + row) * a.heads + h) * HD + p, a.xt, v);
        }
    __syncthreads();
  }
}

// The backward of one chunk for each head of the tile (kernels/ssd.py, ssd_bwd_plain,
// states the formulas).  `states` holds the state entering each chunk, `dstates` the
// gradient of the state leaving it.
template <int HD, int N>
__global__ void __launch_bounds__(kThreads) repro_ssd_chunk_grad(const SsdArgs a) {
  constexpr int NP = pad(N), HP = pad(HD), CP = pad(kChunk);
  constexpr int kRowParts = Acc<kChunk, HD>::WPR;   // warps sharing a row of chunk rows
  constexpr int kColParts = Acc<kChunk, kChunk>::WM;  // row tiles of a chunk x chunk tile
  static_assert(Acc<kChunk, N>::WPR == kRowParts && Acc<kChunk, kChunk>::WPR == kRowParts,
                "one split of the chunk's rows");
  extern __shared__ float sm[];
  float* Cs = sm;                      // kChunk x NP
  float* Bs = Cs + kChunk * NP;        // kChunk x NP
  float* CB = Bs + kChunk * NP;        // kChunk x CP
  float* W = CB + kChunk * CP;         // kChunk x CP
  float* Gm = W + kChunk * CP;         // kChunk x CP: at the end the tile's dS
  float* us = Gm + kChunk * CP;        // kChunk x HP: u = dt x
  float* dys = us + kChunk * HP;       // kChunk x HP: dy
  float* hT = dys + kChunk * HP;       // N x HP: the incoming state, transposed
  float* dhT = hT + N * HP;            // N x HP: the outgoing state's gradient, transposed
  float* lp = dhT + N * HP;            // kChunk each:
  float* dtv = lp + kChunk;
  float* rs = dtv + kChunk;            //   sum_s g_ts, by row part
  float* cs = rs + kRowParts * kChunk; //   sum_t g_ts, by column part
  float* qv = cs + kColParts * kChunk; //   es_t u_t . (dh_out B_t), by row part
  float* cr = qv + kRowParts * kChunk; //   exp(logP_t) dy_t . (h_in C_t), by row part
  float* dux = cr + kRowParts * kChunk;  // du_t . x_t, by row part
  float* red = dux + kRowParts * kChunk; // 2 x kWarps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile tl = tile_of(a);
  stage<kChunk * N, kChunk * N>(group_rows<N>(a.C, a.c_sb, a.c_ss, tl, a.xt), into_rows<N>(Cs, a.xt),
                                group_rows<N>(a.B, a.b_sb, a.b_ss, tl, a.xt), into_rows<N>(Bs, a.xt));
  __syncthreads();
  scores<N>(CB, Cs, Bs);
  Acc<kChunk, kChunk> dS;
  Acc<kChunk, N> dB, dC;
  for (int h = tl.h_lo; h < tl.h_hi; ++h) {
    if (tid < 32) log_decay(a, lp, dtv, tl.b, tl.t0, h, tid);
    __syncthreads();
    stage<kChunk * HD, kChunk * HD>(
        head_rows<HD>(a.x, a.x_sb, a.x_ss, tl, h, a.xt), into_rows<HD>(us, a.xt, dtv),
        head_rows<HD>(a.dy, a.dy_sb, a.dy_ss, tl, h, a.xt), into_rows<HD>(dys, a.xt));
    const float* hin = a.states + state_at<HD, N>(a, tl, h);
    const float* dhout = a.dstates + state_at<HD, N>(a, tl, h);
    float hdot = stage<HD * N, HD * N>(state_bits(hin), into_state_t<HD, N>(hT),
                                       state_bits(dhout), into_state_t<HD, N>(dhT));
    decay_weights(W, CB, lp);
    __syncthreads();
    const float last = lp[kChunk - 1];

    // dW = dy u^T: the scores' gradient dS = dW L, summed over the tile's heads, and
    // g = dW W for the log decays, summed by rows and by columns
    {
      Acc<kChunk, kChunk> acc;
      mma(acc, dys, HP, 1, us, 1, HP, 0, HD);                  // (t, s) over p
      float grow[2] = {0.f, 0.f}, gcol[Acc<kChunk, kChunk>::CTW][2];
#pragma unroll
      for (int j = 0; j < acc.CTW; ++j) {
        gcol[j][0] = gcol[j][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = acc.row(e), s = acc.col(j, e);
          if (s <= t) {
            dS.c[j][e] = fmaf(acc.c[j][e], expf(lp[t] - lp[s]), dS.c[j][e]);
            const float gts = acc.c[j][e] * W[t * CP + s];
            grow[e >> 1] += gts;
            gcol[j][e & 1] += gts;
          }
        }
      }
      acc.row_part(grow[0], grow[1], rs);
      acc.col_part(gcol, cs);
    }

    // du = es dh_out B^T (whose dot with u is q) + W^T dy; dx = dt du + D dy
    {
      Acc<kChunk, HD> du;
      const long long xh = tl.b * a.x_sb + (long long)h * HD;
      uint32_t xb[Acc<kChunk, HD>::CTW][4];  // x at the thread's outputs, read ahead
#pragma unroll
      for (int j = 0; j < du.CTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xb[j][e] = du.has(j) ? ld_bits(a.x, xh + (tl.t0 + du.row(e)) * a.x_ss + du.col(j, e),
                                         a.xt)
                               : 0u;
      mma(du, Bs, NP, 1, dhT, HP, 1, 0, N);                     // (t, p) over k
      const float es[2] = {expf(last - lp[du.row(0)]), expf(last - lp[du.row(2)])};
      float q[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < du.CTW; ++j)
        if (du.has(j))
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            du.c[j][e] *= es[e >> 1];
            q[e >> 1] = fmaf(us[du.row(e) * HP + du.col(j, e)], du.c[j][e], q[e >> 1]);
          }
      du.row_part(q[0], q[1], qv);
      mma(du, W, 1, CP, dys, HP, 1, du.r0 & ~7, kChunk);        // (s, p) over t >= s
      const float Dh = ld(a.D, h, a.dtyp);
      float dD = 0.f, dxx[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < du.CTW; ++j)
        if (du.has(j))
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = du.row(e), p = du.col(j, e);
            const long long row = tl.t0 + t;
            const float xv = widen(xb[j][e], a.xt), dyv = dys[t * HP + p];
            st(a.dx, (((long long)tl.b * a.seqlen + row) * a.heads + h) * HD + p, a.xt,
               fmaf(dtv[t], du.c[j][e], Dh * dyv));
            dxx[e >> 1] = fmaf(du.c[j][e], xv, dxx[e >> 1]);
            dD = fmaf(dyv, xv, dD);
          }
      du.row_part(dxx[0], dxx[1], dux);
      dD = warp_sum(dD);
      hdot = warp_sum(hdot);
      if (lane == 0) {
        red[warp] = hdot;
        red[kWarps + warp] = dD;
      }
    }

    // dC += exp(logP) dy h_in (whose dot with C is the cross term); dB += es u dh_out
    {
      Acc<kChunk, N> acc;
      mma(acc, dys, HP, 1, hT, 1, HP, 0, HD);                  // (t, k) over p
      const float el[2] = {expf(lp[acc.row(0)]), expf(lp[acc.row(2)])};
      float c[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < acc.CTW; ++j)
        if (acc.has(j))
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc.c[j][e] *= el[e >> 1];
            c[e >> 1] = fmaf(Cs[acc.row(e) * NP + acc.col(j, e)], acc.c[j][e], c[e >> 1]);
            dC.c[j][e] += acc.c[j][e];
          }
      acc.row_part(c[0], c[1], cr);
      acc.zero();
      mma(acc, us, HP, 1, dhT, 1, HP, 0, HD);                  // (t, k) over p
      const float es[2] = {expf(last - lp[acc.row(0)]), expf(last - lp[acc.row(2)])};
#pragma unroll
      for (int j = 0; j < acc.CTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dB.c[j][e] = fmaf(es[e >> 1], acc.c[j][e], dB.c[j][e]);
    }
    __syncthreads();

    // warp 0: dlogP, its reverse running sum da, ddt = A da + du . x, the partials
    if (warp == 0) {
      float hsum = 0.f, dDsum = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        hsum += red[w];
        dDsum += red[kWarps + w];
      }
      float d[2], q[2], ux[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 2 * lane + k;
        float qs = 0.f, crs = 0.f, uxs = 0.f, rss = 0.f, css = 0.f;
        for (int w = 0; w < kRowParts; ++w) {
          qs += qv[w * kChunk + t];
          crs += cr[w * kChunk + t];
          uxs += dux[w * kChunk + t];
          rss += rs[w * kChunk + t];
        }
        for (int w = 0; w < kColParts; ++w) css += cs[w * kChunk + t];
        q[k] = qs;
        ux[k] = uxs;
        d[k] = rss - css + crs - qs;
      }
      const float qsum = warp_sum(q[0] + q[1]);
      if (lane == 31) d[1] += qsum + expf(last) * hsum;
      float incl = d[0] + d[1];                             // sum over lanes >= this one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(kFull, incl, o);
        if (lane + o < 32) incl += v;
      }
      float after = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) after = 0.f;
      const float da1 = after + d[1], da0 = da1 + d[0];
      const float A = -expf(ld(a.A_log, h, a.at));
      const long long row = ((long long)tl.b * a.seqlen + tl.t0 + 2 * lane) * a.heads + h;
      st(a.ddt, row, a.dtt, fmaf(A, da0, ux[0]));
      st(a.ddt, row + a.heads, a.dtt, fmaf(A, da1, ux[1]));
      const float dA = warp_sum(fmaf(dtv[2 * lane], da0, dtv[2 * lane + 1] * da1));
      if (lane == 0) {
        const long long k = ((long long)tl.b * a.n + tl.i) * a.heads + h;
        a.part_head[2 * k] = dA;
        a.part_head[2 * k + 1] = dDsum;
      }
    }
    __syncthreads();
  }

  // the tile's dS through shared memory: dB += dS^T C, dC += dS B
#pragma unroll
  for (int j = 0; j < dS.CTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) Gm[dS.row(e) * CP + dS.col(j, e)] = dS.c[j][e];
  __syncthreads();
  mma(dB, Gm, 1, CP, Cs, NP, 1, dB.r0 & ~7, kChunk);           // (s, k) over t >= s
  mma(dC, Gm, CP, 1, Bs, NP, 1, 0, dC.r0 + 16);                // (t, k) over s <= t
  const int G = a.heads / a.per;
  const long long per_tile = (long long)a.batch * a.seqlen * G * N;
  const long long base = ((long long)(blockIdx.x % a.tiles) * a.batch + tl.b) * a.seqlen * G * N;
#pragma unroll
  for (int j = 0; j < dB.CTW; ++j)
    if (dB.has(j))
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long at = base + (tl.t0 + dB.row(e)) * G * N + (long long)tl.g * N + dB.col(j, e);
        a.part_bc[at] = dB.c[j][e];
        a.part_bc[(long long)a.tiles * per_tile + at] = dC.c[j][e];
      }
}

// dB and dC (B, S, G, N): the tiles' partials (tiles x B x S x G x N, dB's then dC's)
// added in tile order.
__global__ void __launch_bounds__(kThreads)
    repro_ssd_group_sum(const float* part, void* dB, void* dC, long long per_tile, int tiles,
                        int code) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= 2 * per_tile) return;
  const int which = e >= per_tile;
  const long long r = e - which * per_tile;
  float s = 0.f;
  for (int j = 0; j < tiles; ++j) s += part[((long long)which * tiles + j) * per_tile + r];
  st(which ? dC : dB, r, code, s);
}

// dA_log[h] = A_h sum dt da and dD[h] = sum dy x over the `rows` (batch, chunk)
// partials, one block a head, in a fixed order.
__global__ void __launch_bounds__(kThreads)
    repro_ssd_head_sums(const float* part, const void* A_log, void* dA_log, void* dD, int rows,
                        int heads, int a_code, int d_code) {
  __shared__ float red[2][kThreads / 32];
  const int h = blockIdx.x, tid = threadIdx.x;
  float sa = 0.f, sd = 0.f;
  for (int r = tid; r < rows; r += kThreads) {
    sa += part[2 * ((long long)r * heads + h)];
    sd += part[2 * ((long long)r * heads + h) + 1];
  }
  sa = warp_sum(sa);
  sd = warp_sum(sd);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = sa;
    red[1][tid >> 5] = sd;
  }
  __syncthreads();
  if (tid == 0) {
    sa = sd = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      sa += red[0][w];
      sd += red[1][w];
    }
    st(dA_log, h, a_code, -expf(ld(A_log, h, a_code)) * sa);
    st(dD, h, d_code, sd);
  }
}

// ------------------------------------------------------------------ launching

template <int HD, int N>
struct Smem {
  static constexpr int NP = pad(N), HP = pad(HD), CP = pad(kChunk);
  static constexpr int kRowParts = Acc<kChunk, HD>::WPR;
  static constexpr int kColParts = Acc<kChunk, kChunk>::WM;
  static constexpr size_t state_fwd = 4u * (kChunk * NP + kChunk * HP + 4 * kChunk);
  static constexpr size_t state_bwd = 4u * (2 * kChunk * NP + 2 * kChunk * HP + 4 * kChunk);
  static constexpr size_t out =
      4u * (2 * kChunk * NP + 2 * kChunk * CP + kChunk * HP + N * HP + 2 * kChunk);
  static constexpr size_t grad =
      4u * (2 * kChunk * NP + 3 * kChunk * CP + 2 * kChunk * HP + 2 * N * HP + 2 * kChunk +
            (4 * kRowParts + kColParts) * kChunk + 2 * kWarps);
  static_assert(grad <= 232448 && out <= 232448, "a block's shared memory");
};

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t st, const SsdArgs& a) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t pass(const SsdArgs& a, float* buf, const float* first, float* last_out, int hdn,
                 int reverse, cudaStream_t st) {
  const long long total = (long long)a.batch * a.heads * hdn;
  repro_ssd_state_pass<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      buf, a.decay, first, last_out, a.batch, a.heads, a.n, hdn, reverse);
  return cudaGetLastError();
}

template <int HD, int N>
cudaError_t forward(const SsdArgs& a, dim3 grid, const float* h0, float* h_fin,
                    cudaStream_t st) {
  cudaError_t e = launch(repro_ssd_chunk_state<HD, N, false>, grid, Smem<HD, N>::state_fwd, st, a);
  if (e == cudaSuccess) e = pass(a, a.states, h0, h_fin, HD * N, 0, st);
  if (e == cudaSuccess) e = launch(repro_ssd_chunk_out<HD, N>, grid, Smem<HD, N>::out, st, a);
  return e;
}

template <int HD, int N>
cudaError_t backward(const SsdArgs& a, dim3 grid, const float* h0, const float* dh_fin,
                     float* dh0, cudaStream_t st) {
  cudaError_t e = launch(repro_ssd_chunk_state<HD, N, true>, grid, Smem<HD, N>::state_bwd, st, a);
  if (e == cudaSuccess) e = pass(a, a.states, h0, nullptr, HD * N, 0, st);
  if (e == cudaSuccess) e = pass(a, a.dstates, dh_fin, dh0, HD * N, 1, st);
  if (e == cudaSuccess) e = launch(repro_ssd_chunk_grad<HD, N>, grid, Smem<HD, N>::grad, st, a);
  return e;
}

// the (head_dim, state) pairs compiled in, as SHAPES in kernels/ssd.py
#define SSD_SHAPES(X) X(16, 16) X(32, 16) X(64, 64) X(64, 128) X(128, 64)

}  // namespace

// One call's arguments (kernels/_build.py's SsdCall).  Tensors: x, dy, y, dx
// (batch, seqlen, heads, hd) with heads and hd packed; B, C, dB, dC (batch, seqlen,
// groups, state) with groups and state packed; dt, ddt (batch, seqlen, heads) with
// heads packed; the outputs and gradients (y, dx, dB, dC, ddt) contiguous; h0, h_fin,
// dh_fin, dh0 (batch, heads, hd, state) float32, contiguous, h0 / dh_fin / dh0 null
// when absent.  Scratch, float32: states and dstates batch x n x heads x hd x state
// (n = seqlen / 64), decay batch x n x heads, part_bc 2 x tiles x batch x seqlen x
// groups x state, part_head 2 x batch x n x heads.
struct SsdCall {
  const void* x;
  const void* B;
  const void* C;
  const void* dt;
  const void* A_log;
  const void* D;
  const float* h0;
  const void* dy;
  const float* dh_fin;
  void* y;
  float* h_fin;
  void* dx;
  void* dB;
  void* dC;
  void* ddt;
  void* dA_log;
  void* dD;
  float* dh0;
  float* states;
  float* dstates;
  float* decay;
  float* part_bc;
  float* part_head;
  void* stream;
  int batch;
  int seqlen;
  int heads;
  int groups;
  int hd;
  int state;
  long long x_sb;
  long long x_ss;
  long long b_sb;
  long long b_ss;
  long long c_sb;
  long long c_ss;
  long long dt_sb;
  long long dt_ss;
  long long dy_sb;
  long long dy_ss;
  int x_dtype;
  int dt_dtype;
  int a_dtype;
  int d_dtype;
  int device;
};

namespace {

// Returns 0, or -1 (head_dim and state not compiled in), -2 (a type code it does not
// take), -7 (a shape it does not take), before any launch.
int prepare(const SsdCall* c, SsdArgs& a, dim3& grid) {
  bool known = false;
#define SSD_KNOWN(H, N) known = known || (c->hd == H && c->state == N);
  SSD_SHAPES(SSD_KNOWN)
#undef SSD_KNOWN
  if (!known) return -1;
  for (int code : {c->x_dtype, c->dt_dtype, c->a_dtype, c->d_dtype})
    if (code < 0 || code > 2) return -2;
  if (c->batch <= 0 || c->groups <= 0 || c->heads % c->groups || c->seqlen % kChunk ||
      c->seqlen <= 0 || c->seqlen / kChunk > 65535)
    return -7;
  a = SsdArgs{};
  a.x = c->x;
  a.B = c->B;
  a.C = c->C;
  a.dt = c->dt;
  a.A_log = c->A_log;
  a.D = c->D;
  a.dy = c->dy;
  a.y = c->y;
  a.dx = c->dx;
  a.ddt = c->ddt;
  a.states = c->states;
  a.dstates = c->dstates;
  a.decay = c->decay;
  a.part_bc = c->part_bc;
  a.part_head = c->part_head;
  a.batch = c->batch;
  a.seqlen = c->seqlen;
  a.heads = c->heads;
  a.n = c->seqlen / kChunk;
  a.per = c->heads / c->groups;
  a.tiles = (a.per + kHeadTile - 1) / kHeadTile;
  a.x_sb = c->x_sb;
  a.x_ss = c->x_ss;
  a.b_sb = c->b_sb;
  a.b_ss = c->b_ss;
  a.c_sb = c->c_sb;
  a.c_ss = c->c_ss;
  a.dt_sb = c->dt_sb;
  a.dt_ss = c->dt_ss;
  a.dy_sb = c->dy_sb;
  a.dy_ss = c->dy_ss;
  a.xt = c->x_dtype;
  a.dtt = c->dt_dtype;
  a.at = c->a_dtype;
  a.dtyp = c->d_dtype;
  grid = dim3(c->groups * a.tiles, a.n, c->batch);
  return 0;
}

}  // namespace

// Forward: y and h_fin.  Returns 0, a cudaError_t (> 0) from a launch, or prepare's
// refusals.
extern "C" int repro_ssd_fwd(const SsdCall* c) {
  SsdArgs a;
  dim3 grid;
  const int code = prepare(c, a, grid);
  if (code) return code;
  DeviceGuard guard(c->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  cudaError_t e = cudaSuccess;
#define SSD_FWD(H, N) \
  if (c->hd == H && c->state == N) e = forward<H, N>(a, grid, c->h0, c->h_fin, st);
  SSD_SHAPES(SSD_FWD)
#undef SSD_FWD
  return (int)e;
}

// Backward: dx, dB, dC, ddt, dA_log, dD, and dh0 when it is not null.
extern "C" int repro_ssd_bwd(const SsdCall* c) {
  SsdArgs a;
  dim3 grid;
  const int code = prepare(c, a, grid);
  if (code) return code;
  DeviceGuard guard(c->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  cudaError_t e = cudaSuccess;
#define SSD_BWD(H, N) \
  if (c->hd == H && c->state == N) e = backward<H, N>(a, grid, c->h0, c->dh_fin, c->dh0, st);
  SSD_SHAPES(SSD_BWD)
#undef SSD_BWD
  if (e != cudaSuccess) return (int)e;
  const long long per_tile = (long long)c->batch * c->seqlen * c->groups * c->state;
  repro_ssd_group_sum<<<(unsigned)((2 * per_tile + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      c->part_bc, c->dB, c->dC, per_tile, a.tiles, c->x_dtype);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  repro_ssd_head_sums<<<c->heads, kThreads, 0, st>>>(c->part_head, c->A_log, c->dA_log, c->dD,
                                                     c->batch * a.n, c->heads, c->a_dtype,
                                                     c->d_dtype);
  return (int)cudaGetLastError();
}
