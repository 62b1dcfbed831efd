// Fused attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the backward of the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel's VJP: _flash_diff / _flash_vjp_fwd / _flash_vjp_bwd).  The reference
// has no backward kernel: _flash_vjp_bwd differentiates mha_reference, which on the
// card would materialise the (B, H, Sq, Skv) fp32 scores and their gradient.  This
// file computes the same gradients without them, from the forward's inputs, its
// output o and its per-row log-sum-exp lse (flash_attention.cu writes it):
//   D  = rowsum(dO o O)                         (fp32, one value per query row)
//   s  = q k^T * scale, capped s = tanh(s / c) * c when softcap c != 0
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
// every product must run on the tensor cores.  The design is deterministic, with no
// atomics and no fp32 dq buffer:
//   * a small kernel computes D for every query row into a (B, H, Sq) fp32 scratch;
//   * pass A (dk, dv): one block per (batch, KV head, 64-key tile), one warp per 16
//     keys (two warps per 16 keys at head_dim 256, each owning half of the columns of
//     dk and dv and both recomputing the scores).  The block loops over the G query
//     heads of the group and over the query tiles that can see its keys, holds dk and
//     dv in registers for the whole loop and writes them once.  It computes the
//     transposed tiles S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T are
//     already the A operands of dv += P^T dO and dk += dS^T Q;
//   * pass B (dq): one block per (batch, q head, 64-row query tile), one warp per 16
//     rows, looping over the key tiles it can see; dq stays in registers;
//   * both passes use mma.sync m16n8k16 with fp32 accumulation (flash_mma.cuh), tiles
//     staged through padded shared memory by cp.async, double-buffered (the next
//     query tile, or key tile, lands while the current one is computed);
//   * tiles the mask hides are not visited (the query range a key tile can see, the
//     key range a query tile can see), heavy tiles are scheduled first, ragged tails
//     are zero-filled and masked.
// Pass A and pass B each recompute s and dp, so the design spends 14 * hd flops per
// pair instead of 10.  fp32 inputs take scalar kernels of the same two-pass shape (a
// warp per key or per query row, a lane per pair), for the tight comparison with the
// plain version, not for speed.
//
// The C entry point below picks the kernels by type and head_dim with the backward's
// rule (flash::variant_for): 16-bit inputs at head_dim 64 and 128 -- the dense
// training path's shapes -- take the one-pass TMA + wgmma kernel of
// flash_attention_bwd_sm90.cu (dq summed by atomics); the other 16-bit head_dims (16,
// 32, 80 -- zamba2's shared attention -- and 256) the mma.sync passes of this file;
// float32 the scalar passes.  A split by shape, not a fallback.
//
// Head_dim 80 takes the tiles of 16 and 32 (64 keys and 64 query rows in pass A, 64
// rows and 64 keys in pass B): dk and dv of 16 keys hold 80 fp32 registers a thread,
// dq 40.  Its rows are padded to 88 elements (176 bytes, 44 words: the eight rows g
// of a fragment load start in banks 12g mod 32, all distinct, and ldmatrix's eight
// 16-byte rows in distinct groups), so pass A needs 68,608 bytes of shared memory and
// pass B 67,584: both opt in to more than the default 48 KB (allow_smem).  Its wgmma
// redesign, on the forward's 64 + 16 column split, is still to do (ROADMAP K3).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "flash_mma.cuh"

namespace {

using flash::allow_smem;
using flash::BwdParams;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::kv_range;
using flash::ldmatrix_x4_trans;
using flash::lds32;
using flash::load_floats_async;
using flash::load_q_fragment;
using flash::load_tile_async;
using flash::Mma;
using flash::pack_a;
using flash::q_range;
using flash::warp_sum;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

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

// ---------------------------------------------------------------------------
// D = rowsum(dO o O): a warp per (batch, head, row)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void flash_bwd_delta_kernel(const BwdParams p, int hd) {
  const long long idx = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= (long long)p.B * p.H * p.Sq) return;
  const int row = (int)(idx % p.Sq);
  const int h = (int)((idx / p.Sq) % p.H);
  const int b = (int)(idx / ((long long)p.Sq * p.H));
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + row * p.do_ss + h * p.do_sh;
  float acc = 0.f;
  for (int i = lane; i < hd; i += 32) acc += to_f<T>(o[i]) * to_f<T>(d[i]);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[idx] = acc;  // idx = (b * H + h) * Sq + row
}

// ---------------------------------------------------------------------------
// 16-bit pass A: dk, dv
// ---------------------------------------------------------------------------

template <int HD, int BN, int BMQ>
struct SmemA {
  static constexpr int LDS = HD + 8;
  static constexpr int kKV = 2 * BN * LDS;      // elements: K and V tiles
  static constexpr int kStage = 2 * BMQ * LDS;  // elements: one Q and one dO tile
  template <typename T>
  static constexpr int bytes() {
    return (kKV + 2 * kStage) * (int)sizeof(T) + 2 * 2 * BMQ * (int)sizeof(float);
  }
};

template <typename T, int HD, int BN, int BMQ, int HSPLIT>
__global__ void __launch_bounds__(BN / 16 * HSPLIT * 32)
    flash_bwd_dkdv_mma_kernel(const BwdParams p) {
  constexpr int NWR = BN / 16;       // warps along the keys
  constexpr int NT = NWR * HSPLIT * 32;
  constexpr int HO = HD / HSPLIT;    // columns of dk, dv a warp owns
  using S = SmemA<HD, BN, BMQ>;
  constexpr int LDS = S::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + BN * LDS;
  T* sStage = sK + S::kKV;  // stage s: Q tile at s * kStage, dO tile after it
  float* sLD = reinterpret_cast<float*>(sStage + 2 * S::kStage);  // stage s: lse, then D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rs = warp % NWR, hs = warp / NWR;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n0 = blockIdx.x * BN;  // early key tiles are seen by the most queries: first
  const int G = p.H / p.KV;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  int lo, hi;
  q_range(p, n0, BN, BMQ, lo, hi);
  const int n_qt = hi > lo ? (hi - lo + BMQ - 1) / BMQ : 0;
  const int n_it = G * n_qt;

  auto load_stage = [&](int it, int s) {
    const int h = kvh * G + it / n_qt, m0 = lo + (it % n_qt) * BMQ;
    T* dst = sStage + s * S::kStage;
    load_tile_async<T, HD, LDS>(dst, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                                p.q_ss, m0, p.Sq, BMQ, tid, NT);
    load_tile_async<T, HD, LDS>(dst + BMQ * LDS,
                                static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh,
                                p.do_ss, m0, p.Sq, BMQ, tid, NT);
    const long long row0 = ((long long)b * p.H + h) * p.Sq;
    load_floats_async(sLD + s * 2 * BMQ, p.lse + row0, m0, p.Sq, BMQ, tid, NT);
    load_floats_async(sLD + s * 2 * BMQ + BMQ, p.delta + row0, m0, p.Sq, BMQ, tid, NT);
  };

  load_tile_async<T, HD, LDS>(sK, kg, p.k_ss, n0, p.Skv, BN, tid, NT);
  load_tile_async<T, HD, LDS>(sV, vg, p.v_ss, n0, p.Skv, BN, tid, NT);
  if (n_it > 0) load_stage(0, 0);
  cp_async_commit();

  float dk[HO / 8][4], dv[HO / 8][4];
#pragma unroll
  for (int j = 0; j < HO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int key[2] = {n0 + rs * 16 + g, n0 + rs * 16 + g + 8};
  const T* k_frag = sK + (rs * 16 + g) * LDS + t * 2;
  const T* v_frag = sV + (rs * 16 + g) * LDS + t * 2;

  for (int it = 0, s = 0; it < n_it; ++it, s ^= 1) {
    if (it + 1 < n_it) {
      load_stage(it + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sQ = sStage + s * S::kStage;
    const T* sdO = sQ + BMQ * LDS;
    const float* sL = sLD + s * 2 * BMQ;
    const float* sD = sL + BMQ;
    const int m0 = lo + (it % n_qt) * BMQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BMQ queries
    float st[BMQ / 8][4], dpt[BMQ / 8][4];
#pragma unroll
    for (int j = 0; j < BMQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_q_fragment(ak, k_frag + kk * 16, LDS);
      load_q_fragment(av, v_frag + kk * 16, LDS);
#pragma unroll
      for (int j = 0; j < BMQ / 8; ++j) {
        const T* qf = sQ + (j * 8 + g) * LDS + kk * 16 + t * 2;
        const T* df = sdO + (j * 8 + g) * LDS + kk * 16 + t * 2;
        Mma<T>::mma(st[j], ak, lds32(qf), lds32(qf + 8));
        Mma<T>::mma(dpt[j], av, lds32(df), lds32(df + 8));
      }
    }
    // P^T and dS^T in place: rows are keys, columns query rows
#pragma unroll
    for (int j = 0; j < BMQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + t * 2 + (e & 1);
        const bool ok = visible(p, m0 + c, key[e >> 1]);
        float pe, ds;
        prob_and_grad(p, ok, st[j][e], sL[c], sD[c], dpt[j][e], pe, ds);
        st[j][e] = pe;
        dpt[j][e] = ds;
      }
    // dv += P^T dO and dk += dS^T Q: the B operands are the row-major dO and Q tiles
#pragma unroll
    for (int kk = 0; kk < BMQ / 16; ++kk) {
      uint32_t ap[4], as[4];
      pack_a<T>(ap, st[2 * kk], st[2 * kk + 1]);
      pack_a<T>(as, dpt[2 * kk], dpt[2 * kk + 1]);
      const int off = (kk * 16 + (lane & 15)) * LDS + hs * HO + (lane >> 4) * 8;
#pragma unroll
      for (int jn = 0; jn < HO / 8; jn += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, sdO + off + jn * 8);
        Mma<T>::mma(dv[jn], ap, bf[0], bf[1]);
        Mma<T>::mma(dv[jn + 1], ap, bf[2], bf[3]);
        ldmatrix_x4_trans(bf, sQ + off + jn * 8);
        Mma<T>::mma(dk[jn], as, bf[0], bf[1]);
        Mma<T>::mma(dk[jn + 1], as, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is free: the next iteration refills it
  }
  cp_async_wait<0>();  // K and V were loaded even when no query sees them

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.Skv) continue;
    T* krow = dkg + (long long)key[r] * p.dk_ss + hs * HO + t * 2;
    T* vrow = dvg + (long long)key[r] * p.dv_ss + hs * HO + t * 2;
#pragma unroll
    for (int j = 0; j < HO / 8; ++j) {
      *reinterpret_cast<uint32_t*>(krow + j * 8) =
          Mma<T>::pack(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(vrow + j * 8) = Mma<T>::pack(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit pass B: dq
// ---------------------------------------------------------------------------

template <typename T, int HD, int BM, int BN>
__global__ void __launch_bounds__(BM * 2) flash_bwd_dq_mma_kernel(const BwdParams p) {
  constexpr int NT = BM * 2;  // one warp per 16 query rows
  constexpr int LDS = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + BM * LDS;
  T* sKV = sdO + BM * LDS;  // two stages, each a K tile followed by a V tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // late tiles do the most work: start them first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * BM;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  int kv_lo, kv_hi;
  kv_range(p, q0, BM, BN, kv_lo, kv_hi);

  load_tile_async<T, HD, LDS>(sQ, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                              q0, p.Sq, BM, tid, NT);
  load_tile_async<T, HD, LDS>(sdO, static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh,
                              p.do_ss, q0, p.Sq, BM, tid, NT);
  if (kv_lo < kv_hi) {
    load_tile_async<T, HD, LDS>(sKV, kg, p.k_ss, kv_lo, p.Skv, BN, tid, NT);
    load_tile_async<T, HD, LDS>(sKV + BN * LDS, vg, p.v_ss, kv_lo, p.Skv, BN, tid, NT);
  }
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], dlt[2];
  const long long row0 = ((long long)b * p.H + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = row[r] < p.Sq ? p.lse[row0 + row[r]] : 0.f;
    dlt[r] = row[r] < p.Sq ? p.delta[row0 + row[r]] : 0.f;
  }
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const T* q_frag = sQ + (warp * 16 + g) * LDS + t * 2;
  const T* d_frag = sdO + (warp * 16 + g) * LDS + t * 2;

  int stage = 0;
  for (int n0 = kv_lo; n0 < kv_hi; n0 += BN, stage ^= 1) {
    if (n0 + BN < kv_hi) {
      T* next = sKV + (stage ^ 1) * 2 * BN * LDS;
      load_tile_async<T, HD, LDS>(next, kg, p.k_ss, n0 + BN, p.Skv, BN, tid, NT);
      load_tile_async<T, HD, LDS>(next + BN * LDS, vg, p.v_ss, n0 + BN, p.Skv, BN, tid, NT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sK = sKV + stage * 2 * BN * LDS;
    const T* sV = sK + BN * LDS;

    // S = Q K^T and dP = dO V^T: 16 rows x BN keys
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ad[4];
      load_q_fragment(aq, q_frag + kk * 16, LDS);
      load_q_fragment(ad, d_frag + kk * 16, LDS);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const T* kf = sK + (j * 8 + g) * LDS + kk * 16 + t * 2;
        const T* vf = sV + (j * 8 + g) * LDS + kk * 16 + t * 2;
        Mma<T>::mma(s[j], aq, lds32(kf), lds32(kf + 8));
        Mma<T>::mma(dp[j], ad, lds32(vf), lds32(vf + 8));
      }
    }
    // dS in place of S
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = visible(p, row[r], n0 + j * 8 + t * 2 + (e & 1));
        float pe, ds;
        prob_and_grad(p, ok, s[j][e], lse[r], dlt[r], dp[j][e], pe, ds);
        s[j][e] = ds;
      }
    // dq += dS K: K's row-major tile is the [key][d] B operand
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      pack_a<T>(a, s[2 * kk], s[2 * kk + 1]);
      const T* k_rows = sK + (kk * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
      for (int jn = 0; jn < HD / 8; jn += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, k_rows + jn * 8);
        Mma<T>::mma(dq[jn], a, bf[0], bf[1]);
        Mma<T>::mma(dq[jn + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is free: the next iteration refills it
  }
  cp_async_wait<0>();  // Q and dO were loaded even when no key is visible

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Sq) continue;
    T* qrow = dqg + (long long)row[r] * p.dq_ss + t * 2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(qrow + j * 8) =
          Mma<T>::pack(dq[j][2 * r] * p.scale, dq[j][2 * r + 1] * p.scale);
  }
}

// Tile shapes by head_dim (16, 32, 80 and 256: 64 and 128 take the wgmma kernel): pass A
// (keys per block, query rows per step, warps per 16 keys), pass B (query rows per
// block, keys per step).  Chosen so the accumulators
// fit the register file: at head_dim 256 dk and dv of 16 keys would take 256 fp32
// registers a thread, so two warps share those keys.
template <typename T, int HD, int BN_A, int BMQ_A, int HSPLIT, int BM_B, int BN_B>
int launch_mma(const BwdParams& p, cudaStream_t st) {
  {
    auto kern = flash_bwd_dkdv_mma_kernel<T, HD, BN_A, BMQ_A, HSPLIT>;
    constexpr int smem = SmemA<HD, BN_A, BMQ_A>::template bytes<T>();
    static bool raised = false;  // per instantiation
    cudaError_t e = allow_smem(kern, smem, raised);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.Skv + BN_A - 1) / BN_A, p.KV, p.B);
    kern<<<grid, BN_A / 16 * HSPLIT * 32, smem, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  {
    auto kern = flash_bwd_dq_mma_kernel<T, HD, BM_B, BN_B>;
    constexpr int smem = (2 * BM_B + 4 * BN_B) * (HD + 8) * (int)sizeof(T);
    static bool raised = false;
    cudaError_t e = allow_smem(kern, smem, raised);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.Sq + BM_B - 1) / BM_B, p.H, p.B);
    kern<<<grid, BM_B * 2, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch_mma(const BwdParams& p, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_mma<T, 16, 64, 64, 1, 64, 64>(p, st);
    case 32: return launch_mma<T, 32, 64, 64, 1, 64, 64>(p, st);
    case 80: return launch_mma<T, 80, 64, 64, 1, 64, 64>(p, st);
    case 256: return launch_mma<T, 256, 64, 32, 2, 64, 32>(p, st);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kScalarWarps = 8;  // keys (pass A) or query rows (pass B) per block
constexpr int kScalarLanes = 32; // query rows (pass A) or keys (pass B) per step

// Pass A: a warp per key, a lane per query row of the current 32-row step.
template <int HD>
__global__ void __launch_bounds__(kScalarWarps * 32) flash_bwd_dkdv_scalar_kernel(const BwdParams p) {
  constexpr int NT = kScalarWarps * 32;
  constexpr int LDQ = HD + 1;          // lane j reads row j: stride HD+1 avoids bank conflicts
  constexpr int DPL = (HD + 31) / 32;  // output dims owned by each lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [32][LDQ]
  float* sdO = sQ + kScalarLanes * LDQ;            // [32][LDQ]
  float* sK = sdO + kScalarLanes * LDQ;            // [8][HD]
  float* sV = sK + kScalarWarps * HD;              // [8][HD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n0 = blockIdx.x * kScalarWarps;
  const int key = n0 + warp;
  const int G = p.H / p.KV;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  for (int i = tid; i < kScalarWarps * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    const bool ok = n0 + r < p.Skv;
    sK[i] = ok ? kg[(long long)(n0 + r) * p.k_ss + c] : 0.f;
    sV[i] = ok ? vg[(long long)(n0 + r) * p.v_ss + c] : 0.f;
  }
  int lo, hi;
  q_range(p, n0, kScalarWarps, kScalarLanes, lo, hi);

  float ak[DPL], av[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) ak[i] = av[i] = 0.f;

  for (int gq = 0; gq < G; ++gq) {
    const int h = kvh * G + gq;
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long row0 = ((long long)b * p.H + h) * p.Sq;
    for (int m0 = lo; m0 < hi; m0 += kScalarLanes) {
      __syncthreads();
      for (int i = tid; i < kScalarLanes * HD; i += NT) {
        const int r = i / HD, c = i % HD;
        const bool ok = m0 + r < p.Sq;
        sQ[r * LDQ + c] = ok ? qg[(long long)(m0 + r) * p.q_ss + c] : 0.f;
        sdO[r * LDQ + c] = ok ? dg[(long long)(m0 + r) * p.do_ss + c] : 0.f;
      }
      __syncthreads();
      const int row = m0 + lane;
      float raw = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        raw += sQ[lane * LDQ + d] * sK[warp * HD + d];
        dp += sdO[lane * LDQ + d] * sV[warp * HD + d];
      }
      const bool ok = visible(p, row, key);
      float pe, ds;
      prob_and_grad(p, ok, raw, ok ? p.lse[row0 + row] : 0.f, ok ? p.delta[row0 + row] : 0.f,
                    dp, pe, ds);
      const int nrows = min(kScalarLanes, p.Sq - m0);  // same for the whole block
      for (int j = 0; j < nrows; ++j) {
        const float pb = __shfl_sync(0xffffffffu, pe, j);
        const float sb = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) {
            av[i] += pb * sdO[j * LDQ + d];
            ak[i] += sb * sQ[j * LDQ + d];
          }
        }
      }
    }
  }
  if (key < p.Skv) {
    float* dkr = static_cast<float*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh + (long long)key * p.dk_ss;
    float* dvr = static_cast<float*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh + (long long)key * p.dv_ss;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        dkr[d] = ak[i] * p.scale;
        dvr[d] = av[i];
      }
    }
  }
}

// Pass B: a warp per query row, a lane per key of the current 32-key step.
template <int HD>
__global__ void __launch_bounds__(kScalarWarps * 32) flash_bwd_dq_scalar_kernel(const BwdParams p) {
  constexpr int NT = kScalarWarps * 32;
  constexpr int LDK = HD + 1;
  constexpr int DPL = (HD + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [32][LDK]
  float* sV = sK + kScalarLanes * LDK;             // [32][LDK]
  float* sQ = sV + kScalarLanes * LDK;             // [8][HD]
  float* sdO = sQ + kScalarWarps * HD;             // [8][HD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kScalarWarps;
  const int row = q0 + warp;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  for (int i = tid; i < kScalarWarps * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    const bool ok = q0 + r < p.Sq;
    sQ[i] = ok ? qg[(long long)(q0 + r) * p.q_ss + c] : 0.f;
    sdO[i] = ok ? dg[(long long)(q0 + r) * p.do_ss + c] : 0.f;
  }
  const long long row0 = ((long long)b * p.H + h) * p.Sq;
  const float lse = row < p.Sq ? p.lse[row0 + row] : 0.f;
  const float dlt = row < p.Sq ? p.delta[row0 + row] : 0.f;
  int kv_lo, kv_hi;
  kv_range(p, q0, kScalarWarps, kScalarLanes, kv_lo, kv_hi);

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  for (int n0 = kv_lo; n0 < kv_hi; n0 += kScalarLanes) {
    __syncthreads();
    for (int i = tid; i < kScalarLanes * HD; i += NT) {
      const int r = i / HD, c = i % HD;
      const bool ok = n0 + r < p.Skv;
      sK[r * LDK + c] = ok ? kg[(long long)(n0 + r) * p.k_ss + c] : 0.f;
      sV[r * LDK + c] = ok ? vg[(long long)(n0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();
    float raw = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      raw += sQ[warp * HD + d] * sK[lane * LDK + d];
      dp += sdO[warp * HD + d] * sV[lane * LDK + d];
    }
    float pe, ds;
    prob_and_grad(p, visible(p, row, n0 + lane), raw, lse, dlt, dp, pe, ds);
    const int nkeys = min(kScalarLanes, p.Skv - n0);  // same for the whole block
    for (int j = 0; j < nkeys; ++j) {
      const float sb = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) acc[i] += sb * sK[j * LDK + d];
      }
    }
  }
  if (row < p.Sq) {
    float* dqr = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + (long long)row * p.dq_ss;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) dqr[d] = acc[i] * p.scale;
    }
  }
}

template <int HD>
int launch_scalar(const BwdParams& p, cudaStream_t st) {
  constexpr int smem = (2 * kScalarLanes * (HD + 1) + 2 * kScalarWarps * HD) * (int)sizeof(float);
  {
    auto kern = flash_bwd_dkdv_scalar_kernel<HD>;
    static bool raised = false;
    cudaError_t e = allow_smem(kern, smem, raised);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.Skv + kScalarWarps - 1) / kScalarWarps, p.KV, p.B);
    kern<<<grid, kScalarWarps * 32, smem, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  {
    auto kern = flash_bwd_dq_scalar_kernel<HD>;
    static bool raised = false;
    cudaError_t e = allow_smem(kern, smem, raised);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.Sq + kScalarWarps - 1) / kScalarWarps, p.H, p.B);
    kern<<<grid, kScalarWarps * 32, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
}

int dispatch_scalar(const BwdParams& p, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_scalar<16>(p, st);
    case 32: return launch_scalar<32>(p, st);
    case 64: return launch_scalar<64>(p, st);
    case 80: return launch_scalar<80>(p, st);
    case 128: return launch_scalar<128>(p, st);
    case 256: return launch_scalar<256>(p, st);
    default: return -1;
  }
}

template <typename T>
cudaError_t launch_delta(const BwdParams& p, int hd, cudaStream_t st) {
  const long long rows = (long long)p.B * p.H * p.Sq;
  constexpr int kWarps = 8;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kWarps * 32, 0, st>>>(p, hd);
  return cudaGetLastError();
}

}  // namespace

// One backward call's arguments, passed as one block (there are too many for a plain
// argument list).  dtype codes: 0 = float32, 1 = bfloat16, 2 = float16, shared by
// q, k, v, o, dout, dq, dk and dv.  lse is the forward's (B, H, Sq) float32 output;
// delta and dq_acc are float32 scratch as flash::BwdParams states (flash_attention.cuh:
// for the wgmma kernel 2 x (B, H, sq_pad(Sq)) and (B, H, sq_pad(Sq), hd), else
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
  int dtype;
  int device;
};

// The kernels a backward call of that type and head_dim launches: 0 scalar,
// 1 mma.sync, 2 TMA + wgmma (the backward's rule); -1 if none is compiled in.
extern "C" int repro_flash_attention_bwd_variant(int hd, int dtype) {
  return flash::variant_for(hd, dtype, true);
}

// Launches the backward's kernels on `stream` of CUDA device `device`: D, pass A and
// pass B, or the wgmma kernel's prep, one pass and dq cast.  Returns 0, a cudaError_t
// (> 0) from a launch, -1 for a head_dim that is not compiled in, -2 for an unknown
// type, -3 / -4 when the wgmma kernel's tensor maps cannot be made.  No variant ever
// stands in for another.
extern "C" int repro_flash_attention_bwd(const FlashBwdCall* c) {
  if (c->B <= 0 || c->H <= 0 || c->Sq <= 0 || c->Skv <= 0) return 0;
  if (repro_flash_attention_bwd_variant(c->hd, c->dtype) < 0)
    return (c->dtype < 0 || c->dtype > 2) ? -2 : -1;
  BwdParams p;
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
  p.scale = 1.0f / sqrtf((float)c->hd);
  flash::DeviceGuard guard(c->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  if (flash::variant_for(c->hd, c->dtype, true) == flash::kSm90Wgmma)
    return flash::launch_bwd_sm90(p, c->hd, c->dtype, st);
  cudaError_t e;
  switch (c->dtype) {
    case 0: e = launch_delta<float>(p, c->hd, st); break;
    case 1: e = launch_delta<__nv_bfloat16>(p, c->hd, st); break;
    default: e = launch_delta<__half>(p, c->hd, st); break;
  }
  if (e != cudaSuccess) return (int)e;
  switch (c->dtype) {
    case 0: return dispatch_scalar(p, c->hd, st);
    case 1: return dispatch_mma<__nv_bfloat16>(p, c->hd, st);
    default: return dispatch_mma<__half>(p, c->hd, st);
  }
}
