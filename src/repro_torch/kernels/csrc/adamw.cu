// Fused multi-tensor AdamW for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: it stands for src/repro/optim/adamw.py (adamw_update), plain
// JAX that XLA fuses into a few passes.  Its port (optim/adamw.py, `plain_update`)
// runs ~20 PyTorch launches a parameter tensor, nearly each a full float32 pass.  Here one
// step over every leaf of one (parameter type, gradient type) group is two kernels
// and one more for the whole step:
//   repro_adamw_sumsq   the gradients' sums of squares, float64 partials from a fixed
//                       number of blocks (kSumsqBlocks), each table's added to the last
//                       one's slot by slot;
//   repro_adamw_scalars one block: the partials added in a fixed order, the global norm
//                       and the clip scale min(1, clip / max(norm, 1e-12)), written to
//                       the card (no host synchronisation);
//   repro_adamw_update  g = float(g) * scale; m = m*b1 + (1-b1)*g;
//                       v = v*b2 + (1-b2)*(g*g);
//                       p -= ((m/b1c) / (sqrt(v/b2c) + eps) + wd*p) * lr
//                       in float32, in the plain update's order of operations (its
//                       multiply-adds where nvcc contracts PyTorch's `a + alpha*b` of
//                       add_, addcmul_ and sub_), with IEEE division and square root;
//                       p rounded to nearest even in its own type, m and v updated in
//                       place.  scale, lr, b1c and b2c are read from the card: the
//                       learning rate and the bias corrections are the plain update's
//                       own PyTorch operations (optim/adamw.py, `step_scalars`).
//
// Bound on this card: bytes.  ~20 flops an entry against 24 bytes moved (bf16 p and
// g: g read by both passes, p, m and v read and written once), far below the ~295
// flop/byte ridge.  What the design does:
//   * the leaves go as a table in the kernel's parameters (AdamwTable, under 4 KB,
//     kMaxLeaves leaves a launch): no host-to-device copy, nothing to synchronise,
//     and each launch sees its table as it was when enqueued;
//   * every leaf is cut into chunks of kChunk entries, numbered across the table; a
//     persistent grid walks the chunks with a grid stride, each block finding its
//     chunk's leaf by a binary search of the table (uniform across the block, read
//     from the constant bank).  So the 545 M-entry embedding and a 512-entry bias
//     share one launch and spread evenly over the SMs;
//   * 16-byte loads and stores (8 entries a thread a step; float32 tensors as two
//     16-byte packs), streaming cache hints since nothing is read again from L2; a
//     leaf whose pointers are not all 16-byte aligned, and a chunk's tail that is not
//     a whole pack, take scalar accesses;
//   * determinism: a leaf's entries reach the same thread in the same order on every
//     call (the table and grid depend only on the leaves), the partials are summed in
//     a fixed order, so the norm, and every update, is the same bit for bit from run
//     to run.  Float64 accumulators keep the sum of 2.4 G squares exact to well under
//     a float32 ulp.
// On an H100 (700 W) at qwen2-7b's 8-layer leaf set (98 leaves, 2.409 G bf16 entries)
// the step takes ~21.0 ms against the 17.26 ms that its 24 bytes an entry need at
// 3.35 TB/s; two steps a thread or 8 blocks an SM (both spill under their register
// caps), no cache hints, 16 K-entry chunks and one 256-leaf table (parameters over
// 4 KB) each read the same or slower.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

#include "rmsnorm.cuh"

using rmsnorm::DeviceGuard;
using rmsnorm::from_f;
using rmsnorm::to_f;

constexpr int kThreads = 256;
constexpr int kVec = 8;                         // entries a thread handles a step
constexpr long long kChunk = 32768;             // entries a chunk: 16 block steps
constexpr int kSumsqBlocks = 528;               // 4 blocks on each of an H100's 132 SMs
constexpr int kUpdateBlocksPerSm = 4;           // held to by __launch_bounds__
constexpr int kMaxLeaves = 80;                  // AdamwTable stays under 4 KB

static_assert(kChunk % (kThreads * kVec) == 0, "a chunk is whole block steps");

struct AdamwLeaf {
  void* p;
  const void* g;
  float* m;
  float* v;
  long long n;
  int chunk0;   // the leaf's first chunk in the table's numbering
  int aligned;  // p, g, m and v all 16-byte aligned
};

struct AdamwTable {
  AdamwLeaf leaf[kMaxLeaves];
  int leaves;
  int chunks;
};

static_assert(sizeof(AdamwTable) + 64 <= 4096, "the table and the other arguments fit 4 KB");

// float32 hyper-parameters of the update, and where the step's scalars lie on the card
// (scale written by repro_adamw_scalars; lr, b1c and b2c by the caller's operations)
struct AdamwHyper {
  const float* scale;
  const float* lr;
  const float* b1c;
  const float* b2c;
  float b1;
  float one_minus_b1;
  float b2;
  float one_minus_b2;
  float eps;
  float wd;
};

struct AdamwScalars {
  float scale, lr, b1c, b2c, b1, omb1, b2, omb2, eps, wd;
};

// The leaf that holds chunk c: the last whose first chunk is at most c (a leaf with
// no chunk shares its first chunk with the next and is passed over).
__device__ __forceinline__ int leaf_of(const AdamwTable& t, int c) {
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].chunk0 <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ void load8(const T* src, float (&x)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < kVec / kPer; ++k) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(src) + k);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) x[k * kPer + j] = to_f<T>(e[j]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&x)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < kVec / kPer; ++k) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) e[j] = from_f<T>(x[k * kPer + j]);
    __stcs(reinterpret_cast<uint4*>(dst) + k, raw);
  }
}

// The block's sum of one double a thread, in a fixed order; the result in thread 0.
__device__ __forceinline__ double block_sum(double s) {
  __shared__ double warps[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    s = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warps[w];
  }
  return s;
}

template <typename G>
__global__ void __launch_bounds__(kThreads, 4)
    repro_adamw_sumsq(const __grid_constant__ AdamwTable t, double* __restrict__ partials,
                      int first) {
  double acc = 0.0;
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    const AdamwLeaf& L = t.leaf[leaf_of(t, c)];
    const G* g = static_cast<const G*>(L.g);
    const long long lo = (long long)(c - L.chunk0) * kChunk;
    const long long hi = min(L.n, lo + kChunk);
    long long tail = lo;
    if (L.aligned) {
      tail = lo + (hi - lo) / kVec * kVec;
      for (long long i = lo + threadIdx.x * kVec; i < tail; i += kThreads * kVec) {
        float x[kVec];
        load8(g + i, x);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) s = fmaf(x[j], x[j], s);
        acc += s;
      }
    }
    for (long long i = tail + threadIdx.x; i < hi; i += kThreads) {
      const float x = to_f<G>(g[i]);
      acc += x * x;
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = first ? acc : partials[blockIdx.x] + acc;
}

// One block: the global norm and the clip scale, as the plain update's PyTorch
// operations compute them in float32 (NaN carried through as torch.clamp carries it;
// `clip / x` is a product with x's float32 reciprocal there) into out[0] and out[1].
__global__ void __launch_bounds__(kThreads)
    repro_adamw_scalars(const double* __restrict__ partials, float* __restrict__ out,
                        float clip) {
  double s = 0.0;
  for (int i = threadIdx.x; i < kSumsqBlocks; i += kThreads) s += partials[i];
  s = block_sum(s);
  if (threadIdx.x == 0) {
    const float norm = (float)sqrt(s);
    const float low = isnan(norm) ? norm : fmaxf(norm, 1e-12f);
    const float q = __fmul_rn(1.f / low, clip);
    out[0] = norm;
    out[1] = isnan(q) ? q : fminf(q, 1.f);
  }
}

__device__ __forceinline__ float adamw_entry(float p, float g, float& m, float& v,
                                             const AdamwScalars& s) {
  g = g * s.scale;
  m = fmaf(s.omb1, g, m * s.b1);
  v = fmaf(s.omb2, g * g, v * s.b2);
  float d = (m / s.b1c) / (sqrtf(v / s.b2c) + s.eps);
  d = fmaf(s.wd, p, d) * s.lr;
  return p - d;
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads, kUpdateBlocksPerSm)
    repro_adamw_update(const __grid_constant__ AdamwTable t, const AdamwHyper h) {
  const AdamwScalars s{*h.scale,       *h.lr, *h.b1c,         *h.b2c, h.b1,
                       h.one_minus_b1, h.b2,  h.one_minus_b2, h.eps,  h.wd};
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    const AdamwLeaf& L = t.leaf[leaf_of(t, c)];
    P* p = static_cast<P*>(L.p);
    const G* g = static_cast<const G*>(L.g);
    float* m = L.m;
    float* v = L.v;
    const long long lo = (long long)(c - L.chunk0) * kChunk;
    const long long hi = min(L.n, lo + kChunk);
    long long tail = lo;
    if (L.aligned) {
      tail = lo + (hi - lo) / kVec * kVec;
      for (long long i = lo + threadIdx.x * kVec; i < tail; i += kThreads * kVec) {
        float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
        load8(g + i, gf);
        load8(p + i, pf);
        load8(m + i, mf);
        load8(v + i, vf);
#pragma unroll
        for (int j = 0; j < kVec; ++j) pf[j] = adamw_entry(pf[j], gf[j], mf[j], vf[j], s);
        store8(p + i, pf);
        store8(m + i, mf);
        store8(v + i, vf);
      }
    }
    for (long long i = tail + threadIdx.x; i < hi; i += kThreads) {
      float mi = m[i], vi = v[i];
      p[i] = from_f<P>(adamw_entry(to_f<P>(p[i]), to_f<G>(g[i]), mi, vi, s));
      m[i] = mi;
      v[i] = vi;
    }
  }
}

// ------------------------------------------------------------------------- host

// One step's arguments.  `leaves` holds 7 numbers a leaf: the addresses of p, g, m and
// v, the entries, p's and g's dtype codes (0 = float32, 1 = bfloat16, 2 = float16);
// m and v are float32, all four contiguous and of one shape.  `partials` is float64
// scratch of `partials_len` (at least kSumsqBlocks) entries; `out` is float32 [norm,
// scale]; `lr`, `b1c` and `b2c` one float32 each on the card.  The floats are
// rounded from the caller's doubles, as PyTorch rounds a Python number in an operation
// on a float32 tensor.  `launched` is set to the kernels the step launched.
struct AdamwCall {
  const long long* leaves;
  void* partials;
  void* out;
  const void* lr;
  const void* b1c;
  const void* b2c;
  void* stream;
  int n_leaves;
  int partials_len;
  float b1;
  float one_minus_b1;
  float b2;
  float one_minus_b2;
  float eps;
  float weight_decay;
  float clip;
  int device;
  int launched;
};

namespace {

constexpr int kFields = 7;

template <typename G>
cudaError_t launch_sumsq(const AdamwTable& t, double* partials, int first, cudaStream_t st) {
  repro_adamw_sumsq<G><<<kSumsqBlocks, kThreads, 0, st>>>(t, partials, first);
  return cudaGetLastError();
}

template <typename P, typename G>
cudaError_t launch_update(const AdamwTable& t, const AdamwHyper& h, int sms, cudaStream_t st) {
  const int most = sms * kUpdateBlocksPerSm;
  repro_adamw_update<P, G><<<t.chunks < most ? t.chunks : most, kThreads, 0, st>>>(t, h);
  return cudaGetLastError();
}

cudaError_t sumsq(int gcode, const AdamwTable& t, double* partials, int first,
                  cudaStream_t st) {
  switch (gcode) {
    case 0: return launch_sumsq<float>(t, partials, first, st);
    case 1: return launch_sumsq<__nv_bfloat16>(t, partials, first, st);
    default: return launch_sumsq<__half>(t, partials, first, st);
  }
}

template <typename P>
cudaError_t update_p(int gcode, const AdamwTable& t, const AdamwHyper& h, int sms,
                     cudaStream_t st) {
  switch (gcode) {
    case 0: return launch_update<P, float>(t, h, sms, st);
    case 1: return launch_update<P, __nv_bfloat16>(t, h, sms, st);
    default: return launch_update<P, __half>(t, h, sms, st);
  }
}

cudaError_t update(int pcode, int gcode, const AdamwTable& t, const AdamwHyper& h, int sms,
                   cudaStream_t st) {
  switch (pcode) {
    case 0: return update_p<float>(gcode, t, h, sms, st);
    case 1: return update_p<__nv_bfloat16>(gcode, t, h, sms, st);
    default: return update_p<__half>(gcode, t, h, sms, st);
  }
}

}  // namespace

// Returns 0, a cudaError_t (> 0) from a launch, -2 for a dtype code it does not take,
// -6 for scratch under kSumsqBlocks entries.
extern "C" int repro_adamw_step(AdamwCall* c) {
  c->launched = 0;
  if (c->n_leaves <= 0) return 0;
  if (c->partials_len < kSumsqBlocks) return -6;
  for (int i = 0; i < c->n_leaves; ++i) {
    const long long pc = c->leaves[i * kFields + 5], gc = c->leaves[i * kFields + 6];
    if (pc < 0 || pc > 2 || gc < 0 || gc > 2) return -2;
  }
  DeviceGuard guard(c->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, c->device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  double* partials = static_cast<double*>(c->partials);
  float* out = static_cast<float*>(c->out);

  // the tables: per dtype pair in a fixed order, the leaves in the caller's order,
  // kMaxLeaves a table
  std::vector<AdamwTable> tables;
  std::vector<int> pairs;
  for (int pair = 0; pair < 9; ++pair) {
    AdamwTable* t = nullptr;
    for (int i = 0; i < c->n_leaves; ++i) {
      const long long* f = c->leaves + i * kFields;
      if (f[5] * 3 + f[6] != pair) continue;
      if (t == nullptr || t->leaves == kMaxLeaves) {
        tables.emplace_back();
        pairs.push_back(pair);
        t = &tables.back();
        t->leaves = 0;
        t->chunks = 0;
      }
      AdamwLeaf& L = t->leaf[t->leaves++];
      L.p = reinterpret_cast<void*>(f[0]);
      L.g = reinterpret_cast<const void*>(f[1]);
      L.m = reinterpret_cast<float*>(f[2]);
      L.v = reinterpret_cast<float*>(f[3]);
      L.n = f[4];
      L.chunk0 = t->chunks;
      L.aligned = ((f[0] | f[1] | f[2] | f[3]) & 15) == 0;
      t->chunks += (int)((f[4] + kChunk - 1) / kChunk);
    }
  }
  // every table's sums of squares into the same kSumsqBlocks slots, in table order
  for (size_t k = 0; k < tables.size() && e == cudaSuccess; ++k, ++c->launched)
    e = sumsq(pairs[k] % 3, tables[k], partials, k == 0, st);
  if (e != cudaSuccess) return (int)e;
  repro_adamw_scalars<<<1, kThreads, 0, st>>>(partials, out, c->clip);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++c->launched;
  const AdamwHyper h{out + 1, static_cast<const float*>(c->lr),
                     static_cast<const float*>(c->b1c), static_cast<const float*>(c->b2c),
                     c->b1, c->one_minus_b1, c->b2, c->one_minus_b2, c->eps, c->weight_decay};
  for (size_t k = 0; k < tables.size() && e == cudaSuccess; ++k)
    if (tables[k].chunks > 0) {
      e = update(pairs[k] / 3, pairs[k] % 3, tables[k], h, sms, st);
      ++c->launched;
    }
  return (int)e;
}
