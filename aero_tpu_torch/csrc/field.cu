// Goldilocks field algebra on the card: the device code that stands where
// XLA fused aero_tpu's limb algebra (aero_tpu/field/jax_gl.py) under
// jax.jit. None of these has a Pallas counterpart; on the TPU they were
// compiled device programs, in the port they are three kernels:
//
//   K1 gl_elementwise   c = a + b, a - b, a * b mod p, or c = a^e for a
//                       host exponent e (square, pow_loop, the Fermat inv):
//                       jax_gl.add / sub / mul / pow_loop under jit.
//   K2 gl_scan          inclusive prefix sum or product mod p along rows:
//                       lax.associative_scan(add / mul) under gf_cumprod
//                       and gf_cumsum, jax_gl.py:490, :496.
//      gl_batch_inv     1 / x along rows, Montgomery's trick: jax_gl.
//                       batch_inv (:309, its scans :312 and :343).
//   K4 gl_deep_combine  the DEEP quotient of one fragment as weighted
//                       column sums: _deep_core_jit, prover.py:556-589.
//
// What bounds them on this card: bytes. One gl_mul is about 40
// instructions, so an element that is read, combined once and written
// (24 B for K1's binary ops) takes far longer to move through HBM than to
// compute; the exception is K1's pow, about 2 log2(e) multiplies an
// element, which is bound by the integer pipes. The design answers with
// one pass over memory per call: every operand element is read once,
// coalesced (neighbouring threads on neighbouring elements), and nothing
// but the result is written. K4 folds 89 rows into one output row
// without any temporary row. K2's scan moves 16 B an element
// and does about two field operations an element, its batch inversion 24 B
// and about six; with the multiply's 25 integer-ALU instructions, a
// product scan's ALU time is about three fifths of its bytes' time and the
// inversion's exceeds them, so both hold K2 back. gl_scan is one pass,
// each tile of 4096 finding the combination of the tiles before it by a
// decoupled look-back at the values its predecessors published, instead
// of a second pass over the output; gl_batch_inv is one call of three
// launches that reads x twice and writes once, with one Fermat inverse a
// row (an addition chain), where the scans, flips, concatenations and
// products it replaces re-read the row a dozen times. Inputs and outputs
// are canonical u64 bit patterns in [0, p) of int64 tensors,
// reinterpreted, never converted.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks of 256 an SM

enum Op { kAdd = 0, kSub = 1, kMul = 2, kPow = 3 };

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// One operand of K1, element i of the output read at
//   kFull:    p[i]                      (same shape, contiguous)
//   kOne:     p[0]                      (a single element, e.g. a 0-d scalar)
//   kStrided: p[(i / d1) * s1 + (i % m0) * s0]
// kStrided is any broadcast or strided view that collapses to two dims
// (a row broadcast, a cyclic one, rows of a wider matrix); the wrapper
// (field/gl_cuda.py `operand_plan`) works d1, s1, m0, s0 out. The mode is a
// template argument, so each variant's loop holds only the path it runs.
enum Mode { kFull = 0, kOne = 1, kStrided = 2 };

struct Operand {
  const u64* p;
  long long d1, s1, m0, s0;
};

template <int MODE>
__device__ __forceinline__ u64 load(const Operand& o, long long i,
                                    bool small) {
  if (MODE == kFull) return o.p[i];
  if (MODE == kOne) return o.p[0];
  long long q, r;
  if (small) {   // 32-bit division where every index fits
    const unsigned ui = (unsigned)i;
    q = ui / (unsigned)o.d1;
    r = ui % (unsigned)o.m0;
  } else {
    q = i / o.d1;
    r = i % o.m0;
  }
  return o.p[q * o.s1 + r * o.s0];
}

// Square and multiply over the bits of e, low bit first: one trip a bit.
__device__ __forceinline__ u64 gl_pow(u64 x, u64 e) {
  u64 r = 1;
#pragma unroll 1
  for (; e; e >>= 1) {
    if (e & 1) r = gl_mul(r, x);
    if (e > 1) x = gl_mul(x, x);
  }
  return r;
}

template <int OP, int MA, int MB>
__global__ void elementwise_kernel(Operand a, Operand b, u64* __restrict__ c,
                                   long long n, u64 e) {
  const bool small = n <= 0xffffffffLL;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const u64 x = load<MA>(a, i, small);
    u64 r;
    if constexpr (OP == kPow) {
      r = gl_pow(x, e);
    } else {
      const u64 y = load<MB>(b, i, small);
      r = OP == kAdd ? gl_add(x, y) : OP == kSub ? gl_sub(x, y) : gl_mul(x, y);
    }
    c[i] = r;
  }
}

template <int OP, int MA, int MB>
void launch_elementwise(const Operand& a, const Operand& b, u64* c,
                        long long n, u64 e, cudaStream_t s) {
  elementwise_kernel<OP, MA, MB><<<grid_for(n), kThreads, 0, s>>>(a, b, c, n,
                                                                  e);
}

// The variant of (mode of a, mode of b); false for a mode out of range.
template <int OP, int MA>
bool launch_mode_b(int mb, const Operand& a, const Operand& b, u64* c,
                   long long n, u64 e, cudaStream_t s) {
  switch (mb) {
    case kFull:
      launch_elementwise<OP, MA, kFull>(a, b, c, n, e, s);
      return true;
    case kOne:
      launch_elementwise<OP, MA, kOne>(a, b, c, n, e, s);
      return true;
    case kStrided:
      launch_elementwise<OP, MA, kStrided>(a, b, c, n, e, s);
      return true;
  }
  return false;
}

template <int OP>
bool launch_modes(int ma, int mb, const Operand& a, const Operand& b, u64* c,
                  long long n, u64 e, cudaStream_t s) {
  if constexpr (OP == kPow) {   // one operand: b is not read
    switch (ma) {
      case kFull:
        launch_elementwise<OP, kFull, kOne>(a, b, c, n, e, s);
        return true;
      case kOne:
        launch_elementwise<OP, kOne, kOne>(a, b, c, n, e, s);
        return true;
      case kStrided:
        launch_elementwise<OP, kStrided, kOne>(a, b, c, n, e, s);
        return true;
    }
  } else {
    switch (ma) {
      case kFull: return launch_mode_b<OP, kFull>(mb, a, b, c, n, e, s);
      case kOne: return launch_mode_b<OP, kOne>(mb, a, b, c, n, e, s);
      case kStrided: return launch_mode_b<OP, kStrided>(mb, a, b, c, n, e, s);
    }
  }
  return false;
}

// ------------------------------------------------------------------- K2

constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 16;                    // elements a thread, gl_scan
constexpr int kScanTile = kThreads * kScanItems;  // elements a tile, gl_scan
constexpr int kInvItems = 8;                      // the same, gl_batch_inv
constexpr int kInvTile = kThreads * kInvItems;

// The shared-memory slot of element k of a tile: one pad word after every
// 16 elements. A half-warp then meets 16 distinct banks both where thread
// t takes its run k = ITEMS t + i (ITEMS 8 or 16) and where lane l loads
// k = 256 q + l.
__device__ __forceinline__ int slot(int k) { return k + (k >> 4); }

template <int OP>
__device__ __forceinline__ u64 scan_op(u64 a, u64 b) {
  return OP == kAdd ? gl_add(a, b) : gl_mul(a, b);
}

template <int OP>
__device__ __forceinline__ u64 identity() {
  return OP == kAdd ? 0 : 1;
}

// Elements base .. base + kThreads * ITEMS of a row of n into shared
// memory, coalesced; the identity stands in past the row's end.
template <int OP, int ITEMS>
__device__ __forceinline__ void load_tile(u64* sm, const u64* __restrict__ src,
                                          long long base, long long n) {
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int k = q * kThreads + threadIdx.x;
    const long long j = base + k;
    sm[slot(k)] = j < n ? src[j] : identity<OP>();
  }
}

template <int ITEMS>
__device__ __forceinline__ void store_tile(const u64* sm, u64* __restrict__ dst,
                                           long long base, long long n) {
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int k = q * kThreads + threadIdx.x;
    const long long j = base + k;
    if (j < n) dst[j] = sm[slot(k)];
  }
}

// The combination of the values of every thread before this one (REVERSE:
// after it), and the block's total in *total. Every thread of the block
// calls it; two barriers.
template <int OP, bool REVERSE>
__device__ __forceinline__ u64 block_exclusive(u64 v, u64* total) {
  __shared__ u64 warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = REVERSE ? 0 : 31;            // the lane holding the total
  u64 x = v;                                     // inclusive within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 y = REVERSE ? __shfl_down_sync(0xffffffffu, x, off)
                          : __shfl_up_sync(0xffffffffu, x, off);
    if (REVERSE ? lane + off < 32 : lane >= off) x = scan_op<OP>(y, x);
  }
  if (lane == first) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    u64 w = lane < kWarps ? warp_tot[lane] : identity<OP>();
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const u64 y = REVERSE ? __shfl_down_sync(0xffffffffu, w, off)
                            : __shfl_up_sync(0xffffffffu, w, off);
      if (REVERSE ? lane + off < kWarps : lane >= off) w = scan_op<OP>(y, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  u64 xe = REVERSE ? __shfl_down_sync(0xffffffffu, x, 1)
                   : __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 31 - first) xe = identity<OP>();
  __syncthreads();
  *total = warp_tot[REVERSE ? 0 : kWarps - 1];
  const int other = REVERSE ? warp + 1 : warp - 1;
  return scan_op<OP>(other >= 0 && other < kWarps ? warp_tot[other]
                                                  : identity<OP>(), xe);
}

// A tile's status in the chained scan lives in its two value words,
// aggregate and inclusive prefix (the combination of its row up to its
// end), each kNotYet until published. A canonical value is below p, so the
// all-ones word never is one. Merrill and Garland keep a flag beside the
// value, published after it behind a fence, and read before it; here the
// value is the whole message: a 64-bit aligned store is seen whole or not
// at all (single-copy atomic, both sides relaxed at GPU scope, never the
// non-coherent L1), so a reader needs one round of loads and no fence.
constexpr u64 kNotYet = ~0ULL;

__device__ __forceinline__ u64 load_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The exclusive prefix of global tile t, the tile-th of its row, whose own
// aggregate is agg: warp 0 publishes agg, then reads its predecessors'
// statuses 32 at a time, nearest first, and folds them up to and including
// the nearest inclusive prefix (the row's first tile publishes only that),
// and publishes its own inclusive prefix. Every predecessor holds an
// earlier ticket, so it is running or done and publishes its aggregate
// without waiting: the spin ends. A lane that finds nothing yet sleeps
// 32 ns, doubling to 1 us, between reads, which keeps the spinning warps
// off the memory system the working ones need.
template <int OP>
__device__ __forceinline__ u64 look_back(u64* agg_val, u64* pre_val,
                                         long long t, long long tile, u64 agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_relaxed(&pre_val[t], agg);
    return identity<OP>();
  }
  if (lane == 0) store_relaxed(&agg_val[t], agg);
  const long long first = t - tile;              // the row's first tile
  u64 excl = identity<OP>();
  for (long long top = t - 1;; top -= 32) {
    const long long j = top - lane;
    bool prefix = true;                          // before the row: identity
    u64 v = identity<OP>();
    if (j >= first) {
      u64 p = load_relaxed(&pre_val[j]), a = load_relaxed(&agg_val[j]);
      for (unsigned ns = 32; p == kNotYet && a == kNotYet;
           ns = ns < 1024 ? 2 * ns : ns) {
        __nanosleep(ns);
        p = load_relaxed(&pre_val[j]);
        a = load_relaxed(&agg_val[j]);
      }
      prefix = p != kNotYet;
      v = prefix ? p : a;
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, prefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    if (lane > stop) v = identity<OP>();
#pragma unroll
    for (int off = 16; off; off >>= 1)
      v = scan_op<OP>(v, __shfl_xor_sync(0xffffffffu, v, off));
    excl = scan_op<OP>(excl, v);
    if (prefixes) break;
  }
  if (lane == 0) store_relaxed(&pre_val[t], scan_op<OP>(excl, agg));
  return excl;
}

// The inclusive scan of rows of n, one tile of kScanTile a block, in one
// pass (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016). A block takes its tile from the ticket
// (*ticket + 1, the word starts all ones), so tile t starts only after
// every tile before it; tile t is the (t % ntiles)-th of row t / ntiles.
// The tile is scanned in shared memory (each thread's run of 16, then
// across threads), warp 0 looks back for the tile's exclusive prefix, and
// each element is read once and written once. The caller sets the ticket
// and agg_val, pre_val (a word a tile each) to all ones.
template <int OP>
__global__ void __launch_bounds__(kThreads)
chained_scan_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                    unsigned* ticket, u64* agg_val, u64* pre_val, long long n,
                    long long ntiles) {
  __shared__ u64 sm[kScanTile + kScanTile / 16];
  __shared__ long long s_ticket;
  __shared__ u64 s_excl;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u) + 1u;
  __syncthreads();
  const long long t = s_ticket;
  const long long row = t / ntiles, tile = t % ntiles;
  const long long base = tile * kScanTile;
  load_tile<OP, kScanItems>(sm, in + row * n, base, n);
  __syncthreads();

  u64 v[kScanItems];
  const int t0 = threadIdx.x * kScanItems;
  u64 acc = identity<OP>();
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    acc = scan_op<OP>(acc, sm[slot(t0 + i)]);
    v[i] = acc;
  }
  u64 agg;
  const u64 pre = block_exclusive<OP, false>(acc, &agg);
  if (threadIdx.x < 32) {
    const u64 excl = look_back<OP>(agg_val, pre_val, t, tile, agg);
    if (threadIdx.x == 0) s_excl = excl;
  }
  __syncthreads();
  const u64 p = scan_op<OP>(s_excl, pre);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) sm[slot(t0 + i)] = scan_op<OP>(p, v[i]);
  __syncthreads();
  store_tile<kScanItems>(sm, out + row * n, base, n);
}

// Words of u64 scratch that gl_scan needs for `tiles` tiles: the ticket,
// then a tile's aggregate and inclusive prefix (field/gl_cuda.py
// `scan_scratch_words` says the same).
long long scan_scratch_words(long long tiles) { return 1 + 2 * tiles; }

// ---------------------------------------------- K2's batch inversion
//
// 1 / x_i along rows of n, Montgomery's trick in three launches over tiles
// of kInvTile: (a) each tile's product; (b) a block a row: for tile k, the
// factor F_k = (product of the tiles before k) (product of those after k)
// / (the row's product), one Fermat inverse a row; (c) each tile again:
// out_i = F_k (product of the tile's elements before i) (those after i).
// A zero in a row makes its product 0, whose "inverse" 0^(p-2) is 0: the
// whole row comes out 0, the rule of jax_gl.batch_inv.

// x^(p-2) by an addition chain, p - 2 = (2^32 - 2) 2^32 + 2^32 - 1: 63
// squarings and 9 multiplies, 71 in sequence where the square-and-multiply
// loop of gl_pow takes 127.
__device__ __forceinline__ u64 gl_inv(u64 x) {
  auto sq = [](u64 a, int k) {
    for (int i = 0; i < k; ++i) a = gl_mul(a, a);
    return a;
  };
  const u64 t2 = gl_mul(gl_mul(x, x), x);        // x^(2^2 - 1)
  const u64 t3 = gl_mul(sq(t2, 1), x);           // x^(2^3 - 1)
  const u64 t6 = gl_mul(sq(t3, 3), t3);
  const u64 t12 = gl_mul(sq(t6, 6), t6);
  const u64 t24 = gl_mul(sq(t12, 12), t12);
  const u64 t30 = gl_mul(sq(t24, 6), t6);
  const u64 t31 = gl_mul(sq(t30, 1), x);         // x^(2^31 - 1)
  const u64 u = gl_mul(t31, t31);                // x^(2^32 - 2)
  return gl_mul(sq(u, 32), gl_mul(u, x));
}

// (a) block (row, tile): tile_prod[row * ntiles + tile]. The product does
// not depend on the order: each thread loads its 8 elements first, then
// multiplies them as a tree, then across the warp and the block.
__global__ void __launch_bounds__(kThreads)
tile_products_kernel(const u64* __restrict__ in, u64* __restrict__ tile_prod,
                     long long n, long long ntiles) {
  const long long row = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const u64* src = in + row * n;
  const long long base = tile * kInvTile;
  u64 x[kInvItems];
#pragma unroll
  for (int q = 0; q < kInvItems; ++q) {
    const long long j = base + q * kThreads + threadIdx.x;
    x[q] = j < n ? src[j] : 1;
  }
#pragma unroll
  for (int w = kInvItems / 2; w; w >>= 1)
#pragma unroll
    for (int q = 0; q < w; ++q) x[q] = gl_mul(x[q], x[q + w]);
  u64 acc = x[0];
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc = gl_mul(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  __shared__ u64 warp_prod[kWarps];
  if ((threadIdx.x & 31) == 0) warp_prod[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    u64 p = threadIdx.x < kWarps ? warp_prod[threadIdx.x] : 1;
#pragma unroll
    for (int off = kWarps / 2; off; off >>= 1)
      p = gl_mul(p, __shfl_xor_sync(0xffffffffu, p, off));
    if (threadIdx.x == 0) tile_prod[blockIdx.x] = p;
  }
}

// (b) block `row`: factor[row * ntiles + k] = F_k. Thread t takes the run
// of c = ceil(ntiles / kThreads) tile products from t * c.
__global__ void __launch_bounds__(kThreads)
row_factors_kernel(const u64* __restrict__ tile_prod, u64* __restrict__ factor,
                   long long ntiles) {
  const u64* tp = tile_prod + blockIdx.x * ntiles;
  u64* f = factor + blockIdx.x * ntiles;
  const long long c = (ntiles + kThreads - 1) / kThreads;
  const long long lo = min(ntiles, threadIdx.x * c), hi = min(ntiles, lo + c);
  u64 own = 1;
  for (long long k = lo; k < hi; ++k) own = gl_mul(own, tp[k]);
  u64 total;
  const u64 before = block_exclusive<kMul, false>(own, &total);
  const u64 after = block_exclusive<kMul, true>(own, &total);
  __shared__ u64 s_inv;
  if (threadIdx.x == 0) s_inv = gl_inv(total);
  __syncthreads();
  u64 acc = gl_mul(after, s_inv);      // backward: what follows tile k
  for (long long k = hi - 1; k >= lo; --k) {
    f[k] = acc;
    acc = gl_mul(acc, tp[k]);
  }
  acc = before;                        // forward: what precedes tile k
  for (long long k = lo; k < hi; ++k) {
    f[k] = gl_mul(f[k], acc);
    acc = gl_mul(acc, tp[k]);
  }
}

// (c) block (row, tile): out = F_tile * (the elements before i) * (those
// after i) within the tile. Thread t's run of 8: e_i, the product of its
// elements before i (forward), then, from its end, out_i = e_i * g with g
// the product of F_tile, the threads before and after it, and its own
// elements after i (backward). At most 64 registers a thread, four blocks
// an SM.
__global__ void __launch_bounds__(kThreads, 4)
batch_inv_apply_kernel(const u64* __restrict__ in,
                       const u64* __restrict__ factor, u64* __restrict__ out,
                       long long n, long long ntiles) {
  __shared__ u64 sm[kInvTile + kInvTile / 16];
  const long long row = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const long long base = tile * kInvTile;
  load_tile<kMul, kInvItems>(sm, in + row * n, base, n);
  __syncthreads();
  const int t0 = threadIdx.x * kInvItems;
  u64 x[kInvItems], e[kInvItems];
  u64 acc = 1;
#pragma unroll
  for (int i = 0; i < kInvItems; ++i) {
    x[i] = sm[slot(t0 + i)];
    e[i] = acc;
    acc = gl_mul(acc, x[i]);
  }
  u64 total;
  const u64 before = block_exclusive<kMul, false>(acc, &total);
  const u64 after = block_exclusive<kMul, true>(acc, &total);
  u64 g = gl_mul(gl_mul(factor[blockIdx.x], before), after);
#pragma unroll
  for (int i = kInvItems - 1; i >= 0; --i) {
    sm[slot(t0 + i)] = gl_mul(e[i], g);
    g = gl_mul(g, x[i]);
  }
  __syncthreads();
  store_tile<kInvItems>(sm, out + row * n, base, n);
}

// ------------------------------------------------------------------- K4

// Rows r of a (w, ld) matrix at column e: sum_r (L[r] - v[r]) wt[r], and
// with v2 / wt2 the second sum over the same reads.
__device__ __forceinline__ void deep_rows(const u64* __restrict__ L,
                                          long long ld, int w, long long e,
                                          const u64* __restrict__ v,
                                          const u64* __restrict__ wt,
                                          const u64* __restrict__ v2,
                                          const u64* __restrict__ wt2,
                                          u64& s, u64& s2) {
#pragma unroll 1
  for (int r = 0; r < w; ++r) {
    const u64 x = L[r * ld + e];
    s = gl_add(s, gl_mul(gl_sub(x, v[r]), wt[r]));
    s2 = gl_add(s2, gl_mul(gl_sub(x, v2[r]), wt2[r]));
  }
}

__global__ void deep_combine_kernel(
    const u64* __restrict__ main_, long long ld_main, int w_main,
    const u64* __restrict__ aux, long long ld_aux, int w_aux,
    const u64* __restrict__ comp, long long ld_comp, int w_comp,
    const u64* __restrict__ cur, const u64* __restrict__ nxt,
    const u64* __restrict__ ood, const u64* __restrict__ a,
    const u64* __restrict__ b, const u64* __restrict__ c,
    const u64* __restrict__ dinv, long long ld_dinv,
    const u64* __restrict__ x, const u64* __restrict__ lam,
    const u64* __restrict__ mu, u64* __restrict__ out, long long m) {
  const u64 lam_v = *lam, mu_v = *mu;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < m;
       e += (long long)gridDim.x * blockDim.x) {
    u64 nc = 0, nn = 0, nk = 0;
    deep_rows(main_, ld_main, w_main, e, cur, a, nxt, b, nc, nn);
    deep_rows(aux, ld_aux, w_aux, e, cur + w_main, a + w_main, nxt + w_main,
              b + w_main, nc, nn);
#pragma unroll 1
    for (int r = 0; r < w_comp; ++r) {
      nk = gl_add(nk, gl_mul(gl_sub(comp[r * ld_comp + e], ood[r]), c[r]));
    }
    u64 d = gl_add(gl_mul(nc, dinv[e]), gl_mul(nn, dinv[ld_dinv + e]));
    d = gl_add(d, gl_mul(nk, dinv[2 * ld_dinv + e]));
    out[e] = gl_mul(d, gl_add(lam_v, gl_mul(x[e], mu_v)));
  }
}

}  // namespace

extern "C" int gl_elementwise(const void* a, int a_mode, long long a_d1,
                              long long a_s1, long long a_m0, long long a_s0,
                              const void* b, int b_mode, long long b_d1,
                              long long b_s1, long long b_m0, long long b_s0,
                              void* c, long long n, int op,
                              unsigned long long e, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Operand A{(const u64*)a, a_d1, a_s1, a_m0, a_s0};
  const Operand B{(const u64*)b, b_d1, b_s1, b_m0, b_s0};
  cudaStream_t s = (cudaStream_t)stream;
  u64* C = (u64*)c;
  bool ok = false;
  switch (op) {
    case kAdd: ok = launch_modes<kAdd>(a_mode, b_mode, A, B, C, n, e, s); break;
    case kSub: ok = launch_modes<kSub>(a_mode, b_mode, A, B, C, n, e, s); break;
    case kMul: ok = launch_modes<kMul>(a_mode, b_mode, A, B, C, n, e, s); break;
    case kPow: ok = launch_modes<kPow>(a_mode, b_mode, A, B, C, n, e, s); break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// in, out: rows x n contiguous; op 0 = sum, 2 = product; scratch of
// scan_scratch_words(rows * ceil(n / 4096)) words. One memset of the
// scratch to all ones on the stream, then one launch.
extern "C" int gl_scan(const void* in, void* out, void* scratch,
                       long long scratch_words, long long rows, long long n,
                       int op, void* stream) {
  if (op != kAdd && op != kMul) return (int)cudaErrorInvalidValue;
  if (rows < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + kScanTile - 1) / kScanTile;
  const long long tiles = rows * ntiles;
  if (tiles == 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL || scratch_words < scan_scratch_words(tiles))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  u64* words = (u64*)scratch;
  const cudaError_t e = cudaMemsetAsync(
      words, 0xff, (size_t)scan_scratch_words(tiles) * sizeof(u64), s);
  if (e != cudaSuccess) return (int)e;
  unsigned* ticket = (unsigned*)words;
  u64* agg_val = words + 1;
  u64* pre_val = agg_val + tiles;
  if (op == kAdd)
    chained_scan_kernel<kAdd><<<(unsigned)tiles, kThreads, 0, s>>>(
        (const u64*)in, (u64*)out, ticket, agg_val, pre_val, n, ntiles);
  else
    chained_scan_kernel<kMul><<<(unsigned)tiles, kThreads, 0, s>>>(
        (const u64*)in, (u64*)out, ticket, agg_val, pre_val, n, ntiles);
  return (int)cudaGetLastError();
}

// in, out: rows x n contiguous; scratch: 2 * rows * ceil(n / 2048) words
// (the tile products, then the tile factors). Three launches.
extern "C" int gl_batch_inv(const void* in, void* out, void* scratch,
                            long long scratch_words, long long rows,
                            long long n, void* stream) {
  if (rows < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + kInvTile - 1) / kInvTile;
  const long long tiles = rows * ntiles;
  if (tiles == 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL || scratch_words < 2 * tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  u64* tile_prod = (u64*)scratch;
  u64* factor = tile_prod + tiles;
  tile_products_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      (const u64*)in, tile_prod, n, ntiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  row_factors_kernel<<<(unsigned)rows, kThreads, 0, s>>>(tile_prod, factor,
                                                         ntiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  batch_inv_apply_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      (const u64*)in, factor, (u64*)out, n, ntiles);
  return (int)cudaGetLastError();
}

extern "C" int gl_deep_combine(
    const void* main_, long long ld_main, int w_main, const void* aux,
    long long ld_aux, int w_aux, const void* comp, long long ld_comp,
    int w_comp, const void* cur, const void* nxt, const void* ood,
    const void* a, const void* b, const void* c, const void* dinv,
    long long ld_dinv, const void* x, const void* lam, const void* mu,
    void* out, long long m, void* stream) {
  if (w_main < 0 || w_aux < 0 || w_comp < 0) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaSuccess;
  deep_combine_kernel<<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)main_, ld_main, w_main, (const u64*)aux, ld_aux, w_aux,
      (const u64*)comp, ld_comp, w_comp, (const u64*)cur, (const u64*)nxt,
      (const u64*)ood, (const u64*)a, (const u64*)b, (const u64*)c,
      (const u64*)dinv, ld_dinv, (const u64*)x, (const u64*)lam,
      (const u64*)mu, (u64*)out, m);
  return (int)cudaGetLastError();
}
