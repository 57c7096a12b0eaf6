// Goldilocks field algebra on the card: the device code that stands where
// XLA fused aero_tpu's limb algebra (aero_tpu/field/jax_gl.py) under
// jax.jit. None of these has a Pallas counterpart; on the TPU they were
// compiled device programs, in the port they are four kernels:
//
//   K1 gl_elementwise   c = a + b, a - b, a * b mod p, or c = a^e for a
//                       host exponent e (square, pow_loop, the Fermat inv):
//                       jax_gl.add / sub / mul / pow_loop under jit.
//   K2 gl_scan_tiles /  inclusive prefix sum or product mod p along rows:
//      gl_scan_carry    lax.associative_scan(add / mul), jax_gl.py:312,
//                       :343, :490, :496 (batch_inv, gf_cumprod, gf_cumsum).
//   K3 gl_constraint_merge  the random linear combination of all constraint
//                       evaluations of one fragment: the merge of
//                       jax.jit(frag_fn), aero_tpu/prover/prover.py:407-429.
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
// but the result is written. K3 and K4 fold 140-odd and 89 rows into one
// output row without any temporary row; K2 writes each element once per
// level and carries block totals in a second, small pass. Inputs and
// outputs are canonical u64 bit patterns in [0, p) of int64 tensors,
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

constexpr int kScanItems = 8;                     // elements a thread
constexpr int kScanTile = kThreads * kScanItems;  // elements a block
constexpr int kWarps = kThreads / 32;

template <int OP>
__device__ __forceinline__ u64 scan_op(u64 a, u64 b) {
  return OP == kAdd ? gl_add(a, b) : gl_mul(a, b);
}

// Block (row, tile) scans elements tile*kScanTile .. of its row: loaded
// coalesced into shared memory, each thread scans its 8 consecutive
// elements, a warp-shuffle scan and one over the 8 warp totals give each
// thread its prefix, and the tile goes back out coalesced. The tile's total
// lands in totals[row * ntiles + tile]; past the row's end the identity
// stands in, so a ragged last tile needs no other care.
template <int OP>
__global__ void scan_tiles_kernel(const u64* __restrict__ in,
                                  u64* __restrict__ out,
                                  u64* __restrict__ totals, long long n,
                                  long long ntiles) {
  __shared__ u64 sm[kScanTile];
  __shared__ u64 warp_tot[kWarps];
  const long long row = blockIdx.x / ntiles;
  const long long tile = blockIdx.x % ntiles;
  const long long base = tile * kScanTile;
  const u64* src = in + row * n;
  u64* dst = out + row * n;
  const u64 id = OP == kAdd ? 0 : 1;

#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    const int k = q * kThreads + threadIdx.x;
    const long long j = base + k;
    sm[k] = j < n ? src[j] : id;
  }
  __syncthreads();

  u64 v[kScanItems];
  const int t0 = threadIdx.x * kScanItems;
  u64 acc = id;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    acc = scan_op<OP>(acc, sm[t0 + i]);
    v[i] = acc;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u64 x = acc;                       // inclusive scan of the warp's totals
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = scan_op<OP>(y, x);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    u64 w = lane < kWarps ? warp_tot[lane] : id;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const u64 y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w = scan_op<OP>(y, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  u64 xe = __shfl_up_sync(0xffffffffu, x, 1);   // exclusive within the warp
  if (lane == 0) xe = id;
  __syncthreads();
  const u64 pre = scan_op<OP>(warp ? warp_tot[warp - 1] : id, xe);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) sm[t0 + i] = scan_op<OP>(pre, v[i]);
  if (threadIdx.x == kThreads - 1) {
    totals[row * ntiles + tile] = sm[t0 + kScanItems - 1];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    const int k = q * kThreads + threadIdx.x;
    const long long j = base + k;
    if (j < n) dst[j] = sm[k];
  }
}

// Block (row, tile), tile >= 1: every element of the tile takes the scanned
// total of the tiles before it, carries[row * ntiles + tile - 1].
template <int OP>
__global__ void scan_carry_kernel(u64* __restrict__ out,
                                  const u64* __restrict__ carries,
                                  long long n, long long ntiles) {
  const long long row = blockIdx.x / (ntiles - 1);
  const long long tile = blockIdx.x % (ntiles - 1) + 1;
  const u64 c = carries[row * ntiles + tile - 1];
  u64* dst = out + row * n;
  const long long base = tile * kScanTile;
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    const int k = q * kThreads + threadIdx.x;
    const long long j = base + k;
    if (j < n) dst[j] = scan_op<OP>(c, dst[j]);
  }
}

// ------------------------------------------------------------------- K3

// tab holds device pointers, each to m elements of a row:
//   [0, T)         the transition evaluations ev_i
//   [T, 2T)        x^adj_i, the degree adjustment of term i
//   [2T, 2T+B)     the asserted columns col_j
//   [2T+B, 2T+2B)  x^adj_j of assertion j
//   [2T+2B, 2T+3B) 1 / (x - g^step_j), the boundary divisor's inverse
// cc_t (T, 2) and cc_b (B, 2) the composition coefficients, bvals (B,)
// the asserted values, zt the transition divisor's inverse:
//   out = zt * sum_i (cc_t[i,0] + x^adj_i cc_t[i,1]) ev_i
//       + sum_j (cc_b[j,0] + x^adj_j cc_b[j,1]) (col_j - b_j) dinv_j
__global__ void constraint_merge_kernel(const u64* const* __restrict__ tab,
                                        const u64* __restrict__ cc_t,
                                        const u64* __restrict__ cc_b,
                                        const u64* __restrict__ bvals,
                                        const u64* __restrict__ zt,
                                        u64* __restrict__ out, int T, int B,
                                        long long m) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < m;
       e += (long long)gridDim.x * blockDim.x) {
    u64 acc = 0;
#pragma unroll 1
    for (int i = 0; i < T; ++i) {
      const u64 k = gl_add(cc_t[2 * i], gl_mul(tab[T + i][e], cc_t[2 * i + 1]));
      acc = gl_add(acc, gl_mul(k, tab[i][e]));
    }
    acc = gl_mul(acc, zt[e]);
#pragma unroll 1
    for (int j = 0; j < B; ++j) {
      const u64 ev = gl_sub(tab[2 * T + j][e], bvals[j]);
      const u64 k = gl_add(cc_b[2 * j],
                           gl_mul(tab[2 * T + B + j][e], cc_b[2 * j + 1]));
      acc = gl_add(acc, gl_mul(gl_mul(k, ev), tab[2 * T + 2 * B + j][e]));
    }
    out[e] = acc;
  }
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

// in, out: rows x n contiguous; totals: rows x ntiles, ntiles = ceil(n /
// 2048). op 0 = sum, 2 = product.
extern "C" int gl_scan_tiles(const void* in, void* out, void* totals,
                             long long rows, long long n, long long ntiles,
                             int op, void* stream) {
  if (op != kAdd && op != kMul) return (int)cudaErrorInvalidValue;
  if (ntiles != (n + kScanTile - 1) / kScanTile)
    return (int)cudaErrorInvalidValue;
  const long long blocks = rows * ntiles;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == kAdd)
    scan_tiles_kernel<kAdd><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const u64*)in, (u64*)out, (u64*)totals, n, ntiles);
  else
    scan_tiles_kernel<kMul><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const u64*)in, (u64*)out, (u64*)totals, n, ntiles);
  return (int)cudaGetLastError();
}

// carries: rows x ntiles, the inclusive scan of the tile totals.
extern "C" int gl_scan_carry(void* out, const void* carries, long long rows,
                             long long n, long long ntiles, int op,
                             void* stream) {
  if (op != kAdd && op != kMul) return (int)cudaErrorInvalidValue;
  if (ntiles != (n + kScanTile - 1) / kScanTile)
    return (int)cudaErrorInvalidValue;
  const long long blocks = rows * (ntiles - 1);
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == kAdd)
    scan_carry_kernel<kAdd><<<(unsigned)blocks, kThreads, 0, s>>>(
        (u64*)out, (const u64*)carries, n, ntiles);
  else
    scan_carry_kernel<kMul><<<(unsigned)blocks, kThreads, 0, s>>>(
        (u64*)out, (const u64*)carries, n, ntiles);
  return (int)cudaGetLastError();
}

extern "C" int gl_constraint_merge(const void* tab, const void* cc_t,
                                   const void* cc_b, const void* bvals,
                                   const void* zt, void* out, int T, int B,
                                   long long m, void* stream) {
  if (T < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaSuccess;
  constraint_merge_kernel<<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const u64* const*)tab, (const u64*)cc_t, (const u64*)cc_b,
      (const u64*)bvals, (const u64*)zt, (u64*)out, T, B, m);
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
