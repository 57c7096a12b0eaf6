// Goldilocks column NTT: one pass of the two- or three-pass (4-step)
// transform, and the first pass of a coset LDE read from its coefficients.
//
// Replaces the TPU kernel aero_tpu/ntt/ntt_pallas.py `_colntt`
// (`_make_colntt_kernel_reshape` :131 and `_make_colntt_kernel_roll` :172,
// which differ only in how the TPU moves data between vector slots).
// A block takes a tile of L rows x TC columns of a (B, L, C) view of the
// data and runs a size-L decimation-in-time NTT down each column: rows are
// read bit-reversed, and on the way out every element is multiplied by an
// optional cross-twiddle table (the 4-step's w^(j1*k2), 1/n folded in for
// the inverse). Row, column and batch strides are arguments, so pass 2
// reads the pass-1 output transposed and writes the natural-order result,
// and the last pass of a three-pass transform (n > 2^24) takes its columns
// across the outermost axis.
//
// What bounds it on this card: the ALU pipe. A butterfly is a Goldilocks
// add and subtract and, unless its twiddle is 1, a multiply, against 8
// bytes of device memory an element a pass; Hopper has no 64-bit
// multiplier, and the multiply's carries and the reductions run on the
// integer ALU. The design keeps that arithmetic short and everything else
// off the ALU:
//   - Lazy words inside a pass. From its load to its store a value is held
//     as any 64-bit word congruent to it mod p, not as its canonical
//     residue: the butterflies, a step's pre-twiddles, the LDE entry's
//     offset scaling and the cross multiply take gl_add_lazy, gl_sub_lazy
//     and gl_mul_lazy (goldilocks.cuh), which leave out the compare,
//     subtract and select of every canonicalisation, and shared memory
//     holds lazy words between steps. Any word is a valid input to them and
//     none can overflow, however long the chain: each corrects a carry or
//     borrow of 2^64 by EPS = 2^64 mod p, and the one carry or borrow that
//     correction can make, which cannot recur (goldilocks.cuh shows why).
//     A word is made canonical once, by one gl_canon, where it is stored to
//     device memory (`store_out`: a pass's output, so also the buffer
//     between passes), so every tensor a launch writes holds values in
//     [0, p) as before. The transform's operations are the same ones, so
//     the work and the results are exactly the same; a butterfly takes some
//     23 ALU instructions in place of the canonical forms' 40 (the field-op
//     probe, csrc/probe/field_ops.cu).
//   - Radix-16 steps in registers. log2(L) = r1 + 4 + 4 + ..., r1 <= 4.
//     Each thread holds the 2^r elements of a group and runs r radix-2
//     stages on them in registers; elements cross threads through shared
//     memory only between steps: a 4096-point column takes three steps and
//     two barriers, and no butterfly computes an index or loads a twiddle.
//   - A step after the first multiplies element m of group (hi, lo) by
//     w_T^(rev(m) * lo), T the size the step completes, read from one table
//     of w_L^e (e < L), then runs a 2^r-point DFT whose twiddles, roots of
//     order <= 16, sit in registers. A multiply by 1 (m = 0, lo = 0, the
//     first butterfly of every block) is not made, so the kernel multiplies
//     exactly where a radix-2 transform has a twiddle other than 1.
//   - Wide tiles: L x TC with L * TC up to 2^14 (128 KB of dynamic shared
//     memory, kLogMaxTile); the wrapper takes 2^13 where C allows (64 KB,
//     two blocks an SM at up to 128 registers a thread, three for the LDE
//     entry at up to 80, which ran it faster on an H100; a transform's pass
//     of 4096 rows ran slower at three): at L = 2048 a row of a
//     tile is four columns, one 32-byte sector; at 4096 two, whose half
//     sectors meet the neighbouring tile's in L2, since neighbouring tiles
//     run together. Of tiles of 2^12, 2^13 and 2^14 elements, 2^13 ran the
//     72 x 2^23 transform fastest on an H100: at 2^14 an SM holds one
//     block, at 2^12 a tile row at L = 4096 is one column.
//   - Shared memory in an XOR swizzle (`swz`): the low 4 - log2(TC) bits of
//     a row position are XORed with the fold of its higher bits. A warp's
//     accesses at any step, the bit-reversed first step included, fall on
//     distinct banks; the swizzle is linear, so a group's 16 offsets come
//     from 4 per-step values by XOR.
//   - The LDE entry (`gl_colntt_lde`) is the first pass of the transform of
//     the zero-padded, offset-scaled coefficients without the padding: it
//     reads the n coefficients where they lie, multiplies coefficient i by
//     offset^i (a column table times a row table, made once on the card),
//     and skips the first z stages of its first step, which only copy: at
//     blowup 2^b the nonzero rows of the padded (L, C) matrix are the first
//     L / 2^b, so after the bit-reversed load each group's 2^r inputs hold
//     2^(r - b) values. No zero is read, written or added.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kLogMaxTile = 14;   // L * TC <= 16384 u64 = 128 KB
constexpr int kThreads = 256;

struct Pass {
  const u64* in;        // the pass input; the coefficients for the LDE
  u64* out;
  const u64* tw;        // w_L^e, e < L
  const u64* cross;     // nullptr or read at row * cross_ld + column
  const u64* rowpow;    // LDE: offset^(C * row)
  const u64* colpow;    // LDE: offset^column
  long long C, in_sb, in_sr, in_sc, out_sb, out_sr, out_sc, cross_ld;
  long long n;          // LDE: coefficients a batch row
  int log_L, log_TC;
  int z;                // LDE: leading stages of the first step that copy
};

// bit-reversal of the low `bits` bits of x (bits may be 0)
__device__ __forceinline__ unsigned rev_bits(unsigned x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

// the same for a compile-time m (a loop, not a recursion, so that it folds
// to a constant once the caller's loop over m is unrolled)
__host__ __device__ constexpr int rev_c(int m, int r) {
  int q = 0;
  for (int i = 0; i < r; ++i) q |= ((m >> i) & 1) << (r - 1 - i);
  return q;
}

// the swizzled slot of row position p: its low k bits XOR the fold (XOR of
// the k-bit chunks) of the bits above; k = 4 - log2(TC), at most 4
__device__ __forceinline__ unsigned swz(unsigned p, int k) {
  if (k <= 0) return p;
  unsigned f = 0;
  for (unsigned h = p >> k; h; h >>= k) f ^= h;
  return p ^ (f & ((1u << k) - 1));
}

// stage t of the 2^r-point DFT of a[] in place: butterflies (k0 + j,
// k0 + j + 2^t), twiddle w_(2^(t+1))^j = w[j * R / 2^(t+1)]; none for j = 0
template <int r, int t>
__device__ __forceinline__ void dft_stage(u64 (&a)[1 << r], const u64* w) {
  constexpr int R = 1 << r, half = 1 << t;
#pragma unroll
  for (int k0 = 0; k0 < R; k0 += 2 * half) {
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const u64 u = a[k0 + j];
      u64 v = a[k0 + j + half];
      if (j) v = gl_mul_lazy(v, w[j * (R >> (t + 1))]);
      a[k0 + j] = gl_add_lazy(u, v);
      a[k0 + j + half] = gl_sub_lazy(u, v);
    }
  }
}

// the 2^r-point DFT of a[] in place: slot m holds input rev_r(m), slot k
// gets output k; w[e] = w_R^e. The first z stages only copy (their odd
// inputs are zero) and are left out: `replicate` has spread the values.
// Each stage is its own instance, so that every loop has a constant count
// and a[] stays in registers.
template <int r, int t = 0>
__device__ __forceinline__ void dft(u64 (&a)[1 << r], const u64* w, int z) {
  if constexpr (t < r) {
    if (t >= z) dft_stage<r, t>(a, w);
    dft<r, t + 1>(a, w, z);
  }
}

// the copies of the first z stages: slot m takes slot m with its low z bits
// cleared, the only nonzero input of its block of 2^z
template <int r>
__device__ __forceinline__ void replicate(u64 (&a)[1 << r], int z) {
  constexpr int R = 1 << r;
#define AERO_REPLICATE(Z)                                           \
  case Z:                                                          \
    _Pragma("unroll") for (int m = 0; m < R; ++m) if (m & ((1 << Z) - 1)) \
      a[m] = a[m & ~((1 << Z) - 1)];                               \
    break;
  switch (z) {
    AERO_REPLICATE(1)
    AERO_REPLICATE(2)
    AERO_REPLICATE(3)
    AERO_REPLICATE(4)
    default:
      break;
  }
#undef AERO_REPLICATE
}

struct Tile {
  long long b, c0;
  int lg, ltc, L, TC, k;   // k: swizzle bits
};

__device__ __forceinline__ Tile tile_of(const Pass& p) {
  Tile t;
  t.lg = p.log_L;
  t.ltc = p.log_TC;
  t.L = 1 << t.lg;
  t.TC = 1 << t.ltc;
  // neighbouring column tiles run together: their partial sectors of a
  // row meet in L2 (an order with the batch index fastest ran pass 2
  // slower)
  const long long tiles = p.C >> t.ltc;
  t.b = blockIdx.x / tiles;
  t.c0 = (blockIdx.x % tiles) << t.ltc;
  t.k = 4 - t.ltc;
  return t;
}

// the byte offset in shared memory of row position p, column c
__device__ __forceinline__ unsigned slot(const Tile& t, unsigned p, int c) {
  return ((swz(p, t.k) << t.ltc) | (unsigned)c) << 3;
}

// output row `row`, column c: times the cross table's element where there
// is one, read here rather than held through the DFT, then made canonical,
// the one canonicalisation a value gets between its load and its store
template <bool kCross>
__device__ __forceinline__ void store_out(const Pass& p, const Tile& t,
                                          long long row, int c, u64 v) {
  if (kCross)
    v = gl_mul_lazy(v, __ldg(p.cross + row * p.cross_ld + t.c0 + c));
  p.out[t.b * p.out_sb + row * p.out_sr + (t.c0 + c) * p.out_sc] =
      gl_canon(v);
}

// The first step: a group reads rows g + q * L/R of its column (q < R, or
// q < R >> z for the LDE), slot rev_r(q), runs the DFT and writes its R
// outputs to row positions hi * R + m, hi = rev(g), in shared memory, or,
// when this is the only step (L = R), to the output rows m.
template <int r, bool kLde, bool kCross>
__device__ __forceinline__ void first_step(const Pass& p, const Tile& t,
                                           u64* sm, bool only) {
  constexpr int R = 1 << r;
  const int lgr = t.lg - r;
  u64 w[R / 2 > 1 ? R / 2 : 1];
#pragma unroll
  for (int e = 1; e < R / 2; ++e) w[e] = __ldg(p.tw + (e << lgr));
  const int z = kLde ? p.z : 0;
  const int nq = R >> z;
  const int groups = (t.L >> r) << t.ltc;
  unsigned xo[R];                 // swizzled offset of row position m
#pragma unroll
  for (int m = 0; m < R; ++m) xo[m] = slot(t, m, 0);
  for (int gam = threadIdx.x; gam < groups; gam += blockDim.x) {
    const int c = gam & (t.TC - 1);
    const int g = gam >> t.ltc;
    u64 a[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int q = rev_c(m, r);
      if (q >= nq) continue;
      const long long row = g + ((long long)q << lgr);
      if (kLde) {
        const long long i = row * p.C + t.c0 + c;
        a[m] = i < p.n ? gl_mul_lazy(
                             gl_mul_lazy(__ldg(p.in + t.b * p.n + i),
                                         __ldg(p.colpow + t.c0 + c)),
                             __ldg(p.rowpow + row))
                       : 0;
      } else {
        a[m] = __ldg(p.in + t.b * p.in_sb + row * p.in_sr +
                     (t.c0 + c) * p.in_sc);
      }
    }
    if (kLde) replicate<r>(a, z);
    if (only) {
      dft<r>(a, w, z);
#pragma unroll
      for (int m = 0; m < R; ++m) store_out<kCross>(p, t, m, c, a[m]);
    } else {
      dft<r>(a, w, z);
      const unsigned hi = rev_bits((unsigned)g, lgr);
      // swz is linear and hi * R, m share no bit
      const unsigned base = slot(t, hi << r, c);
#pragma unroll
      for (int m = 0; m < R; ++m)
        *(u64*)((char*)sm + (base ^ xo[m])) = a[m];
    }
  }
}

// A radix-16 step after the first: S = 2^s0 rows done, T = 16 S after it.
// Group (hi, lo) holds row positions hi*T + m*S + lo; element m is
// multiplied by w_T^(rev(m) * lo) = tw[rev(m) * lo * L/T], then the
// 16-point DFT. The last step (T = L) writes the output rows m*S + lo.
template <bool kCross>
__device__ __forceinline__ void radix16_step(const Pass& p, const Tile& t,
                                             u64* sm, const u64* w16,
                                             int s0, bool last) {
  const int S = 1 << s0;
  const int f = t.lg - s0 - 4;           // log2(L / T)
  const int groups = (t.L >> 4) << t.ltc;
  unsigned xb[4];                         // offsets of m = 1, 2, 4, 8
#pragma unroll
  for (int i = 0; i < 4; ++i) xb[i] = slot(t, (unsigned)S << i, 0);
  for (int gam = threadIdx.x; gam < groups; gam += blockDim.x) {
    const int c = gam & (t.TC - 1);
    const int gp = gam >> t.ltc;
    const int lo = gp & (S - 1);
    const int hi = gp >> s0;
    const unsigned base = slot(t, ((unsigned)hi << (s0 + 4)) | lo, c);
    unsigned off[16];
    u64 a[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      off[m] = base ^ ((m & 1) ? xb[0] : 0u) ^ ((m & 2) ? xb[1] : 0u) ^
               ((m & 4) ? xb[2] : 0u) ^ ((m & 8) ? xb[3] : 0u);
      a[m] = *(const u64*)((const char*)sm + off[m]);
    }
    if (lo) {
#pragma unroll
      for (int m = 1; m < 16; ++m)
        a[m] = gl_mul_lazy(a[m], __ldg(p.tw + ((rev_c(m, 4) * lo) << f)));
    }
    dft<4>(a, w16, 0);
    if (last) {
#pragma unroll
      for (int m = 0; m < 16; ++m)
        store_out<kCross>(p, t, (long long)m * S + lo, c, a[m]);
    } else {
#pragma unroll
      for (int m = 0; m < 16; ++m)
        *(u64*)((char*)sm + off[m]) = a[m];
    }
  }
}

template <bool kLde, bool kCross>
__global__ void __launch_bounds__(kThreads, kLde ? 3 : 2)
    colntt_kernel(const Pass p) {
  extern __shared__ __align__(16) u64 sm[];
  const Tile t = tile_of(p);
  const int K = t.lg ? (t.lg + 3) >> 2 : 1;   // steps
  const int r1 = t.lg - 4 * (K - 1);
  const bool only = K == 1;
  switch (r1) {
    case 0: first_step<0, kLde, kCross>(p, t, sm, only); break;
    case 1: first_step<1, kLde, kCross>(p, t, sm, only); break;
    case 2: first_step<2, kLde, kCross>(p, t, sm, only); break;
    case 3: first_step<3, kLde, kCross>(p, t, sm, only); break;
    default: first_step<4, kLde, kCross>(p, t, sm, only); break;
  }
  if (only) return;
  u64 w16[8];
#pragma unroll
  for (int e = 1; e < 8; ++e) w16[e] = __ldg(p.tw + (e << (t.lg - 4)));
  for (int s = 1; s < K; ++s) {
    __syncthreads();
    radix16_step<kCross>(p, t, sm, w16, r1 + 4 * (s - 1),
                         s == K - 1);
  }
}

template <bool kLde, bool kCross>
int launch(const Pass& p, long long B, void* stream) {
  if (p.log_L < 0 || p.log_TC < 0 || p.log_L + p.log_TC > kLogMaxTile ||
      (p.C & ((1LL << p.log_TC) - 1)) != 0 || p.z < 0 ||
      p.z > (p.log_L ? p.log_L - 4 * ((p.log_L + 3) / 4 - 1) : 0))
    return (int)cudaErrorInvalidValue;
  const long long blocks = B * (p.C >> p.log_TC);
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tile = 1 << (p.log_L + p.log_TC);
  const size_t smem = p.log_L > 4 ? (size_t)tile * sizeof(u64) : 0;
  if (smem > (48 << 10)) {   // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        colntt_kernel<kLde, kCross>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = tile >> 4 < 32 ? 32
                      : (tile >> 4 > kThreads ? kThreads : tile >> 4);
  colntt_kernel<kLde, kCross><<<(unsigned)blocks, threads, smem,
                                (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: B batches of L*C canonical felts each; element (r, c) of batch b
// at b*sb + r*sr + c*sc. tw: w_L^e for e < L. cross: nullptr or a table
// read at r*cross_ld + c. TC = 2^log_TC columns a block, L * TC <= 2^14,
// TC divides C.
extern "C" int gl_colntt(const void* in, void* out, const void* tw,
                         const void* cross, int log_L, int log_TC,
                         long long C, long long B, long long in_sb,
                         long long in_sr, long long in_sc, long long out_sb,
                         long long out_sr, long long out_sc,
                         long long cross_ld, void* stream) {
  Pass p{};
  p.in = (const u64*)in;
  p.out = (u64*)out;
  p.tw = (const u64*)tw;
  p.cross = (const u64*)cross;
  p.C = C;
  p.in_sb = in_sb;
  p.in_sr = in_sr;
  p.in_sc = in_sc;
  p.out_sb = out_sb;
  p.out_sr = out_sr;
  p.out_sc = out_sc;
  p.cross_ld = cross_ld;
  p.log_L = log_L;
  p.log_TC = log_TC;
  return cross != nullptr ? launch<false, true>(p, B, stream)
                          : launch<false, false>(p, B, stream);
}

// The first pass of the coset LDE: the (L, C) matrix of batch b is the
// zero-padded row coef[b*n .. b*n + n) times offset^i, element (r, c) at
// i = r*C + c, read where i < n: coef[b*n + i] * colpow[c] * rowpow[r].
// z: the first step's leading stages that only copy (rows >= L >> z are
// all padding), at most that step's radix.
extern "C" int gl_colntt_lde(const void* coef, void* out, const void* tw,
                             const void* cross, const void* rowpow,
                             const void* colpow, int log_L, int log_TC,
                             long long C, long long B, long long n, int z,
                             long long out_sb, long long out_sr,
                             long long out_sc, long long cross_ld,
                             void* stream) {
  Pass p{};
  p.in = (const u64*)coef;
  p.out = (u64*)out;
  p.tw = (const u64*)tw;
  p.cross = (const u64*)cross;
  p.rowpow = (const u64*)rowpow;
  p.colpow = (const u64*)colpow;
  p.C = C;
  p.out_sb = out_sb;
  p.out_sr = out_sr;
  p.out_sc = out_sc;
  p.cross_ld = cross_ld;
  p.n = n;
  p.log_L = log_L;
  p.log_TC = log_TC;
  p.z = z;
  if (cross == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true, true>(p, B, stream);
}
