// Goldilocks column NTT: one pass of the two-pass (4-step) transform.
//
// Replaces the TPU kernel aero_tpu/ntt/ntt_pallas.py `_colntt`
// (`_make_colntt_kernel_reshape` :131 and `_make_colntt_kernel_roll` :172,
// which differ only in how the TPU moves data between vector slots).
// A block takes a tile of L rows x TC columns of a (B, L, C) view of the
// data into shared memory, reading row r into slot bitrev(r); runs all
// log2(L) radix-2 decimation-in-time stages there; and on the way out
// multiplies by an optional cross-twiddle table (the 4-step's w^(j1*k2),
// with 1/n folded in for the inverse). Row, column and batch strides are
// arguments, so pass 2 reads the pass-1 output transposed and writes the
// natural-order result without a transpose in between, and the last pass of
// a three-level transform (n > 2^24) takes its columns across the outermost
// axis, the one that is contiguous in the result.
//
// What bounds it on this card: the 64-bit integer multiplies of gl_mul
// (Hopper has no 64-bit multiplier and emulates each 64x64 product with
// several 32-bit IMADs), then shared-memory bandwidth, with one barrier
// per stage. The tile is capped at 4096 elements (32 KB), so L reaches
// 4096 and two passes cover every size up to 2^24, three passes every size
// up to 2^36. A tile of 4096 rows is one column wide, so its global
// accesses are not coalesced; wider tiles,
// register-resident radix-4/8 stages, and TMA or wgmma work are for
// later PRs.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kLogMaxTile = 12;   // L * TC <= 4096 u64 = 32 KB

__global__ void colntt_kernel(const u64* __restrict__ in,
                              u64* __restrict__ out,
                              const u64* __restrict__ tw,
                              const u64* __restrict__ cross, int log_L,
                              int log_TC, long long C, long long in_sb,
                              long long in_sr, long long in_sc,
                              long long out_sb, long long out_sr,
                              long long out_sc, long long cross_ld) {
  __shared__ u64 sm[1 << kLogMaxTile];
  const int L = 1 << log_L;
  const int TC = 1 << log_TC;
  const int tile = L << log_TC;
  const long long tiles = C >> log_TC;
  const long long b = blockIdx.x / tiles;
  const long long c0 = (blockIdx.x % tiles) << log_TC;
  const u64* src = in + b * in_sb;
  u64* dst = out + b * out_sb;

  // load: row r lands in slot bitrev(r); the unit-stride axis varies fastest
  for (int idx = threadIdx.x; idx < tile; idx += blockDim.x) {
    int r, c;
    if (in_sr == 1) {
      r = idx & (L - 1);
      c = idx >> log_L;
    } else {
      c = idx & (TC - 1);
      r = idx >> log_TC;
    }
    const int rr = log_L ? (int)(__brev((unsigned)r) >> (32 - log_L)) : 0;
    sm[(rr << log_TC) + c] = src[r * in_sr + (c0 + c) * in_sc];
  }
  __syncthreads();

  // stage s: butterflies (i0, i0 + half), twiddle w_m^j at tw[half - 1 + j]
  const int nbfly = tile >> 1;
  for (int s = 1; s <= log_L; ++s) {
    const int half = 1 << (s - 1);
    for (int t = threadIdx.x; t < nbfly; t += blockDim.x) {
      const int c = t & (TC - 1);
      const int k = t >> log_TC;
      const int j = k & (half - 1);
      const int i0 = ((k >> (s - 1)) << s) + j;
      const int ia = (i0 << log_TC) + c;
      const int ib = ((i0 + half) << log_TC) + c;
      const u64 u = sm[ia];
      const u64 v = gl_mul(sm[ib], __ldg(tw + half - 1 + j));
      sm[ia] = gl_add(u, v);
      sm[ib] = gl_sub(u, v);
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < tile; idx += blockDim.x) {
    int r, c;
    if (out_sr == 1) {
      r = idx & (L - 1);
      c = idx >> log_L;
    } else {
      c = idx & (TC - 1);
      r = idx >> log_TC;
    }
    u64 v = sm[(r << log_TC) + c];
    if (cross != nullptr) v = gl_mul(v, __ldg(cross + r * cross_ld + c0 + c));
    dst[r * out_sr + (c0 + c) * out_sc] = v;
  }
}

}  // namespace

// in, out: B batches of L*C canonical felts each; element (r, c) of batch b
// at b*sb + r*sr + c*sc. tw: packed stage twiddles (max(L - 1, 1)).
// cross: nullptr or a table read at r*cross_ld + c. TC = 2^log_TC columns
// per block, L * TC <= 4096, TC divides C.
extern "C" int gl_colntt(const void* in, void* out, const void* tw,
                         const void* cross, int log_L, int log_TC,
                         long long C, long long B, long long in_sb,
                         long long in_sr, long long in_sc, long long out_sb,
                         long long out_sr, long long out_sc,
                         long long cross_ld, void* stream) {
  if (log_L < 0 || log_TC < 0 || log_L + log_TC > kLogMaxTile ||
      (C & ((1LL << log_TC) - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = B * (C >> log_TC);
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int half_tile = 1 << (log_L + log_TC - (log_L + log_TC > 0 ? 1 : 0));
  const int threads = half_tile < 32 ? 32 : (half_tile > 256 ? 256 : half_tile);
  colntt_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const u64*)in, (u64*)out, (const u64*)tw, (const u64*)cross, log_L,
      log_TC, C, in_sb, in_sr, in_sc, out_sb, out_sr, out_sc, cross_ld);
  return (int)cudaGetLastError();
}
