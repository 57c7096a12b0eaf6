// blake2s-256 over many independent messages: leaf rows, Merkle parents
// and proof-of-work nonces.
//
// Replaces the TPU kernel aero_tpu/hash/blake2s_pallas.py `_make_kernel`
// (:36, launched by `_blake2s_t_tpu` :78), which hashed 1024 word-major
// messages per grid step with the 10-round compress of
// hash/blake2s_jax.py `_compress`. Here one thread hashes one message,
// with its 16 message words and 16 state words in registers (the rounds
// are unrolled with constant indices, so nothing spills to local memory).
// Four entry points read their messages in place instead of materializing
// a word-major message array:
//   blake2s_words         generic (W, B) word-major messages of nbytes;
//   blake2s_hash_columns  hash_elements of each row of column-major felts,
//                         words [lo, hi, 0 x 6] built in registers (the 8x
//                         message would be 19 GB at 72 x 2^23);
//   blake2s_merge_level   Merkle level (8, 2n) -> (8, n), 64-byte messages;
//   blake2s_grind_pow     40-byte seed || u64le(nonce) messages; atomicMin
//                         keeps the smallest nonce with enough leading zeros.
// Words travel as int64 tensors holding u32 values, like the plain PyTorch
// versions in hash/blake2s.py.
//
// What bounds it on this card: 32-bit integer ALU work (about 900 adds,
// xors and funnel-shift rotates per compress); the reads are one coalesced
// pass over the data. Leaf hashing at 72 felts per row runs 36 compresses
// per thread.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

__device__ __forceinline__ unsigned rotr(unsigned x, int r) {
  return __funnelshift_r(x, x, r);
}

#define B2S_G(a, b, c, d, x, y) \
  do {                          \
    a = a + b + (x);            \
    d = rotr(d ^ a, 16);        \
    c = c + d;                  \
    b = rotr(b ^ c, 12);        \
    a = a + b + (y);            \
    d = rotr(d ^ a, 8);         \
    c = c + d;                  \
    b = rotr(b ^ c, 7);         \
  } while (0)

#define B2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, \
                  s14, s15)                                                  \
  do {                                                                       \
    B2S_G(v[0], v[4], v[8], v[12], m[s0], m[s1]);                            \
    B2S_G(v[1], v[5], v[9], v[13], m[s2], m[s3]);                            \
    B2S_G(v[2], v[6], v[10], v[14], m[s4], m[s5]);                           \
    B2S_G(v[3], v[7], v[11], v[15], m[s6], m[s7]);                           \
    B2S_G(v[0], v[5], v[10], v[15], m[s8], m[s9]);                           \
    B2S_G(v[1], v[6], v[11], v[12], m[s10], m[s11]);                         \
    B2S_G(v[2], v[7], v[8], v[13], m[s12], m[s13]);                          \
    B2S_G(v[3], v[4], v[9], v[14], m[s14], m[s15]);                          \
  } while (0)

#define B2S_IV0 0x6A09E667u
#define B2S_IV1 0xBB67AE85u
#define B2S_IV2 0x3C6EF372u
#define B2S_IV3 0xA54FF53Au
#define B2S_IV4 0x510E527Fu
#define B2S_IV5 0x9B05688Cu
#define B2S_IV6 0x1F83D9ABu
#define B2S_IV7 0x5BE0CD19u

__device__ __forceinline__ void init_state(unsigned h[8]) {
  // parameter block word 0: digest 32 bytes, no key, fanout 1, depth 1
  h[0] = B2S_IV0 ^ 0x01010020u;
  h[1] = B2S_IV1;
  h[2] = B2S_IV2;
  h[3] = B2S_IV3;
  h[4] = B2S_IV4;
  h[5] = B2S_IV5;
  h[6] = B2S_IV6;
  h[7] = B2S_IV7;
}

// One compression; t = byte counter (messages here stay below 2^32 bytes).
__device__ __forceinline__ void compress(unsigned h[8], const unsigned m[16],
                                         unsigned t, bool final) {
  unsigned v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = h[i];
  v[8] = B2S_IV0;
  v[9] = B2S_IV1;
  v[10] = B2S_IV2;
  v[11] = B2S_IV3;
  v[12] = B2S_IV4 ^ t;
  v[13] = B2S_IV5;
  v[14] = final ? ~B2S_IV6 : B2S_IV6;
  v[15] = B2S_IV7;
  B2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

__device__ __forceinline__ void store_digest(const unsigned h[8], u64* out,
                                             long long stride, long long i) {
#pragma unroll
  for (int w = 0; w < 8; ++w) out[w * stride + i] = h[w];
}

__global__ void words_kernel(const u64* __restrict__ msg, long long W,
                             long long B, long long nbytes,
                             u64* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const long long nblocks = nbytes > 64 ? (nbytes + 63) / 64 : 1;
  unsigned h[8], m[16];
  init_state(h);
  for (long long bk = 0; bk < nblocks; ++bk) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long w = bk * 16 + j;
      m[j] = w < W ? (unsigned)msg[w * B + i] : 0u;
    }
    const bool final = bk == nblocks - 1;
    compress(h, m, (unsigned)(final ? nbytes : 64 * (bk + 1)), final);
  }
  store_digest(h, out, B, i);
}

__global__ void hash_columns_kernel(const u64* __restrict__ cols, long long w,
                                    long long n, u64* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long nblocks = (w + 1) / 2;   // two 32-byte felts per block
  unsigned h[8], m[16];
  init_state(h);
  for (long long bk = 0; bk < nblocks; ++bk) {
#pragma unroll
    for (int j = 0; j < 16; ++j) m[j] = 0u;
    const u64 f0 = gl_canon(cols[(2 * bk) * n + i]);
    m[0] = (unsigned)f0;
    m[1] = (unsigned)(f0 >> 32);
    if (2 * bk + 1 < w) {
      const u64 f1 = gl_canon(cols[(2 * bk + 1) * n + i]);
      m[8] = (unsigned)f1;
      m[9] = (unsigned)(f1 >> 32);
    }
    const bool final = bk == nblocks - 1;
    compress(h, m, (unsigned)(final ? 32 * w : 64 * (bk + 1)), final);
  }
  store_digest(h, out, n, i);
}

__global__ void merge_level_kernel(const u64* __restrict__ d, long long n,
                                   u64* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned h[8], m[16];
  init_state(h);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = (unsigned)d[j * 2 * n + 2 * i];
    m[8 + j] = (unsigned)d[j * 2 * n + 2 * i + 1];
  }
  compress(h, m, 64u, true);
  store_digest(h, out, n, i);
}

__global__ void grind_kernel(const u64* __restrict__ seed, long long base,
                             long long count, int bits,
                             unsigned long long* __restrict__ result) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const unsigned long long nonce = (unsigned long long)(base + i);
  unsigned h[8], m[16];
  init_state(h);
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = (unsigned)seed[j];
  m[8] = (unsigned)nonce;
  m[9] = (unsigned)(nonce >> 32);
#pragma unroll
  for (int j = 10; j < 16; ++j) m[j] = 0u;
  compress(h, m, 40u, true);
  // leading zero bits of the first 16 digest bytes read big-endian
  int lz = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const unsigned be = __byte_perm(h[w], 0u, 0x0123);
    if (lz == 32 * w) lz += be ? __clz(be) : 32;
  }
  if (lz >= bits) atomicMin(result, nonce);
}

inline unsigned grid_for(long long n) { return (unsigned)((n + 255) / 256); }

}  // namespace

// msg: (W, B) u32 words (as int64) word-major; out: (8, B).
extern "C" int blake2s_words(const void* msg, long long W, long long B,
                             long long nbytes, void* out, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  words_kernel<<<grid_for(B), 256, 0, (cudaStream_t)stream>>>(
      (const u64*)msg, W, B, nbytes, (u64*)out);
  return (int)cudaGetLastError();
}

// cols: (w, n) felts column-major; out: (8, n) digests of each row.
extern "C" int blake2s_hash_columns(const void* cols, long long w,
                                    long long n, void* out, void* stream) {
  if (n == 0 || w == 0) return (int)cudaSuccess;
  hash_columns_kernel<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(
      (const u64*)cols, w, n, (u64*)out);
  return (int)cudaGetLastError();
}

// d: (8, 2n) digests word-major; out: (8, n) parents.
extern "C" int blake2s_merge_level(const void* d, long long n, void* out,
                                   void* stream) {
  if (n == 0) return (int)cudaSuccess;
  merge_level_kernel<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(
      (const u64*)d, n, (u64*)out);
  return (int)cudaGetLastError();
}

// seed: 8 u32 words (as int64); nonces base .. base + count - 1; result: one
// u64 that atomicMin lowers to the smallest qualifying nonce.
extern "C" int blake2s_grind_pow(const void* seed, long long base,
                                 long long count, int bits, void* result,
                                 void* stream) {
  if (count == 0) return (int)cudaSuccess;
  grind_kernel<<<grid_for(count), 256, 0, (cudaStream_t)stream>>>(
      (const u64*)seed, base, count, bits, (unsigned long long*)result);
  return (int)cudaGetLastError();
}
