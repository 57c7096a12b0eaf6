// Kernel K7: coefficient rows evaluated at a few points, the port's
// counterpart of aero_tpu's eval_polys_multi (aero_tpu/field/jax_gl.py:464):
// the jitted modules power_series_dyn (:437), the power rows
// [z^0 .. z^(n-1)] of each point, and _eval_multi_core (:456), the terms
// c_j z^j of every row at every point summed over j. No Pallas kernel:
// XLA fused those modules on the TPU.
//
// What bounds it on this card: the ALU pipe. A coefficient is read once
// (8 B) and then multiplied and added once for each of the k points (three
// in the prover's OOD stage): some 3 x 32 ALU instructions for 8 B, where
// 3.35 TB/s would deliver those 8 B in the time the SMs take for about 40.
// The power rows are never built: the work is the function's own, one
// multiply and one add a coefficient a point, and the bytes are the rows
// read once where they lie (several row blocks, no concatenated copy).
//
// Design. A block takes kEvalSteps * kEvalThreads consecutive coefficients
// of kEvalRows rows. Thread t of the block takes the coefficients j = base
// + t + kEvalThreads * i, i = 0 .. kEvalSteps - 1, neighbouring threads on
// neighbouring words. For each point z it sums them by Horner's rule in the
// step Z = z^kEvalThreads, from the top i down: acc = acc * Z + c_j, one
// multiply and one add a coefficient; then multiplies the sum by
// z^(base + t), made from the table of z^(2^b) the launch passes by value.
// The block sums its threads' values (warp shuffles, then shared memory)
// into one partial a (point, row); a second small launch folds the blocks'
// partials of each (point, row) into the output. The outputs are canonical
// and exact: the order of a sum in the field does not matter.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kEvalThreads = 256;   // a block's threads; Horner's step z^256
constexpr int kLogThreads = 8;
constexpr int kEvalSteps = 32;      // coefficients a thread takes of a row
constexpr int kEvalRows = 8;        // rows a thread holds
constexpr int kMaxPoints = 4;
constexpr int kMaxBlocks = 4;       // row blocks
constexpr int kPowBits = 32;        // z^(2^b) for the bits of j < 2^31
constexpr int kFoldThreads = 128;
static_assert(kEvalThreads == 1 << kLogThreads, "Horner steps by z^T");

struct EvalPoints {
  u64 pow[kMaxPoints][kPowBits];    // z_t^(2^b)
};

// Global row r lies in block b with first[b] <= r < first[b + 1], at
// p[b] + (r - first[b]) * stride[b].
struct EvalBlocks {
  const u64* p[kMaxBlocks];
  long long stride[kMaxBlocks];
  int first[kMaxBlocks + 1];
};

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = gl_add(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// partial[(t * w + r) * gridDim.x + blockIdx.x]: the block's sum for point
// t and row r.
template <int K>
__global__ void __launch_bounds__(kEvalThreads)
eval_partial_kernel(EvalBlocks blocks, EvalPoints pts,
                    u64* __restrict__ partial, long long n, int w) {
  __shared__ u64 sums[kEvalThreads / 32][K * kEvalRows];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * kEvalThreads * kEvalSteps;
  const int r0 = blockIdx.y * kEvalRows;
  const int rows = min(kEvalRows, w - r0);

  // row r's pointer: the last block that starts at or before it (an empty
  // block starts where the next one does). Constant indices only, so the
  // blocks stay in the parameter space.
  const u64* row[kEvalRows];
#pragma unroll
  for (int r = 0; r < kEvalRows; ++r) {
    const int g = min(r0 + r, w - 1);
    row[r] = blocks.p[0] + g * blocks.stride[0];
#pragma unroll
    for (int b = 1; b < kMaxBlocks; ++b)
      if (g >= blocks.first[b])
        row[r] = blocks.p[b] + (g - blocks.first[b]) * blocks.stride[b];
  }
  u64 step[K];
#pragma unroll
  for (int t = 0; t < K; ++t) step[t] = pts.pow[t][kLogThreads];

  u64 acc[K][kEvalRows];
#pragma unroll
  for (int t = 0; t < K; ++t)
#pragma unroll
    for (int r = 0; r < kEvalRows; ++r) acc[t][r] = 0;

#pragma unroll 1
  for (int i = kEvalSteps - 1; i >= 0; --i) {
    const long long j = base + tid + (long long)i * kEvalThreads;
#pragma unroll
    for (int r = 0; r < kEvalRows; ++r) {
      if (r < rows) {
        const u64 c = j < n ? row[r][j] : 0;
#pragma unroll
        for (int t = 0; t < K; ++t)
          acc[t][r] = gl_add(gl_mul(acc[t][r], step[t]), c);
      }
    }
  }

  // times z^(base + tid), then the block's sum of each (point, row)
  const unsigned e = (unsigned)(base + tid);
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    u64 s = 1;
#pragma unroll
    for (int b = 0; b < kPowBits; ++b)
      if ((e >> b) & 1u) s = gl_mul(s, pts.pow[t][b]);
#pragma unroll
    for (int r = 0; r < kEvalRows; ++r) {
      const u64 v = warp_sum(r < rows ? gl_mul(acc[t][r], s) : 0);
      if (lane == 0) sums[warp][t * kEvalRows + r] = v;
    }
  }
  __syncthreads();
  if (tid < K * kEvalRows) {
    const int t = tid / kEvalRows, r = tid % kEvalRows;
    if (r < rows) {
      u64 v = 0;
#pragma unroll
      for (int q = 0; q < kEvalThreads / 32; ++q) v = gl_add(v, sums[q][tid]);
      partial[((long long)t * w + r0 + r) * gridDim.x + blockIdx.x] = v;
    }
  }
}

// out[i] = the sum of partial[i * chunks .. (i + 1) * chunks), one block
// an output.
__global__ void __launch_bounds__(kFoldThreads)
eval_fold_kernel(const u64* __restrict__ partial, u64* __restrict__ out,
                 int chunks) {
  __shared__ u64 sums[kFoldThreads / 32];
  const u64* p = partial + (long long)blockIdx.x * chunks;
  u64 v = 0;
  for (int c = threadIdx.x; c < chunks; c += kFoldThreads)
    v = gl_add(v, p[c]);
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 s = 0;
#pragma unroll
    for (int q = 0; q < kFoldThreads / 32; ++q) s = gl_add(s, sums[q]);
    out[blockIdx.x] = s;
  }
}

template <int K>
void launch_partial(dim3 grid, const EvalBlocks& b, const EvalPoints& p,
                    u64* partial, long long n, int w, cudaStream_t s) {
  eval_partial_kernel<K><<<grid, kEvalThreads, 0, s>>>(b, p, partial, n, w);
}

}  // namespace

// K7: out (k, w) = the rows of up to four blocks (block b: rows[b] rows of
// n coefficients at row stride strides[b], rows[b] may be 0) evaluated at k
// <= 4 points, given as pows, a host array of k x 32 words z_t^(2^b).
// partial: k * w * ceil(n / (256 * 32)) words of scratch. Two launches.
extern "C" int gl_eval_multi(const void* p0, long long s0, int w0,
                             const void* p1, long long s1, int w1,
                             const void* p2, long long s2, int w2,
                             const void* p3, long long s3, int w3,
                             const void* pows, int k, void* partial,
                             void* out, long long n, void* stream) {
  const int ws[kMaxBlocks] = {w0, w1, w2, w3};
  const long long ss[kMaxBlocks] = {s0, s1, s2, s3};
  const void* ps[kMaxBlocks] = {p0, p1, p2, p3};
  EvalBlocks b;
  b.first[0] = 0;
  for (int i = 0; i < kMaxBlocks; ++i) {
    if (ws[i] < 0 || ss[i] < 0) return (int)cudaErrorInvalidValue;
    b.p[i] = (const u64*)ps[i];
    b.stride[i] = ss[i];
    b.first[i + 1] = b.first[i] + ws[i];
  }
  const int w = b.first[kMaxBlocks];
  if (k < 1 || k > kMaxPoints || n < 0 || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (w == 0 || n == 0) return (int)cudaSuccess;
  EvalPoints p;
  const u64* host = (const u64*)pows;
  for (int t = 0; t < k; ++t)
    for (int bit = 0; bit < kPowBits; ++bit)
      p.pow[t][bit] = host[t * kPowBits + bit];
  const long long chunks =
      (n + kEvalThreads * kEvalSteps - 1) / (kEvalThreads * kEvalSteps);
  const dim3 grid((unsigned)chunks, (unsigned)((w + kEvalRows - 1) / kEvalRows));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  u64* part = (u64*)partial;
  switch (k) {
    case 1: launch_partial<1>(grid, b, p, part, n, w, s); break;
    case 2: launch_partial<2>(grid, b, p, part, n, w, s); break;
    case 3: launch_partial<3>(grid, b, p, part, n, w, s); break;
    default: launch_partial<4>(grid, b, p, part, n, w, s); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  eval_fold_kernel<<<(unsigned)(k * w), kFoldThreads, 0, s>>>(
      part, (u64*)out, (int)chunks);
  return (int)cudaGetLastError();
}
