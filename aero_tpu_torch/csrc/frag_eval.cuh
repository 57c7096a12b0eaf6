// Kernel K5: one fragment of the constraint-evaluation domain in one pass,
// the port's counterpart of aero_tpu's jax.jit(frag_fn)
// (aero_tpu/prover/prover.py:407-446): every transition constraint of an
// AIR at every point of the fragment, merged with the assertions into the
// composition row, with no temporary row in memory.
//
// The constraints themselves are generated: air_<name>_transitions.cuh
// holds `eval(in, out)` for one AIR, straight-line code traced from the
// AIR's evaluate_transitions (aero_tpu_torch/air/codegen.py). This header
// holds what every AIR shares:
//
//   FrameIn     the point's frame cells, read in place: row c of a frame
//               at p[c * stride + e] (an LDE fragment as a view, or the
//               copy made at the end of the domain);
//   MergeOut    folds each constraint value into the merge as it comes:
//               out = zt * (sum_k c0_k v_k + sum_c x^adj_c sum_{k in c}
//               c1_k v_k) + sum_j (cb0_j + x^adj_j cb1_j)(col_j - b_j)
//               dinv_j, which is K3's sum_k (c0_k + x^adj_k c1_k) v_k zt
//               + ... regrouped by degree class c (exact in the field);
//   StoreOut    writes the raw constraint values (T, m) instead;
//
// and, for the card only, the kernels and their launch. The per-point code
// compiles on the host as well (define __device__ and __forceinline__
// away and __umul64hi with unsigned __int128): the CPU tests run the
// committed text through g++.
#pragma once

#include "goldilocks.cuh"

#define GL_FN __device__ __forceinline__

struct FrameIn {
  const u64* mc;        // main trace at x, (main width) rows
  const u64* mn;        // main trace at x g
  const u64* ac;        // aux trace at x, (aux width) rows
  const u64* an;        // aux trace at x g
  long long smc, smn, sac, san;   // their row strides, in elements
  const u64* rands;     // the aux rands
  long long e;          // the point

  GL_FN u64 main_cur(int c) const { return mc[c * smc + e]; }
  GL_FN u64 main_nxt(int c) const { return mn[c * smn + e]; }
  GL_FN u64 aux_cur(int c) const { return ac[c * sac + e]; }
  GL_FN u64 aux_nxt(int c) const { return an[c * san + e]; }
  GL_FN u64 rand(int i) const { return rands[i]; }
};

// What the merge reads beside the frame. idx holds, in order: the x^adj
// row of each degree class (kClasses), then for each of the B assertions
// its x^adj row, its divisor row and its column (main columns first, aux
// columns after them).
struct MergeArgs {
  const u64* cc_t;      // (T, 2) transition coefficients
  const u64* cc_b;      // (B, 2) assertion coefficients
  const u64* bvals;     // (B,) asserted values
  const u64* zt;        // the fragment's 1 / transition divisor
  const u64* dinv;      // rows of 1 / (x - g^step), at row stride sd
  long long sd;
  const u64* xp;        // rows of x^adj, at row stride sx
  long long sx;
  const int* idx;
  int B;
};

template <int C>
struct MergeOut {
  const u64* cc;
  u64 a0;               // sum_k c0_k v_k
  u64 a1[C];            // sum_{k in class c} c1_k v_k

  template <int K, int CLS>
  GL_FN void put(u64 v) {
    a0 = gl_add(a0, gl_mul(cc[2 * K], v));
    a1[CLS] = gl_add(a1[CLS], gl_mul(cc[2 * K + 1], v));
  }
};

struct StoreOut {
  u64* out;
  long long m, e;

  template <int K, int CLS>
  GL_FN void put(u64 v) { out[K * m + e] = v; }
};

// The merged composition value of the point in.e.
template <class Air>
GL_FN u64 frag_merge_point(const FrameIn& in, const MergeArgs& a) {
  MergeOut<Air::kClasses> o;
  o.cc = a.cc_t;
  o.a0 = 0;
#pragma unroll
  for (int c = 0; c < Air::kClasses; ++c) o.a1[c] = 0;
  Air::eval(in, o);
  const long long e = in.e;
  u64 t = o.a0;
#pragma unroll
  for (int c = 0; c < Air::kClasses; ++c)
    t = gl_add(t, gl_mul(a.xp[a.idx[c] * a.sx + e], o.a1[c]));
  u64 acc = gl_mul(t, a.zt[e]);
  const int* bx = a.idx + Air::kClasses;
  const int* bd = bx + a.B;
  const int* bc = bd + a.B;
#pragma unroll 1
  for (int j = 0; j < a.B; ++j) {
    const int c = bc[j];
    const u64 col = c < Air::kMainWidth ? in.main_cur(c)
                                        : in.aux_cur(c - Air::kMainWidth);
    const u64 k = gl_add(a.cc_b[2 * j],
                         gl_mul(a.xp[bx[j] * a.sx + e], a.cc_b[2 * j + 1]));
    acc = gl_add(acc, gl_mul(gl_mul(k, gl_sub(col, a.bvals[j])),
                             a.dinv[bd[j] * a.sd + e]));
  }
  return acc;
}

// The raw constraint values of the point in.e into out (T, m).
template <class Air>
GL_FN void frag_store_point(const FrameIn& in, u64* out, long long m) {
  StoreOut s{out, m, in.e};
  Air::eval(in, s);
}

#ifdef __CUDACC__

constexpr int kFragThreads = 128;
// Six blocks an SM cap a thread of the merge kernel at 80 registers. The
// MidenAir kernel wants more than 255 (85 values live at once in the
// traced order, two registers each, and the temporaries of a multiply):
// uncapped it holds 8 warps an SM and waits on its dependent chains; capped
// it spills to L1 (a few KB a thread) and holds 24.
constexpr int kFragMinBlocks = 6;

// One point a thread, a grid-stride loop over the fragment.
template <class Air>
__global__ void __launch_bounds__(kFragThreads, kFragMinBlocks)
frag_merge_kernel(FrameIn in, MergeArgs a, u64* __restrict__ out,
                  long long m) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < m;
       e += (long long)gridDim.x * blockDim.x) {
    FrameIn p = in;
    p.e = e;
    out[e] = frag_merge_point<Air>(p, a);
  }
}

template <class Air>
__global__ void __launch_bounds__(kFragThreads)
frag_store_kernel(FrameIn in, u64* __restrict__ out, long long m) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < m;
       e += (long long)gridDim.x * blockDim.x) {
    FrameIn p = in;
    p.e = e;
    frag_store_point<Air>(p, out, m);
  }
}

#define FRAG_EVAL_PARAMS                                                   \
  const void *mc, long long smc, const void *mn, long long smn,            \
      const void *ac, long long sac, const void *an, long long san,        \
      const void *rands, const void *cc_t, const void *cc_b,               \
      const void *bvals, const void *zt, const void *dinv, long long sd,   \
      const void *xp, long long sx, const void *idx, int B, void *out,     \
      long long m, int mode, void *stream
#define FRAG_EVAL_ARGS                                                     \
  mc, smc, mn, smn, ac, sac, an, san, rands, cc_t, cc_b, bvals, zt, dinv,  \
      sd, xp, sx, idx, B, out, m, mode, stream

// mode 0: the merged row out (m,); mode 1: the constraint values (T, m).
template <class Air>
int frag_eval_launch(FRAG_EVAL_PARAMS) {
  if (B < 0 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaSuccess;
  const FrameIn in{(const u64*)mc, (const u64*)mn, (const u64*)ac,
                   (const u64*)an, smc, smn, sac, san, (const u64*)rands, 0};
  const long long blocks = (m + kFragThreads - 1) / kFragThreads;
  const unsigned grid = (unsigned)(blocks < (1LL << 30) ? blocks : 1LL << 30);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    const MergeArgs a{(const u64*)cc_t, (const u64*)cc_b, (const u64*)bvals,
                      (const u64*)zt, (const u64*)dinv, sd, (const u64*)xp,
                      sx, (const int*)idx, B};
    frag_merge_kernel<Air><<<grid, kFragThreads, 0, s>>>(in, a, (u64*)out, m);
  } else {
    frag_store_kernel<Air><<<grid, kFragThreads, 0, s>>>(in, (u64*)out, m);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
