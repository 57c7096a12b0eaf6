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
//   FrameIn     the point's frame cells and the rands, read where the
//               generated code uses them: row c of a frame at
//               p[c * stride + e] (an LDE fragment as a view, or the copy
//               made at the end of the domain);
//   MergeOut    folds each constraint value into the merge as it comes:
//               out = zt * sum_k (c0_k + c1_k x^adj_k) v_k + sum_j (cb0_j
//               + x^adj_j cb1_j)(col_j - b_j) dinv_j, K3's sum, with
//               x^adj_k the row of constraint k's degree class;
//   StoreOut    writes the raw constraint values (T, m) instead;
//
// and, for the card only, the kernels and their launch.
//
// Kernel K6, the port's counterpart of aero_tpu's _aux_factors_jit
// (aero_tpu/air/miden.py:1073, the bus factors of _bus_row_factors under
// jax.jit), shares the per-point code: aux_<name>_factors.cuh holds
// `eval(in, out)` for one row of the main trace, generated from the row
// function by the same emission, and reads it through
//
//   RowsIn      row i's cells and row (i + 1) mod n's, both read in place
//               in the (width, n) trace: no rolled copy of the trace;
//
// handing each value to StoreOut, one row a thread (row_eval_kernel). It
// is bound by its ALU pipe (some 324 field ops a row, about 4 900 ALU
// instructions, against 54 words moved), so it takes K5's rules: a short
// live set, reads as opaque loads, ptxas at -O1. The per-point code
// compiles on the host as well (define __device__ and __forceinline__
// away and __umul64hi with unsigned __int128): the CPU tests run the
// committed text through g++.
//
// What bounds K5 on the card is its ALU pipe: about 1 950 field ops a
// point, each a short dependent chain. To hide the chains the SM needs
// many warps, so a thread's live set has to fit in few registers without
// spilling. The generated code sees to that (air/codegen.py): a cell is
// read again where its next use is far, a value that is one op of leaves
// is computed again from the new reads, and the constraints come in an
// order that keeps few values live. This holds only while the compiler
// cannot merge two reads of one cell: on the card a read is inline PTX.
// The merge holds one accumulator, and ptxas runs at -O1 on these sources
// (_build.FRAG_EVAL_FLAGS): at -O3 it moves reads and their addresses
// far ahead of their uses and spills.
#pragma once

#include "goldilocks.cuh"

#define GL_FN __device__ __forceinline__

// Word e of row i of rows at `stride` words: base[i * stride + e]. On
// the card the address and the load are one piece of inline PTX, a
// relaxed load at block scope, so the compiler neither merges two reads of
// one word (as it does two ld.global.nc of one address: the value would
// be held from its first use to its last) nor keeps the addresses it has
// computed (a chain of row addresses, or a row's address held from one
// read to the next): each
// read computes its address anew from `base` and `stride`, kernel
// parameters, and the point e, the one value every read shares. L1 serves
// the load. On the host a plain read. i * 8, `stride` and e are below
// 2^32 (frag_eval_launch checks the strides and the points).
GL_FN u64 frag_read(const u64* base, unsigned stride, unsigned i,
                    unsigned e) {
#ifdef __CUDA_ARCH__
  u64 v;
  asm volatile(
      "{\n\t.reg .u64 a;\n\tmad.wide.u32 a, %2, %3, %1;\n\t"
      "mad.wide.u32 a, %4, 8, a;\n\t"
      "ld.relaxed.cta.global.u64 %0, [a];\n\t}"
      : "=l"(v) : "l"(base), "r"(i * 8u), "r"(stride), "r"(e));
  return v;
#else
  return base[(unsigned long long)i * stride + e];
#endif
}

struct FrameIn {
  const u64* mc;        // main trace at x, (main width) rows
  const u64* mn;        // main trace at x g
  const u64* ac;        // aux trace at x, (aux width) rows
  const u64* an;        // aux trace at x g
  long long smc, smn, sac, san;   // their row strides, in elements
  const u64* rands;     // the aux rands
  long long e;          // the point

  GL_FN u64 main_cur(int c) const { return frag_read(mc, smc, c, e); }
  GL_FN u64 main_nxt(int c) const { return frag_read(mn, smn, c, e); }
  GL_FN u64 aux_cur(int c) const { return frag_read(ac, sac, c, e); }
  GL_FN u64 aux_nxt(int c) const { return frag_read(an, san, c, e); }
  GL_FN u64 rand(int i) const { return frag_read(rands, 1, i, 0); }
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

// The weight of constraint k, c0_k + c1_k x^adj_k, is made where its
// value arrives, from its two coefficients and the x^adj row of its degree
// class, so the whole point holds one accumulator (two registers), where
// a sum by degree class would hold one a class.
struct MergeOut {
  const u64* cc;        // (T, 2) transition coefficients
  const u64* xp;        // rows of x^adj, at row stride sx
  const int* idx;       // the x^adj row of each degree class
  unsigned sx, e;
  u64 acc;              // sum_k (c0_k + c1_k x^adj_k) v_k

  template <int K, int CLS>
  GL_FN void put(u64 v) {
    const u64 w = gl_add(frag_read(cc, 1, 2 * K, 0),
                         gl_mul(frag_read(cc, 1, 2 * K + 1, 0),
                                frag_read(xp, sx, idx[CLS], e)));
    acc = gl_add(acc, gl_mul(w, v));
  }
};

// Output K of point e to out[K * m + e]; a program without degree
// classes (K6's) names no class.
struct StoreOut {
  u64* out;
  long long m, e;

  template <int K, int CLS = 0>
  GL_FN void put(u64 v) { out[K * m + e] = v; }
};

// Row e of a (width, n) trace at row stride `stride` and the row after it,
// (e + 1) mod n: the frames of a row function (K6), read in place.
struct RowsIn {
  const u64* tr;
  long long stride;
  const u64* rands;
  long long e, en;

  GL_FN u64 main_cur(int c) const { return frag_read(tr, stride, c, e); }
  GL_FN u64 main_nxt(int c) const { return frag_read(tr, stride, c, en); }
  GL_FN u64 rand(int i) const { return frag_read(rands, 1, i, 0); }
};

// The outputs of row in.e into out (outputs, n).
template <class Fn>
GL_FN void row_store_point(RowsIn in, u64* out, long long n) {
  in.en = in.e + 1 == n ? 0 : in.e + 1;
  StoreOut s{out, n, in.e};
  Fn::eval(in, s);
}

// The merged composition value of the point in.e.
template <class Air>
GL_FN u64 frag_merge_point(const FrameIn& in, const MergeArgs& a) {
  MergeOut o{a.cc_t, a.xp, a.idx, (unsigned)a.sx, (unsigned)in.e, 0};
  Air::eval(in, o);
  const long long e = in.e;
  u64 acc = gl_mul(o.acc, frag_read(a.zt, 0, 0, e));
  const int* bx = a.idx + Air::kClasses;
  const int* bd = bx + a.B;
  const int* bc = bd + a.B;
#pragma unroll 1
  for (int j = 0; j < a.B; ++j) {
    const int c = bc[j];
    const u64 col = c < Air::kMainWidth ? in.main_cur(c)
                                        : in.aux_cur(c - Air::kMainWidth);
    const u64 k = gl_add(frag_read(a.cc_b, 1, 2 * j, 0),
                         gl_mul(frag_read(a.xp, a.sx, bx[j], e),
                                frag_read(a.cc_b, 1, 2 * j + 1, 0)));
    acc = gl_add(acc, gl_mul(gl_mul(k, gl_sub(col, frag_read(a.bvals, 1,
                                                             j, 0))),
                             frag_read(a.dinv, a.sd, bd[j], e)));
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
// Blocks an SM for the merge kernel: the register cap is 65 536 / (this
// x kFragThreads), 72. ptxas fits the generated MidenAir code in it with
// no spill, and 28 warps an SM wait on its multiplies' chains in turn
// (chip_smoke.py reads the registers and fails on a spill).
constexpr int kFragMinBlocks = 7;

// One point a thread. No grid-stride loop: what a loop would keep from
// one trip to the next (the rands, the coefficients) is read where it is
// used instead.
template <class Air>
__global__ void __launch_bounds__(kFragThreads, kFragMinBlocks)
frag_merge_kernel(FrameIn in, MergeArgs a, u64* __restrict__ out,
                  long long m) {
  in.e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (in.e < m) out[in.e] = frag_merge_point<Air>(in, a);
}

template <class Air>
__global__ void __launch_bounds__(kFragThreads)
frag_store_kernel(FrameIn in, u64* __restrict__ out, long long m) {
  in.e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (in.e < m) frag_store_point<Air>(in, out, m);
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

// One row a thread, as K5 takes one point a thread.
template <class Fn>
__global__ void __launch_bounds__(kFragThreads)
row_eval_kernel(RowsIn in, u64* __restrict__ out, long long n) {
  in.e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (in.e < n) row_store_point<Fn>(in, out, n);
}

#define ROW_EVAL_PARAMS                                                    \
  const void *tr, long long stride, const void *rands, void *out,          \
      long long n, void *stream
#define ROW_EVAL_ARGS tr, stride, rands, out, n, stream

// K6 over the n rows of the (width, n) trace at row stride `stride`: the
// (Fn::kOutputs, n) values into out.
template <class Fn>
int row_eval_launch(ROW_EVAL_PARAMS) {
  // frag_read's strides and points are below 2^32
  if (stride < 0 || stride >= (1LL << 32) || n < 0 || n >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const RowsIn in{(const u64*)tr, stride, (const u64*)rands, 0, 0};
  const unsigned grid = (unsigned)((n + kFragThreads - 1) / kFragThreads);
  row_eval_kernel<Fn><<<grid, kFragThreads, 0, (cudaStream_t)stream>>>(
      in, (u64*)out, n);
  return (int)cudaGetLastError();
}

// mode 0: the merged row out (m,); mode 1: the constraint values (T, m).
template <class Air>
int frag_eval_launch(FRAG_EVAL_PARAMS) {
  if (B < 0 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  const long long strides[] = {smc, smn, sac, san, sd, sx, m};  // frag_read's
  for (long long st : strides)
    if (st < 0 || st >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaSuccess;
  const FrameIn in{(const u64*)mc, (const u64*)mn, (const u64*)ac,
                   (const u64*)an, smc, smn, sac, san, (const u64*)rands, 0};
  const long long blocks = (m + kFragThreads - 1) / kFragThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
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
