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
//               p[c * stride + e], an LDE fragment as a view; a next-row
//               frame that runs past the end of the domain (or of a mesh
//               block) as two views, its body up to that end and its tail,
//               the first points after it, each read where it lies;
//   MergeOut    folds each constraint value into the merge as it comes:
//               out = zt * sum_k (c0_k + c1_k x^adj_k) v_k + sum_j (cb0_j
//               + x^adj_j cb1_j)(col_j - b_j) dinv_j, the sum of
//               prover.constraint_merge_plain, with x^adj_k the value of
//               constraint k's degree class;
//   XPow        what a point makes its x^adj values from, once, before
//               the constraints: x = offset w^i at domain position i, so
//               x^adj = offset^adj w^(adj i mod m_dom), w^k from two
//               tables (k's low bits, its high bits); the values wait in
//               the point's slots (Slots) for MergeOut;
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

// Word e of row i of a frame cut in two: point e below nb from `body`
// (row stride sb), point e from nb on from `tail` (row stride st) at
// e - nb. nb is the frame's length where nothing is cut. The choice is
// made inside the load, from kernel parameters and e, so it holds no
// register across the program either.
GL_FN u64 frag_read_cut(const u64* body, unsigned sb, const u64* tail,
                        unsigned st, unsigned nb, unsigned i, unsigned e) {
#ifdef __CUDA_ARCH__
  u64 v;
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .u64 a;\n\t.reg .u32 s, x;\n\t"
      "setp.lt.u32 p, %7, %5;\n\t"
      "selp.b64 a, %1, %2, p;\n\t"
      "selp.b32 s, %3, %4, p;\n\t"
      "sub.u32 x, %7, %5;\n\t"
      "selp.b32 x, %7, x, p;\n\t"
      "mad.wide.u32 a, %6, s, a;\n\t"
      "mad.wide.u32 a, x, 8, a;\n\t"
      "ld.relaxed.cta.global.u64 %0, [a];\n\t}"
      : "=l"(v)
      : "l"(body), "l"(tail), "r"(sb), "r"(st), "r"(nb), "r"(i * 8u),
        "r"(e));
  return v;
#else
  return e < nb ? body[(unsigned long long)i * sb + e]
                : tail[(unsigned long long)i * st + (e - nb)];
#endif
}

struct FrameIn {
  const u64* mc;        // main trace at x, (main width) rows
  const u64* mn;        // main trace at x g: its body
  const u64* ac;        // aux trace at x, (aux width) rows
  const u64* an;        // aux trace at x g: its body
  long long smc, smn, sac, san;   // their row strides, in elements
  const u64* mt;        // main trace at x g from point nb on: its tail
  const u64* at;        // aux trace at x g from point nb on
  long long smt, sat;   // the tails' row strides
  long long nb;         // the points of the next-row frames in their bodies
  const u64* rands;     // the aux rands
  long long e;          // the point

  GL_FN u64 main_cur(int c) const { return frag_read(mc, smc, c, e); }
  GL_FN u64 main_nxt(int c) const {
    return frag_read_cut(mn, smn, mt, smt, nb, c, e);
  }
  GL_FN u64 aux_cur(int c) const { return frag_read(ac, sac, c, e); }
  GL_FN u64 aux_nxt(int c) const {
    return frag_read_cut(an, san, at, sat, nb, c, e);
  }
  GL_FN u64 rand(int i) const { return frag_read(rands, 1, i, 0); }
};

// What a point makes its x^adj values from. w has order m_dom, a power of
// two up to 2^32, and the point e of the fragment sits at domain position
// i = first + e, so x^adj = offset^adj w^k with k = (adj mod m_dom) i mod
// m_dom (a mask), and w^k = lo[k mod 2^h] hi[k >> h]: two tables of powers
// of w that every exponent shares. Slot r takes exponent r of pw: the
// degree classes' first (slot c for class c), then the assertions'.
struct XPow {
  const u64* lo;        // w^j, j < 2^h
  const u64* hi;        // w^(j 2^h), j < m_dom >> h
  const u64* pw;        // (X, 2): a slot's adj mod m_dom and offset^adj
  long long first;      // the domain position of the fragment's point 0
  u64 mask;             // m_dom - 1
  int h, X;

  // the value of slot r at domain position i (below 2^32): two multiplies
  GL_FN u64 at(int r, u64 i) const {
    const u64 k = (frag_read(pw, 1, 2 * r, 0) * i) & mask;
    return gl_mul(frag_read(pw, 1, 2 * r + 1, 0),
                  gl_mul(frag_read(lo, 1, 0, (unsigned)(k & ((1ULL << h) - 1))),
                         frag_read(hi, 1, 0, (unsigned)(k >> h))));
  }
};

// A point's x^adj values, one slot each, written once before the
// constraints and read where a weight is made. On the card slot r of the
// thread is word r * kFragThreads + threadIdx.x of its block's shared
// array (`base`, a shared address, its first slot), each read a relaxed
// load, as a frame read is, so neither the compiler nor ptxas merges two
// reads of a slot and holds its value in registers. On the host, a plain
// array.
constexpr int kFragThreads = 128;    // the threads of a K5 block
#ifdef __CUDA_ARCH__
constexpr int kSlotStep = 8 * kFragThreads;   // a slot's row, in bytes
struct Slots {
  unsigned base;
  GL_FN void set(int r, u64 v) const {
    asm volatile("st.shared.u64 [%0], %1;"
                 :: "r"(base + r * kSlotStep), "l"(v) : "memory");
  }
  template <int R>
  GL_FN u64 get() const {
    u64 v;
    asm volatile("ld.relaxed.cta.shared.u64 %0, [%1+%2];"
                 : "=l"(v) : "r"(base), "n"(R * kSlotStep));
    return v;
  }
  GL_FN u64 get(int r) const {
    u64 v;
    asm volatile("ld.relaxed.cta.shared.u64 %0, [%1];"
                 : "=l"(v) : "r"(base + r * kSlotStep));
    return v;
  }
};
#else
struct Slots {
  u64* p;
  void set(int r, u64 v) const { p[r] = v; }
  template <int R>
  u64 get() const { return p[R]; }
  u64 get(int r) const { return p[r]; }
};
#endif

// What the merge reads beside the frame. idx holds, for each of the B
// assertions, its x^adj slot, then its divisor row, then its column (main
// columns first, aux columns after them).
struct MergeArgs {
  const u64* cc_t;      // (T, 2) transition coefficients
  const u64* cc_b;      // (B, 2) assertion coefficients
  const u64* bvals;     // (B,) asserted values
  const u64* zt;        // the fragment's 1 / transition divisor
  const u64* dinv;      // rows of 1 / (x - g^step), at row stride sd
  long long sd;
  XPow xp;
  const int* idx;
  int B;
};

// The weight of constraint k, c0_k + c1_k x^adj_k, is made where its
// value arrives, from its two coefficients and the slot of its degree
// class, so the whole point holds one accumulator (two registers), where
// a sum by degree class would hold one a class.
struct MergeOut {
  const u64* cc;        // (T, 2) transition coefficients
  Slots xs;             // the x^adj values; slot c is degree class c's
  u64 acc;              // sum_k (c0_k + c1_k x^adj_k) v_k

  template <int K, int CLS>
  GL_FN void put(u64 v) {
    const u64 w = gl_add(frag_read(cc, 1, 2 * K, 0),
                         gl_mul(frag_read(cc, 1, 2 * K + 1, 0),
                                xs.template get<CLS>()));
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

// The merged composition value of the point in.e, its x^adj values in
// `xs` (Air::kClasses + 1 slots at most: the assertions share one
// exponent, Air.boundary_adjustments).
template <class Air>
GL_FN u64 frag_merge_point(const FrameIn& in, const MergeArgs& a, Slots xs) {
  const long long e = in.e;
  const u64 i = (u64)(a.xp.first + e);
  // straight-line code: the assertions' loop stays the one loop of a point
#pragma unroll
  for (int r = 0; r < Air::kClasses; ++r) xs.set(r, a.xp.at(r, i));
  if (a.xp.X > Air::kClasses)
    xs.set(Air::kClasses, a.xp.at(Air::kClasses, i));
  MergeOut o{a.cc_t, xs, 0};
  Air::eval(in, o);
  u64 acc = gl_mul(o.acc, frag_read(a.zt, 0, 0, e));
  const int* bx = a.idx;
  const int* bd = bx + a.B;
  const int* bc = bd + a.B;
#pragma unroll 1
  for (int j = 0; j < a.B; ++j) {
    const int c = bc[j];
    const u64 col = c < Air::kMainWidth ? in.main_cur(c)
                                        : in.aux_cur(c - Air::kMainWidth);
    const u64 k = gl_add(frag_read(a.cc_b, 1, 2 * j, 0),
                         gl_mul(xs.get(bx[j]),
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

// Blocks an SM for the merge kernel: the register cap is 65 536 / (this
// x kFragThreads), 72. ptxas fits the generated MidenAir code in it with
// no spill, and 28 warps an SM wait on its multiplies' chains in turn
// (chip_smoke.py reads the registers and fails on a spill).
constexpr int kFragMinBlocks = 7;

// One point a thread. No grid-stride loop: what a loop would keep from
// one trip to the next (the rands, the coefficients) is read where it is
// used instead. The points' x^adj slots take (Air::kClasses + 1) x 128
// words of shared memory: 9 KB a block for MidenAir, 63 KB an SM.
template <class Air>
__global__ void __launch_bounds__(kFragThreads, kFragMinBlocks)
frag_merge_kernel(FrameIn in, MergeArgs a, u64* __restrict__ out,
                  long long m) {
  __shared__ u64 slots[(Air::kClasses + 1) * kFragThreads];
  in.e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const Slots xs{(unsigned)__cvta_generic_to_shared(slots + threadIdx.x)};
  if (in.e < m) out[in.e] = frag_merge_point<Air>(in, a, xs);
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
      const void *mt, long long smt, const void *at, long long sat,        \
      long long nb, const void *rands, const void *cc_t, const void *cc_b, \
      const void *bvals, const void *zt, const void *dinv, long long sd,   \
      const void *lo, const void *hi, const void *pw, int X, int h,        \
      long long m_dom, long long first, const void *idx, int B, void *out, \
      long long m, int mode, void *stream
#define FRAG_EVAL_ARGS                                                     \
  mc, smc, mn, smn, ac, sac, an, san, mt, smt, at, sat, nb, rands, cc_t,   \
      cc_b, bvals, zt, dinv, sd, lo, hi, pw, X, h, m_dom, first, idx, B,   \
      out, m, mode, stream

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
// The next-row frames take their first nb points from mn / an and the
// rest from the tails mt / at (nb = m: no tail).
template <class Air>
int frag_eval_launch(FRAG_EVAL_PARAMS) {
  if (B < 0 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  const long long strides[] = {smc, smn, sac, san, smt, sat, sd, m};
  for (long long st : strides)   // frag_read's strides and points
    if (st < 0 || st >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  if (nb < 0 || nb > m) return (int)cudaErrorInvalidValue;
  // the x^adj slots: one a degree class, then at most one more, positions
  // below m_dom, a power of two up to 2^32
  if (mode == 0 &&
      (X < Air::kClasses || X > Air::kClasses + 1 || m_dom <= 0 ||
       m_dom > (1LL << 32) || (m_dom & (m_dom - 1)) || h < 0 ||
       (1LL << h) > m_dom || first < 0 || first + m > m_dom))
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaSuccess;
  const FrameIn in{(const u64*)mc, (const u64*)mn, (const u64*)ac,
                   (const u64*)an, smc, smn, sac, san, (const u64*)mt,
                   (const u64*)at, smt, sat, nb, (const u64*)rands, 0};
  const long long blocks = (m + kFragThreads - 1) / kFragThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    const XPow xp{(const u64*)lo, (const u64*)hi, (const u64*)pw, first,
                  (u64)(m_dom - 1), h, X};
    const MergeArgs a{(const u64*)cc_t, (const u64*)cc_b, (const u64*)bvals,
                      (const u64*)zt, (const u64*)dinv, sd, xp,
                      (const int*)idx, B};
    frag_merge_kernel<Air><<<grid, kFragThreads, 0, s>>>(in, a, (u64*)out, m);
  } else {
    frag_store_kernel<Air><<<grid, kFragThreads, 0, s>>>(in, (u64*)out, m);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
