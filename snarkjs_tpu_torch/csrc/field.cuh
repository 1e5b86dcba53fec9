// Montgomery prime-field arithmetic for the card, shared by every kernel.
//
// Replaces the in-kernel field engine of the JAX package
// (snarkjs_tpu/fields/fpal.py: KernelField, KernelField2, _mm_body).
//
// Inside a thread an element of GF(p) is N 32-bit words (N = 8 for the
// 254/255-bit fields, 12 for bls12-381 Fq), little-endian, held in
// registers.  At the boundary the layout is the JAX one: (2N, B) arrays of
// 16-bit limbs in u32 words, limb-major, so limb i of element j sits at
// [i * B + j] and a warp reads 32 neighbouring elements of one limb at once.
// The Montgomery radix is R = 2^(32N) = 2^(16*2N), the same R as the 16-bit
// limb code, so values in Montgomery form are bit-identical to the JAX
// package's.
//
// Every multi-word add, subtract and product is a chain of PTX instructions
// that pass the carry in the condition code (add.cc / addc / sub.cc / subc /
// mad.lo.cc / madc.hi.cc), so a word step is one instruction and no 64-bit
// add or shift is left.  The fields here all have spare top bits (2p < R), so
// a sum of two canonical values needs no carry word.
//
// fmul is CIOS (coarsely integrated operand scanning) with the accumulator
// split in two: `ev` takes the products of the even words of `a` and `od`
// those of the odd words, one word higher.  Each product a[j]*b[i] then
// lands on two whole words of one array, so adding a*b[i] is two independent
// carry chains of N multiply-adds (lo, hi, lo, hi, ...), and so is adding
// m*p: 4N + O(1) instructions a row, 4N^2 + N multiplies in all.  After the
// reduction of a row the two arrays swap roles: the shift by one word is a
// renaming, and the one word it moves rides in the carry of the next row's
// chain.  Contract: a + p < R and a*b < p*R (a < p with any b < R, as
// to_mont of limbs in [p, R) needs, or a, b < 2p, since 4p < R for the
// fields used here); the running sum stays below a + p < R, and the result,
// below 2p before one conditional subtract, is canonical.
#pragma once
#include <cstdint>

template <int N>
struct FieldP {
  uint32_t p[N];   // modulus, 32-bit words
  uint32_t np0;    // -p^-1 mod 2^32
  uint32_t one[N]; // R mod p (Montgomery one)
};

template <int N>
struct Fe {
  uint32_t v[N];
};

template <int N>
struct Fe2 {
  Fe<N> c0, c1;
};

// ------------------------------------------------------------- carry chains
// One PTX instruction each.  A chain is a run of these calls with nothing
// between them that sets the carry; asm volatile keeps them in order.

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// -------------------------------------------------------------- boundary I/O

template <int N>
__device__ __forceinline__ Fe<N> load_limbs16(const uint32_t* src, int64_t stride, int64_t idx) {
  Fe<N> x;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint32_t lo = src[(2 * i) * stride + idx];
    uint32_t hi = src[(2 * i + 1) * stride + idx];
    x.v[i] = lo | (hi << 16);
  }
  return x;
}

template <int N>
__device__ __forceinline__ void store_limbs16(uint32_t* dst, int64_t stride, int64_t idx, const Fe<N>& x) {
#pragma unroll
  for (int i = 0; i < N; i++) {
    dst[(2 * i) * stride + idx] = x.v[i] & 0xFFFFu;
    dst[(2 * i + 1) * stride + idx] = x.v[i] >> 16;
  }
}

// ------------------------------------------------------------------ GF(p)

// x (< 2p) -> [0, p): subtract p, keep x where that borrows.
template <int N>
__device__ __forceinline__ Fe<N> reduce_once(const Fe<N>& x, const FieldP<N>& f) {
  Fe<N> d;
  d.v[0] = sub_cc(x.v[0], f.p[0]);
#pragma unroll
  for (int i = 1; i < N; i++) d.v[i] = subc_cc(x.v[i], f.p[i]);
  const uint32_t borrow = subc(0, 0);  // all ones when x < p
  Fe<N> r;
#pragma unroll
  for (int i = 0; i < N; i++) r.v[i] = borrow ? x.v[i] : d.v[i];
  return r;
}

template <int N>
__device__ __forceinline__ Fe<N> fadd(const Fe<N>& a, const Fe<N>& b, const FieldP<N>& f) {
  Fe<N> s;
  s.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < N - 1; i++) s.v[i] = addc_cc(a.v[i], b.v[i]);
  s.v[N - 1] = addc(a.v[N - 1], b.v[N - 1]);
  return reduce_once<N>(s, f);
}

// a - b, plus p where that borrows.
template <int N>
__device__ __forceinline__ Fe<N> fsub(const Fe<N>& a, const Fe<N>& b, const FieldP<N>& f) {
  Fe<N> d;
  d.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < N; i++) d.v[i] = subc_cc(a.v[i], b.v[i]);
  const uint32_t mask = subc(0, 0);
  Fe<N> r;
  r.v[0] = add_cc(d.v[0], f.p[0] & mask);
#pragma unroll
  for (int i = 1; i < N - 1; i++) r.v[i] = addc_cc(d.v[i], f.p[i] & mask);
  r.v[N - 1] = addc(d.v[N - 1], f.p[N - 1] & mask);
  return r;
}

// p - a, and 0 for a = 0 (= fsub(0, a)).
template <int N>
__device__ __forceinline__ Fe<N> fneg(const Fe<N>& a, const FieldP<N>& f) {
  Fe<N> d;
  d.v[0] = sub_cc(f.p[0], a.v[0]);
#pragma unroll
  for (int i = 1; i < N - 1; i++) d.v[i] = subc_cc(f.p[i], a.v[i]);
  d.v[N - 1] = subc(f.p[N - 1], a.v[N - 1]);
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < N; i++) any |= a.v[i];
#pragma unroll
  for (int i = 0; i < N; i++) d.v[i] = any ? d.v[i] : 0u;
  return d;
}

template <int N>
__device__ __forceinline__ Fe<N> fzero() {
  Fe<N> z;
#pragma unroll
  for (int i = 0; i < N; i++) z.v[i] = 0;
  return z;
}

template <int N>
__device__ __forceinline__ Fe<N> fone(const FieldP<N>& f) {
  Fe<N> z;
#pragma unroll
  for (int i = 0; i < N; i++) z.v[i] = f.one[i];
  return z;
}

// acc += sum_k x[2k]*y * 2^(64k): the products of every other word of x,
// each on its own two words of acc.  The carry out is left in the chain.
template <int N>
__device__ __forceinline__ void mad_pairs(uint32_t* acc, const uint32_t* x, uint32_t y) {
  acc[0] = mad_lo_cc(x[0], y, acc[0]);
  acc[1] = madc_hi_cc(x[0], y, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = madc_lo_cc(x[j], y, acc[j]);
    acc[j + 1] = madc_hi_cc(x[j], y, acc[j + 1]);
  }
}

// One CIOS row: T += a*bi, then T += m*p with m = T[0]*np0 so that T's low
// word is 0.  On entry T/2^32 = (od >> 32) + ev (the previous row, before
// its shift; `first`: T = 0); on return T = ev + od*2^32 with ev[0] = 0, and
// the caller swaps the two for the next row.
template <int N>
__device__ __forceinline__ void cios_row(uint32_t* ev, uint32_t* od, const uint32_t* a, uint32_t bi,
                                         const FieldP<N>& f, bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      const uint64_t e = (uint64_t)a[j] * bi, o = (uint64_t)a[j + 1] * bi;
      ev[j] = (uint32_t)e;
      ev[j + 1] = (uint32_t)(e >> 32);
      od[j] = (uint32_t)o;
      od[j + 1] = (uint32_t)(o >> 32);
    }
  } else {
    // ev takes od's word 1 (the shift); od drops two words while it takes
    // the odd products, with that add's carry at its bottom
    ev[0] = add_cc(ev[0], od[1]);
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {
      od[j] = madc_lo_cc(a[j + 1], bi, od[j + 2]);
      od[j + 1] = madc_hi_cc(a[j + 1], bi, od[j + 3]);
    }
    od[N - 2] = madc_lo_cc(a[N - 1], bi, 0);
    od[N - 1] = madc_hi(a[N - 1], bi, 0);
    mad_pairs<N>(ev, a, bi);
    od[N - 1] = addc(od[N - 1], 0);
  }
  const uint32_t m = ev[0] * f.np0;
  mad_pairs<N>(od, f.p + 1, m);  // no carry out: T < 2^32 (a + p) < 2^(32N + 32)
  mad_pairs<N>(ev, f.p, m);
  od[N - 1] = addc(od[N - 1], 0);
}

// Montgomery product a*b*R^-1 mod p (contract in the header note).
template <int N>
__device__ __forceinline__ Fe<N> fmul(const Fe<N>& a, const Fe<N>& b, const FieldP<N>& f) {
  uint32_t ev[N], od[N];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    cios_row<N>(ev, od, a.v, b.v[i], f, i == 0);
    cios_row<N>(od, ev, a.v, b.v[i + 1], f, false);
  }
  Fe<N> r;  // (od >> 32) + ev, below 2p
  r.v[0] = add_cc(ev[0], od[1]);
#pragma unroll
  for (int i = 1; i < N - 1; i++) r.v[i] = addc_cc(ev[i], od[i + 1]);
  r.v[N - 1] = addc(ev[N - 1], 0);
  return reduce_once<N>(r, f);
}

// k*a for a small non-negative integer k, by doubling and adding
// (Montgomery form is preserved under integer scaling).
template <int N>
__device__ __forceinline__ Fe<N> fmul_small(const Fe<N>& a, int k, const FieldP<N>& f) {
  Fe<N> acc = fzero<N>();
  Fe<N> run = a;
  while (k) {
    if (k & 1) acc = fadd<N>(acc, run, f);
    k >>= 1;
    if (k) run = fadd<N>(run, run, f);
  }
  return acc;
}

// ------------------------------------------------- GF(p^2) = GF(p)[u]/(u^2+1)
// Karatsuba with three products, the operation order of
// snarkjs_tpu/fields/fpal.py:KernelField2 (every intermediate is canonical,
// so any order gives the same limbs; taking the sums first costs bn254 G2
// K-scan 36 bytes of spills, this order none).

template <int N>
__device__ __forceinline__ Fe2<N> fadd(const Fe2<N>& a, const Fe2<N>& b, const FieldP<N>& f) {
  return {fadd<N>(a.c0, b.c0, f), fadd<N>(a.c1, b.c1, f)};
}

template <int N>
__device__ __forceinline__ Fe2<N> fsub(const Fe2<N>& a, const Fe2<N>& b, const FieldP<N>& f) {
  return {fsub<N>(a.c0, b.c0, f), fsub<N>(a.c1, b.c1, f)};
}

template <int N>
__device__ __forceinline__ Fe2<N> fneg(const Fe2<N>& a, const FieldP<N>& f) {
  return {fneg<N>(a.c0, f), fneg<N>(a.c1, f)};
}

template <int N>
__device__ __forceinline__ Fe2<N> fmul(const Fe2<N>& a, const Fe2<N>& b, const FieldP<N>& f) {
  const Fe<N> m0 = fmul<N>(a.c0, b.c0, f);
  const Fe<N> m1 = fmul<N>(a.c1, b.c1, f);
  const Fe<N> m2 = fmul<N>(fadd<N>(a.c0, a.c1, f), fadd<N>(b.c0, b.c1, f), f);
  return {fsub<N>(m0, m1, f), fsub<N>(m2, fadd<N>(m0, m1, f), f)};
}
