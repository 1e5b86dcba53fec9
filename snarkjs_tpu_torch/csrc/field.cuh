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
// mont_mul is CIOS (coarsely integrated operand scanning) with 32x32->64-bit
// products.  It accepts a < R and b < p (the JAX code's contract: to_mont of
// a segment sum gets limbs in [p, R)) and returns the canonical value in
// [0, p): the running sum stays below a + p < 2R, so one extra word and one
// conditional subtract suffice.
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

// Packed rows: one u32 word holds limbs (2i, 2i+1), i.e. 32-bit word i.
template <int N>
__device__ __forceinline__ Fe<N> load_words(const uint32_t* src, int64_t stride, int64_t idx) {
  Fe<N> x;
#pragma unroll
  for (int i = 0; i < N; i++) x.v[i] = src[i * stride + idx];
  return x;
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* dst, int64_t stride, int64_t idx, const Fe<N>& x) {
#pragma unroll
  for (int i = 0; i < N; i++) dst[i * stride + idx] = x.v[i];
}

// ------------------------------------------------------------------ GF(p)

// r = a - b over N words; returns the borrow out (0 or 1).
template <int N>
__device__ __forceinline__ uint32_t sub_words(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

template <int N>
__device__ __forceinline__ uint32_t add_words(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t s = (uint64_t)a[i] + b[i] + carry;
    r[i] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  return carry;
}

// carry*2^(32N) + x  (< 2p)  ->  [0, p)
template <int N>
__device__ __forceinline__ Fe<N> cond_sub_p(const Fe<N>& x, uint32_t carry, const FieldP<N>& f) {
  Fe<N> d;
  uint32_t borrow = sub_words<N>(d.v, x.v, f.p);
  bool use_d = (carry != 0) || (borrow == 0);
  Fe<N> r;
#pragma unroll
  for (int i = 0; i < N; i++) r.v[i] = use_d ? d.v[i] : x.v[i];
  return r;
}

template <int N>
__device__ __forceinline__ Fe<N> fadd(const Fe<N>& a, const Fe<N>& b, const FieldP<N>& f) {
  Fe<N> s;
  uint32_t carry = add_words<N>(s.v, a.v, b.v);
  return cond_sub_p<N>(s, carry, f);
}

template <int N>
__device__ __forceinline__ Fe<N> fsub(const Fe<N>& a, const Fe<N>& b, const FieldP<N>& f) {
  Fe<N> d, fixed;
  uint32_t borrow = sub_words<N>(d.v, a.v, b.v);
  add_words<N>(fixed.v, d.v, f.p);
  Fe<N> r;
#pragma unroll
  for (int i = 0; i < N; i++) r.v[i] = borrow ? fixed.v[i] : d.v[i];
  return r;
}

template <int N>
__device__ __forceinline__ Fe<N> fneg(const Fe<N>& a, const FieldP<N>& f) {
  Fe<N> d;
  sub_words<N>(d.v, f.p, a.v);
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

// Montgomery product a*b*R^-1 mod p (CIOS), a < R, b < p.
template <int N>
__device__ __forceinline__ Fe<N> fmul(const Fe<N>& a, const Fe<N>& b, const FieldP<N>& f) {
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * f.np0;
    s = (uint64_t)m * f.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)m * f.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  Fe<N> r;
#pragma unroll
  for (int i = 0; i < N; i++) r.v[i] = t[i];
  return cond_sub_p<N>(r, t[N], f);
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

template <int N>
__device__ __forceinline__ Fe<N> fselect(bool m, const Fe<N>& a, const Fe<N>& b) {
  Fe<N> r;
#pragma unroll
  for (int i = 0; i < N; i++) r.v[i] = m ? a.v[i] : b.v[i];
  return r;
}

// ------------------------------------------------- GF(p^2) = GF(p)[u]/(u^2+1)
// Karatsuba with three products, the operation order of
// snarkjs_tpu/fields/fpal.py:KernelField2 (every intermediate is canonical,
// so any order gives the same limbs; this one keeps the two in step).

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
  Fe<N> m0 = fmul<N>(a.c0, b.c0, f);
  Fe<N> m1 = fmul<N>(a.c1, b.c1, f);
  Fe<N> m2 = fmul<N>(fadd<N>(a.c0, a.c1, f), fadd<N>(b.c0, b.c1, f), f);
  return {fsub<N>(m0, m1, f), fsub<N>(m2, fadd<N>(m0, m1, f), f)};
}

template <int N>
__device__ __forceinline__ Fe2<N> fselect(bool m, const Fe2<N>& a, const Fe2<N>& b) {
  return {fselect<N>(m, a.c0, b.c0), fselect<N>(m, a.c1, b.c1)};
}
