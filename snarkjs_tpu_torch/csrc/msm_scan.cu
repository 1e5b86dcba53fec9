// K-scan: per-lane suffix scan of complete mixed adds, the MSM's inner loop.
//
// Replaces snarkjs_tpu/curves/msm_tpu.py:_scan_kernel (K1).  Input xy is
// (nw, C, NIN, RL) u32: for window w, step c and lane l, the sorted affine
// point x || y as 32-bit words (two 16-bit limbs per word, the packed sort
// payload) and a key word mag*2 + sign; NIN = 2*N*EXT + 1.  Output is
// (nw, C, 3*N*EXT, RL): after step c the lane's running point
// sum_{c' >= c} (+-P_c') in projective (X, Y, Z), packed the same way.
// Each step is one RCB complete mixed add (rcb.rcb_madd: 11 products, two
// products by 3b and 14 adds), with y negated first on lanes whose key has
// the sign bit set.
//
// Where the TPU walked C as a sequential grid axis and carried the running
// point in VMEM scratch, blocks here run in no order: each thread owns one
// (window, lane) and loops over C itself, keeping the point in registers.
// A block is LT = 128 neighbouring lanes of one window; all windows of an
// MSM go into one launch (nw * ceil(RL / LT) blocks).
//
// What bounds it on an H100: integer multiply throughput.  A bn254 G1 step
// is 11 Montgomery products of 8 x 32-bit words (the two by 3b are an add
// ladder, fmul_small) at 4N^2 + N = 264 32-bit multiplies each (ptxas pairs
// each lo and hi into one IMAD.WIDE), against 28 words of traffic; a G2 step
// is 13 Fq2 products (3b is a full Fq2 element there), 39 over Fq.  The design:
// - field products as carry chains (field.cuh), so the instruction stream is
//   mostly the multiplies themselves;
// - the inputs of step c - 1 are copied into shared memory (cp.async, one
//   group a step, double-buffered) while step c computes, and x2, y2 and the
//   key are read from there where the formula uses them: the loads leave the
//   critical path and take no registers across the step.  Each thread copies
//   and reads only its own lane's column, so no block barrier is needed;
// - the mixed add evaluates its products in an order that keeps at most
//   seven coordinates live (rcb_madd below), rows are addressed by a running
//   pointer (advance), and __launch_bounds__ is set per instantiation, so
//   that the bn254 instantiations fit their registers without spilling.
#include <cuda_runtime.h>

#include <type_traits>

#include "field.cuh"

namespace {

constexpr int LT = 128;  // lanes (threads) per block

template <int N>
struct ScanP {
  FieldP<N> f;
  Fe2<N> b3;     // 3*b in Montgomery form (G2)
  int b3_small;  // G1: 3*b as a small integer (9 on bn254, 12 on bls12-381)
};

// Resident blocks an SM is asked to hold: the register budget of each
// instantiation (65536 / (LT * blocks) registers a thread at most, and 255).
template <int N, int EXT>
struct MinBlocks {
  static constexpr int value = EXT == 1 ? (N == 8 ? 3 : 2) : 2;
};

// p + d, as a value the compiler cannot see through: the rows of a step are
// walked with a running pointer, so no loop-invariant row offset (one per
// input and output row) is hoisted out of the step loop into a register.
template <typename P>
__device__ __forceinline__ P advance(P p, int64_t d) {
  p += d;
  asm volatile("" : "+l"(p));
  return p;
}

// Reads of the staged inputs are volatile: each use of x2 or y2 loads it
// again from shared memory instead of holding it in registers in between.
template <int N>
__device__ __forceinline__ void load_e(Fe<N>& x, const volatile uint32_t* p, int s) {
#pragma unroll
  for (int i = 0; i < N; i++) x.v[i] = p[i * s];
}
template <int N>
__device__ __forceinline__ void load_e(Fe2<N>& x, const volatile uint32_t* p, int s) {
  load_e<N>(x.c0, p, s);
  load_e<N>(x.c1, p + N * s, s);
}
template <int N>
__device__ __forceinline__ void store_e(uint32_t* p, int s, const Fe<N>& x) {
#pragma unroll
  for (int i = 0; i < N; i++) p[i * s] = x.v[i];
}
template <int N>
__device__ __forceinline__ void store_e(uint32_t* p, int s, const Fe2<N>& x) {
  store_e<N>(p, s, x.c0);
  store_e<N>(p + N * s, s, x.c1);
}

// fn on each base-field coordinate of x, in order
template <int N, typename F>
__device__ __forceinline__ void for_each_fe(const Fe<N>& x, F fn) {
  fn(x);
}
template <int N, typename F>
__device__ __forceinline__ void for_each_fe(const Fe2<N>& x, F fn) {
  fn(x.c0);
  fn(x.c1);
}

template <int N>
__device__ __forceinline__ Fe<N> mul_b3(const Fe<N>& a, const ScanP<N>& P) {
  return fmul_small<N>(a, P.b3_small, P.f);
}
template <int N>
__device__ __forceinline__ Fe2<N> mul_b3(const Fe2<N>& a, const ScanP<N>& P) {
  return fmul<N>(a, P.b3, P.f);
}

template <int N>
__device__ __forceinline__ void set_zero_one(Fe<N>& z, Fe<N>& o, const FieldP<N>& f) {
  z = fzero<N>();
  o = fone<N>(f);
}
template <int N>
__device__ __forceinline__ void set_zero_one(Fe2<N>& z, Fe2<N>& o, const FieldP<N>& f) {
  z.c0 = fzero<N>();
  z.c1 = fzero<N>();
  o.c0 = fone<N>(f);
  o.c1 = fzero<N>();
}

// One lane's staged step in shared memory: rows x2 | y2 | key, LT apart.
template <int N, typename T>
struct Staged {
  static constexpr int W = sizeof(T) / 4;
  uint32_t* s;
  __device__ __forceinline__ T x() const {
    T v;
    load_e<N>(v, s, LT);
    return v;
  }
  __device__ __forceinline__ T y() const {
    T v;
    load_e<N>(v, s + W * LT, LT);
    return v;
  }
  __device__ __forceinline__ uint32_t key() const {
    return *(const volatile uint32_t*)(s + 2 * W * LT);
  }
  // y2 <- -y2 (fsub(0, y2)) in place, on lanes whose key has the sign bit
  __device__ __forceinline__ void apply_sign(const FieldP<N>& f) const {
    if (key() & 1u) store_e<N>(s + W * LT, LT, fneg<N>(y(), f));
  }
};

// P + (x2, y2) with Z2 = 1: the operations of rcb.rcb_madd and _rcb_tail,
// each on the same operands (all canonical, so the words are the same in
// any order), in an order that frees X1, Y1, Z1 as early as possible and
// keeps at most seven coordinates live in the tail.
template <int N, typename T>
__device__ __forceinline__ void rcb_madd(T& X, T& Y, T& Z, const Staged<N, T>& in,
                                         const ScanP<N>& P) {
  const FieldP<N>& f = P.f;
  const T xy = fadd<N>(X, Y, f);
  const T t0 = fmul<N>(X, in.x(), f);
  const T u = fadd<N>(fmul<N>(in.x(), Z, f), X, f);
  const T t1 = fmul<N>(Y, in.y(), f);
  const T s = fadd<N>(fmul<N>(in.y(), Z, f), Y, f);
  const T m = fsub<N>(fsub<N>(fmul<N>(xy, fadd<N>(in.x(), in.y(), f), f), t0, f), t1, f);
  const T w = mul_b3<N>(Z, P);
  const T tm = fsub<N>(t1, w, f);
  const T tp = fadd<N>(t1, w, f);
  const T q = fadd<N>(fadd<N>(t0, t0, f), t0, f);
  const T B = mul_b3<N>(u, P);
  X = fmul<N>(m, tm, f);
  Z = fmul<N>(m, q, f);
  X = fsub<N>(X, fmul<N>(s, B, f), f);
  Z = fadd<N>(fmul<N>(s, tp, f), Z, f);
  Y = fmul<N>(tp, tm, f);
  Y = fadd<N>(Y, fmul<N>(B, q, f), f);
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}

template <int N, int EXT, typename T>
__global__ void __launch_bounds__(LT, MinBlocks<N, EXT>::value)
    scan_kernel(const uint32_t* __restrict__ xy, uint32_t* __restrict__ out, int C, int RL,
                int tiles, ScanP<N> P) {
  constexpr int W = N * EXT;  // words per coordinate
  constexpr int NIN = 2 * W + 1;
  constexpr int NOUT = 3 * W;
  extern __shared__ uint32_t stage[];  // [2][NIN][LT]
  const int w = blockIdx.x / tiles;
  const int lane = (blockIdx.x % tiles) * LT + threadIdx.x;
  if (lane >= RL) return;
  const uint32_t* src = xy + (int64_t)w * C * NIN * RL + lane;
  uint32_t* dst = out + (int64_t)w * C * NOUT * RL + lane;
  uint32_t* col = stage + threadIdx.x;

  // one commit group a step: this lane's NIN words of step c into buffer b
  auto fetch = [&](int c, int b) {
    const uint32_t* g = src + (int64_t)c * NIN * RL;
#pragma unroll
    for (int r = 0; r < NIN; r++) {
      cp_async4(col + (b * NIN + r) * LT, g);
      g = advance(g, RL);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  auto put = [&](uint32_t*& o, const Fe<N>& x) {
#pragma unroll
    for (int i = 0; i < N; i++) {
      *o = x.v[i];
      o = advance(o, RL);
    }
  };

  T X, Y, Z;
  set_zero_one<N>(X, Y, P.f);
  Z = X;
  fetch(C - 1, 0);
  for (int c = C - 1; c >= 0; c--) {
    const int b = (C - 1 - c) & 1;
    if (c > 0) {
      fetch(c - 1, b ^ 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    const Staged<N, T> in{col + b * NIN * LT};
    in.apply_sign(P.f);
    rcb_madd<N, T>(X, Y, Z, in, P);
    uint32_t* o = dst + (int64_t)c * NOUT * RL;
    for_each_fe(X, [&](const Fe<N>& x) { put(o, x); });
    for_each_fe(Y, [&](const Fe<N>& x) { put(o, x); });
    for_each_fe(Z, [&](const Fe<N>& x) { put(o, x); });
  }
}

template <int N, int EXT>
constexpr int smem_bytes() {
  return 2 * (2 * N * EXT + 1) * LT * 4;
}

template <int N, int EXT>
cudaError_t launch_ext(const void* xy, void* out, int nw, int C, int RL, const ScanP<N>& P,
                       cudaStream_t stream) {
  using T = typename std::conditional<EXT == 1, Fe<N>, Fe2<N>>::type;
  // set on every launch, for the current device's context: bls12-381 G2
  // needs more dynamic shared memory than the default 48 KB
  const cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<N, EXT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<N, EXT>());
  if (err != cudaSuccess) return err;
  const int tiles = (RL + LT - 1) / LT;
  const unsigned blocks = (unsigned)((int64_t)nw * tiles);
  scan_kernel<N, EXT, T><<<blocks, LT, smem_bytes<N, EXT>(), stream>>>(
      static_cast<const uint32_t*>(xy), static_cast<uint32_t*>(out), C, RL, tiles, P);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch(int ext, const void* xy, void* out, int nw, int C, int RL, const unsigned* p32,
                   unsigned np0, const unsigned* one32, const unsigned* b3_words, int b3_small,
                   cudaStream_t stream) {
  ScanP<N> P;
  for (int i = 0; i < N; i++) {
    P.f.p[i] = p32[i];
    P.f.one[i] = one32[i];
    P.b3.c0.v[i] = b3_words[i];
    P.b3.c1.v[i] = b3_words[N + i];
  }
  P.f.np0 = np0;
  P.b3_small = b3_small;
  if (ext == 1) return launch_ext<N, 1>(xy, out, nw, C, RL, P, stream);
  if (ext == 2) return launch_ext<N, 2>(xy, out, nw, C, RL, P, stream);
  return cudaErrorInvalidValue;
}

template <int N, int EXT>
cudaError_t attributes(int* regs, int* local_bytes) {
  using T = typename std::conditional<EXT == 1, Fe<N>, Fe2<N>>::type;
  cudaFuncAttributes a{};
  const cudaError_t err = cudaFuncGetAttributes(&a, scan_kernel<N, EXT, T>);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return err;
}

}  // namespace

// b3_words: 2*n32 words (c0 then c1).  Returns the cudaError_t of the launch.
extern "C" int snark_msm_scan(int n32, int ext, const void* xy, void* out, int nw, int C, int RL,
                              const unsigned* p32, unsigned np0, const unsigned* one32,
                              const unsigned* b3_words, int b3_small, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n32 == 8)
    return (int)launch<8>(ext, xy, out, nw, C, RL, p32, np0, one32, b3_words, b3_small, s);
  if (n32 == 12)
    return (int)launch<12>(ext, xy, out, nw, C, RL, p32, np0, one32, b3_words, b3_small, s);
  return (int)cudaErrorInvalidValue;
}

// Registers a thread and local memory a thread (spills and stack) of one
// instantiation, as the loaded module holds it.  Returns the cudaError_t.
extern "C" int snark_msm_scan_attributes(int n32, int ext, int* regs, int* local_bytes) {
  if (n32 == 8) return (int)(ext == 1 ? attributes<8, 1>(regs, local_bytes)
                                      : attributes<8, 2>(regs, local_bytes));
  if (n32 == 12) return (int)(ext == 1 ? attributes<12, 1>(regs, local_bytes)
                                       : attributes<12, 2>(regs, local_bytes));
  return (int)cudaErrorInvalidValue;
}
