// K-scan: per-lane suffix scan of complete mixed adds, the MSM's inner loop.
//
// Replaces snarkjs_tpu/curves/msm_tpu.py:_scan_kernel (K1).  Input xy is
// (nw, C, NIN, RL) u32: for window w, step c and lane l, the sorted affine
// point x || y as 32-bit words (two 16-bit limbs per word, the packed sort
// payload) and a key word mag*2 + sign; NIN = 2*N*EXT + 1.  Output is
// (nw, C, 3*N*EXT, RL): after step c the lane's running point
// sum_{c' >= c} (+-P_c') in projective (X, Y, Z), packed the same way.
// Each step is one RCB complete mixed add (rcb.rcb_madd, 11M + 14a; 9M when
// 3b is a small integer), with y
// negated first on lanes whose key has the sign bit set.
//
// Where the TPU walked C as a sequential grid axis and carried the running
// point in VMEM scratch, blocks here run in no order: each thread owns one
// (window, lane) and loops over C itself, keeping the point in registers.
// All windows of an MSM go into one launch, so nw * RL threads (16 * 8192 at
// the 2^20 Groth16 shape) fill the 132 SMs; RL is the lane count chosen by
// the glue.
//
// What bounds it on an H100: integer multiply throughput.  A bn254 G1 step
// is 9 Montgomery products of 8 x 32-bit words (the two 3b products are an
// add ladder, fmul_small; ~2.4k 32-bit multiply instructions) against 28
// words of traffic; a G2 step is 33 base-field products.  Registers bound the occupancy:
// the running point, the affine input and the Montgomery temporaries of
// G2 (Fq2, 2 x N words per coordinate) exceed what the SM can hold for many
// threads, and bls12-381 G2 (N = 12) spills to local memory (see the
// ptxas report in _build/msm_scan.log).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int N>
struct ScanP {
  FieldP<N> f;
  Fe2<N> b3;     // 3*b in Montgomery form (G1 uses b3.c0)
  int b3_small;  // G1 only: 3*b as a small integer (0 = use b3.c0)
};

template <int N>
__device__ __forceinline__ void load_e(Fe<N>& x, const uint32_t* p, int64_t s) {
  x = load_words<N>(p, s, 0);
}
template <int N>
__device__ __forceinline__ void load_e(Fe2<N>& x, const uint32_t* p, int64_t s) {
  x.c0 = load_words<N>(p, s, 0);
  x.c1 = load_words<N>(p + N * s, s, 0);
}
template <int N>
__device__ __forceinline__ void store_e(uint32_t* p, int64_t s, const Fe<N>& x) {
  store_words<N>(p, s, 0, x);
}
template <int N>
__device__ __forceinline__ void store_e(uint32_t* p, int64_t s, const Fe2<N>& x) {
  store_words<N>(p, s, 0, x.c0);
  store_words<N>(p + N * s, s, 0, x.c1);
}

template <int N>
__device__ __forceinline__ Fe<N> mul_b3(const Fe<N>& a, const ScanP<N>& P) {
  if (P.b3_small > 0) return fmul_small<N>(a, P.b3_small, P.f);
  return fmul<N>(a, P.b3.c0, P.f);
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

// P + (x2, y2) with Z2 = 1 (rcb.rcb_madd and _rcb_tail, same operation order)
template <int N, typename T>
__device__ __forceinline__ void rcb_madd(T& X1, T& Y1, T& Z1, const T& x2, const T& y2,
                                         const ScanP<N>& P) {
  const FieldP<N>& f = P.f;
  T t0 = fmul<N>(X1, x2, f);
  T t1 = fmul<N>(Y1, y2, f);
  T m = fsub<N>(fsub<N>(fmul<N>(fadd<N>(X1, Y1, f), fadd<N>(x2, y2, f), f), t0, f), t1, f);
  T s = fadd<N>(fmul<N>(y2, Z1, f), Y1, f);
  T u = fadd<N>(fmul<N>(x2, Z1, f), X1, f);
  T w = mul_b3<N>(Z1, P);
  T q = fadd<N>(fadd<N>(t0, t0, f), t0, f);
  T tm = fsub<N>(t1, w, f);
  T tp = fadd<N>(t1, w, f);
  T B = mul_b3<N>(u, P);
  X1 = fsub<N>(fmul<N>(m, tm, f), fmul<N>(s, B, f), f);
  Y1 = fadd<N>(fmul<N>(tp, tm, f), fmul<N>(B, q, f), f);
  Z1 = fadd<N>(fmul<N>(s, tp, f), fmul<N>(m, q, f), f);
}

template <int N, int EXT, typename T>
__global__ void __launch_bounds__(128) scan_kernel(const uint32_t* __restrict__ xy,
                                                   uint32_t* __restrict__ out, int nw, int C,
                                                   int RL, ScanP<N> P) {
  constexpr int W = N * EXT;  // words per coordinate
  constexpr int NIN = 2 * W + 1;
  constexpr int NOUT = 3 * W;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= (int64_t)nw * RL) return;
  const int64_t w = t / RL, lane = t % RL;
  T X, Y, Z, zero;
  set_zero_one<N>(X, Y, P.f);
  Z = X;
  zero = X;
  for (int c = C - 1; c >= 0; c--) {
    const uint32_t* in = xy + ((w * C + c) * NIN) * (int64_t)RL + lane;
    T x2, y2;
    load_e<N>(x2, in, RL);
    load_e<N>(y2, in + (int64_t)W * RL, RL);
    const uint32_t key = in[(int64_t)(NIN - 1) * RL];
    if (key & 1u) y2 = fsub<N>(zero, y2, P.f);
    rcb_madd<N, T>(X, Y, Z, x2, y2, P);
    uint32_t* o = out + ((w * C + c) * NOUT) * (int64_t)RL + lane;
    store_e<N>(o, RL, X);
    store_e<N>(o + (int64_t)W * RL, RL, Y);
    store_e<N>(o + (int64_t)2 * W * RL, RL, Z);
  }
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
  const int threads = 128;
  const int64_t total = (int64_t)nw * RL;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  auto in = static_cast<const uint32_t*>(xy);
  auto o = static_cast<uint32_t*>(out);
  if (ext == 1)
    scan_kernel<N, 1, Fe<N>><<<blocks, threads, 0, stream>>>(in, o, nw, C, RL, P);
  else if (ext == 2)
    scan_kernel<N, 2, Fe2<N>><<<blocks, threads, 0, stream>>>(in, o, nw, C, RL, P);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
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
