// K-reduce: phase 2 of the MSM, from K-scan's suffix points to one partial
// point a window.
//
// Replaces the phase-2 reduction of snarkjs_tpu/curves/msm_tpu.py
// (TpuMSM._program.phase2, XLA code around the Pallas scan, no kernel of its
// own): the cross-lane carry (_suffix_excl), one complete add of that carry
// to each boundary row, and the halving tree (_tree_sum).  The port ran the
// same steps as RCB adds over K-field, one launch a field operation (about
// 960 launches a G1 MSM, 4,350 on G2); here they are four launches an MSM,
// whatever its size, curve or window width.
//
// Input st (nw, C, NO, RL) u32, NO = 3*N*EXT: K-scan's output, the running
// suffix point of window w, step c, lane l in projective (X, Y, Z) 32-bit
// words; dsort (nw, C*RL) i32: the sorted keys mag*2 + sign, position
// l*C + c.  For t = 1 .. half = 2^(cw-1), let i_t be the first position whose
// key is >= 2t (its magnitude >= t).  The window's partial is
//   sum over t with i_t < C*RL of ( st[w, i_t % C, :, i_t / C] + carry[i_t / C] ),
// carry[l] = sum_{l' > l} st[w, 0, :, l'] (the later lanes' totals): that is
// sum_t Suffix(i_t) = sum_b b*B_b.  Output (3*EXT*2N, nw) i32: the partials
// as 16-bit limb rows, the layout GpuMSM._finish reads.
//
//   1. lane_stage:   per block of LB lanes, a suffix scan of the lane totals
//                    (Hillis-Steele in shared memory, log2 LB adds); each
//                    lane's in-block exclusive suffix to `carry`, the
//                    block's total to `btot`;
//   2. carry_stage:  each block sums the totals of the later blocks of its
//                    window (a strided sum, then a tree) and adds that to
//                    each of its lanes' carry;
//   3. rows_stage:   a thread takes R rows t of one window: binary search
//                    of 2t in dsort, the row plus its lane's carry, added
//                    to a running sum; a tree over the block, the block's
//                    sum to `part`;
//   4. window_stage: one block a window sums its blocks' partials.
// The four are one kernel an instantiation (reduce_kernel), launched once a
// stage.
// Every add is the complete projective RCB add (rcb.rcb_add: 12 products,
// two by 3b), so no thread branches on the identity or on doubling; a row
// with no position (t above every magnitude) adds nothing.  The sums are
// taken in another order than the torch twin's, so the projective words
// differ and the affine points agree.
//
// What bounds it on an H100: IMADs, few of them.  bn254 G1 at the 2^22
// shapes (nw = 16, RL = 8192, half = 32768) is 2.0M adds, 6.3e9 IMADs,
// 0.38 ms at the IMAD peak (bls12-381 G2 8x that), and it runs at 4.7-6.5x
// that bound (PERF.md): few threads stay busy through the sum trees, whose
// longest path is about 3 log2 LB + 2R adds over four launches.  The
// design: a thread's point lives in its column of shared memory, and every
// add reads its operands there (or, for the carry, in device memory) where the
// formula uses them, as K-scan reads its staged inputs, so that the full
// add fits the registers (products ordered so that at most seven
// coordinates are live, rcb_add below).  The add is one function, not
// inlined, the four stages are one kernel an instantiation, and the G2 add
// calls one Fq2 product 14 times, so ptxas compiles little: the library
// builds in about 20 s (inlined at its nine call sites in four kernels a
// stage, the build took 12 minutes).
#include <cuda_runtime.h>

#include <type_traits>

#include "field.cuh"

namespace {

constexpr int LB = 64;  // threads a block: sum trees of 6 levels
constexpr int R = 4;    // rows a thread in rows_stage
constexpr int LAUNCHES = 4;

template <int N>
struct RedP {
  FieldP<N> f;
  Fe2<N> b3;     // 3*b in Montgomery form (G2)
  int b3_small;  // G1: 3*b as a small integer (9 on bn254, 12 on bls12-381)
};

// Resident blocks an SM is asked to hold: 65536 / (LB * blocks) registers a
// thread at most, and 255.
template <int N, int EXT>
struct MinBlocks {
  static constexpr int value = (N == 8 && EXT == 1) ? 6 : 4;
};

template <int N, int EXT>
using Elem = typename std::conditional<EXT == 1, Fe<N>, Fe2<N>>::type;

// Element loads and stores, word i of a coordinate at p[i * s].  Reads
// through a volatile pointer load again at each use.
template <int N>
__device__ __forceinline__ void load_e(Fe<N>& x, const volatile uint32_t* p, int64_t s) {
#pragma unroll
  for (int i = 0; i < N; i++) x.v[i] = p[i * s];
}
template <int N>
__device__ __forceinline__ void load_e(Fe2<N>& x, const volatile uint32_t* p, int64_t s) {
  load_e<N>(x.c0, p, s);
  load_e<N>(x.c1, p + N * s, s);
}
template <int N>
__device__ __forceinline__ void store_e(uint32_t* p, int64_t s, const Fe<N>& x) {
#pragma unroll
  for (int i = 0; i < N; i++) p[i * s] = x.v[i];
}
template <int N>
__device__ __forceinline__ void store_e(uint32_t* p, int64_t s, const Fe2<N>& x) {
  store_e<N>(p, s, x.c0);
  store_e<N>(p + N * s, s, x.c1);
}

// Points are NO = 3*N*EXT words, X, then Y, then Z; word j of a point at
// p[j * s].  A point of a thread lives in a column of shared memory (s = LB).
template <int NO>
__device__ __forceinline__ void copy_pt(uint32_t* dst, int64_t ds, const uint32_t* src,
                                        int64_t ss) {
#pragma unroll 4
  for (int j = 0; j < NO; j++) dst[j * ds] = src[j * ss];
}

// The identity (0 : 1 : 0), word j at p[j * s].
template <int N, int EXT>
__device__ __forceinline__ void put_identity(uint32_t* p, int64_t s, const FieldP<N>& f) {
  constexpr int NO = 3 * N * EXT;
#pragma unroll 4
  for (int j = 0; j < NO; j++) p[j * s] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) p[(N * EXT + i) * s] = f.one[i];
}

// One coordinate as 16-bit limb rows of a (rows, nw) array, column w.
template <int N>
__device__ __forceinline__ void put_limbs(uint32_t* out, int nw, int w, const Fe<N>& x) {
  store_limbs16<N>(out, nw, w, x);
}
template <int N>
__device__ __forceinline__ void put_limbs(uint32_t* out, int nw, int w, const Fe2<N>& x) {
  store_limbs16<N>(out, nw, w, x.c0);
  store_limbs16<N>(out + (int64_t)2 * N * nw, nw, w, x.c1);
}

// The products of the add: over Fq inlined; over Fq2 field.cuh's Karatsuba
// product in a function of its own, so that the G2 add holds 14 calls and
// not 42 inlined Montgomery products (those took most of the build, and ran
// slower: 9.2 against 6.3 ms on bn254 G2 at the 2^22 shape).
template <int N>
__device__ __forceinline__ Fe<N> mul(const Fe<N>& a, const Fe<N>& b, const FieldP<N>& f) {
  return fmul<N>(a, b, f);
}
template <int N>
__device__ __noinline__ Fe2<N> mul(const Fe2<N>& a, const Fe2<N>& b, const FieldP<N>& f) {
  return fmul<N>(a, b, f);
}

template <int N>
__device__ __forceinline__ Fe<N> mul_b3(const Fe<N>& a, const RedP<N>& P) {
  return fmul_small<N>(a, P.b3_small, P.f);
}
template <int N>
__device__ __forceinline__ Fe2<N> mul_b3(const Fe2<N>& a, const RedP<N>& P) {
  return mul<N>(a, P.b3, P.f);
}

// d = a + b: the operations of rcb.rcb_add, each on the same operands (all
// canonical, so the words are the same in any order).  a and d are columns
// of shared memory (d may be a: every read of a comes before the first
// write of d); b is a point anywhere, word j at b[j * bs].  The operands are
// read where the formula uses them, in an order that frees Z1, X1, Y1 as
// early as possible and keeps at most seven coordinates live.  Not inlined:
// each instantiation compiles one add, whatever the number of call sites.
template <int N, int EXT>
__device__ __noinline__ void rcb_add(uint32_t* d, const volatile uint32_t* a,
                                     const volatile uint32_t* b, int64_t bs, const RedP<N>& P) {
  using T = Elem<N, EXT>;
  constexpr int W = N * EXT;
  const FieldP<N>& f = P.f;
  const auto A = [&](int k) {
    T v;
    load_e<N>(v, a + k * W * LB, LB);
    return v;
  };
  const auto B = [&](int k) {
    T v;
    load_e<N>(v, b + k * W * bs, bs);
    return v;
  };
  const T t2 = mul<N>(A(2), B(2), f);
  const T t0 = mul<N>(A(0), B(0), f);
  const T u = fsub<N>(fsub<N>(mul<N>(fadd<N>(A(0), A(2), f), fadd<N>(B(0), B(2), f), f), t0, f),
                      t2, f);
  T s = fsub<N>(mul<N>(fadd<N>(A(1), A(2), f), fadd<N>(B(1), B(2), f), f), t2, f);
  T m = fsub<N>(mul<N>(fadd<N>(A(0), A(1), f), fadd<N>(B(0), B(1), f), f), t0, f);
  const T t1 = mul<N>(A(1), B(1), f);
  m = fsub<N>(m, t1, f);
  s = fsub<N>(s, t1, f);
  const T w = mul_b3<N>(t2, P);
  const T tm = fsub<N>(t1, w, f);
  const T tp = fadd<N>(t1, w, f);
  const T q3 = fadd<N>(fadd<N>(t0, t0, f), t0, f);
  const T B3 = mul_b3<N>(u, P);
  T X = mul<N>(m, tm, f);
  T Z = mul<N>(m, q3, f);
  X = fsub<N>(X, mul<N>(s, B3, f), f);
  Z = fadd<N>(mul<N>(s, tp, f), Z, f);
  store_e<N>(d, LB, X);
  store_e<N>(d + 2 * W * LB, LB, Z);
  T Y = mul<N>(tp, tm, f);
  Y = fadd<N>(Y, mul<N>(B3, q3, f), f);
  store_e<N>(d + W * LB, LB, Y);
}

// Sum the columns of buf (one point a thread) into column 0, in place, by a
// tree; every thread of the block calls it, and finds the sum in column 0.
template <int N, int EXT>
__device__ __forceinline__ void block_sum(uint32_t* buf, const RedP<N>& P) {
  __syncthreads();
#pragma unroll 1
  for (int k = LB / 2; k > 0; k /= 2) {
    if (threadIdx.x < k) rcb_add<N, EXT>(buf + threadIdx.x, buf + threadIdx.x,
                                         buf + threadIdx.x + k, LB, P);
    __syncthreads();
  }
}

// Sizes of one call: the blocks a window of each launch, and the words of
// each scratch array.
struct Sizes {
  int NB, NRB;
  int64_t carry, btot, part;
};

Sizes sizes(int no, int nw, int RL, int half) {
  Sizes z;
  z.NB = (RL + LB - 1) / LB;
  z.NRB = (half + LB * R - 1) / (LB * R);
  z.carry = (int64_t)nw * no * RL;
  z.btot = (int64_t)nw * no * z.NB;
  z.part = (int64_t)nw * no * z.NRB;
  return z;
}

struct Args {
  const uint32_t* st;   // (nw, C, NO, RL) K-scan's output
  const int32_t* dsort; // (nw, C*RL) sorted keys
  uint32_t* carry;      // (nw, NO, RL)
  uint32_t* btot;       // (nw, NO, NB)
  uint32_t* part;       // (nw, NO, NRB)
  uint32_t* out;        // (3*EXT*2N, nw) 16-bit limbs
  int nw, C, RL, half, NB, NRB;
};

// 1. Per block of LB lanes, the inclusive suffix of the lane totals
// (Hillis-Steele over two buffers); each lane's in-block exclusive suffix
// to carry, the block's total to btot.
template <int N, int EXT>
__device__ __forceinline__ void lane_stage(const Args& a, uint32_t* buf, const RedP<N>& P) {
  constexpr int NO = 3 * N * EXT;
  const int w = blockIdx.x / a.NB, b = blockIdx.x % a.NB;
  const int i = threadIdx.x, lane = b * LB + i, RL = a.RL;
  uint32_t* cur = buf;
  uint32_t* nxt = buf + NO * LB;
  if (lane < RL)
    copy_pt<NO>(cur + i, LB, a.st + (int64_t)w * a.C * NO * RL + lane, RL);  // step c = 0
  else
    put_identity<N, EXT>(cur + i, LB, P.f);
  __syncthreads();
#pragma unroll 1
  for (int k = 1; k < LB; k *= 2) {
    if (i + k < LB)
      rcb_add<N, EXT>(nxt + i, cur + i, cur + i + k, LB, P);
    else
      copy_pt<NO>(nxt + i, LB, cur + i, LB);
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (i == 0) copy_pt<NO>(a.btot + (int64_t)w * NO * a.NB + b, a.NB, cur, LB);
  if (lane >= RL) return;
  uint32_t* cl = a.carry + (int64_t)w * NO * RL + lane;
  if (i + 1 < LB)
    copy_pt<NO>(cl, RL, cur + i + 1, LB);
  else
    put_identity<N, EXT>(cl, RL, P.f);
}

// 2. Each block sums the totals of its window's later blocks and adds that
// to each of its lanes' carry.
template <int N, int EXT>
__device__ __forceinline__ void carry_stage(const Args& a, uint32_t* buf, const RedP<N>& P) {
  constexpr int NO = 3 * N * EXT;
  const int w = blockIdx.x / a.NB, b = blockIdx.x % a.NB;
  const int i = threadIdx.x, lane = b * LB + i;
  uint32_t* mine = buf + i;
  uint32_t* stg = buf + NO * LB + i;
  put_identity<N, EXT>(mine, LB, P.f);
  const uint32_t* tots = a.btot + (int64_t)w * NO * a.NB;
#pragma unroll 1
  for (int j = b + 1 + i; j < a.NB; j += LB) {
    copy_pt<NO>(stg, LB, tots + j, a.NB);
    rcb_add<N, EXT>(mine, mine, stg, LB, P);
  }
  block_sum<N, EXT>(buf, P);
  if (lane >= a.RL) return;
  uint32_t* cl = a.carry + (int64_t)w * NO * a.RL + lane;
  copy_pt<NO>(stg, LB, cl, a.RL);
  rcb_add<N, EXT>(stg, stg, buf, LB, P);
  copy_pt<NO>(cl, a.RL, stg, LB);
}

// First index of the sorted keys[0 .. n) that is >= v (torch.searchsorted).
__device__ __forceinline__ int64_t lower_bound(const int32_t* keys, int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (keys[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// 3. A thread takes R rows t of one window: the row plus its lane's carry,
// added to its running sum; the block's sum to part.
template <int N, int EXT>
__device__ __forceinline__ void rows_stage(const Args& a, uint32_t* buf, const RedP<N>& P) {
  constexpr int NO = 3 * N * EXT;
  const int w = blockIdx.x / a.NRB, rb = blockIdx.x % a.NRB, RL = a.RL;
  const int64_t Np = (int64_t)a.C * RL;
  const int32_t* keys = a.dsort + w * Np;
  const uint32_t* sw = a.st + (int64_t)w * a.C * NO * RL;
  const uint32_t* cy = a.carry + (int64_t)w * NO * RL;
  uint32_t* acc = buf + threadIdx.x;
  uint32_t* stg = buf + NO * LB + threadIdx.x;
  put_identity<N, EXT>(acc, LB, P.f);
#pragma unroll 1
  for (int r = 0; r < R; r++) {
    const int t = (rb * R + r) * LB + threadIdx.x + 1;
    if (t > a.half) break;
    const int64_t i = lower_bound(keys, Np, 2 * (int64_t)t);
    if (i >= Np) break;  // no magnitude reaches t, nor any later t
    const int64_t lane = i / a.C, c = i % a.C;
    copy_pt<NO>(stg, LB, sw + c * NO * RL + lane, RL);
    rcb_add<N, EXT>(stg, stg, cy + lane, RL, P);
    rcb_add<N, EXT>(acc, acc, stg, LB, P);
  }
  block_sum<N, EXT>(buf, P);
  if (threadIdx.x == 0)
    copy_pt<NO>(a.part + (int64_t)w * NO * a.NRB + rb, a.NRB, buf, LB);
}

// 4. One block a window sums its row blocks' partials and writes the
// window's partial as 16-bit limbs: coordinate k, component e, limb q at row
// (k*EXT + e)*2N + q, column w.
template <int N, int EXT>
__device__ __forceinline__ void window_stage(const Args& a, uint32_t* buf, const RedP<N>& P) {
  using T = Elem<N, EXT>;
  constexpr int NO = 3 * N * EXT, W = N * EXT;
  const int w = blockIdx.x;
  uint32_t* mine = buf + threadIdx.x;
  uint32_t* stg = buf + NO * LB + threadIdx.x;
  put_identity<N, EXT>(mine, LB, P.f);
  const uint32_t* parts = a.part + (int64_t)w * NO * a.NRB;
#pragma unroll 1
  for (int j = threadIdx.x; j < a.NRB; j += LB) {
    copy_pt<NO>(stg, LB, parts + j, a.NRB);
    rcb_add<N, EXT>(mine, mine, stg, LB, P);
  }
  block_sum<N, EXT>(buf, P);
  if (threadIdx.x != 0) return;
  constexpr int64_t ROWS = 2 * N * EXT;
#pragma unroll 1
  for (int k = 0; k < 3; k++) {
    T x;
    load_e<N>(x, buf + k * W * LB, LB);
    put_limbs<N>(a.out + k * ROWS * a.nw, a.nw, w, x);
  }
}

// One kernel an instantiation, launched once a stage: ptxas then compiles
// the add once an instantiation.
template <int N, int EXT>
__global__ void __launch_bounds__(LB, MinBlocks<N, EXT>::value)
    reduce_kernel(Args a, RedP<N> P, int stage) {
  __shared__ uint32_t buf[2 * 3 * N * EXT * LB];  // two columns a thread
  switch (stage) {
    case 0: lane_stage<N, EXT>(a, buf, P); break;
    case 1: carry_stage<N, EXT>(a, buf, P); break;
    case 2: rows_stage<N, EXT>(a, buf, P); break;
    default: window_stage<N, EXT>(a, buf, P); break;
  }
}

template <int N, int EXT>
cudaError_t launch_ext(Args a, const RedP<N>& P, cudaStream_t stream) {
  const Sizes z = sizes(3 * N * EXT, a.nw, a.RL, a.half);
  a.NB = z.NB;
  a.NRB = z.NRB;
  uint32_t* scratch = a.carry;
  a.btot = scratch + z.carry;
  a.part = a.btot + z.btot;
  const unsigned grids[LAUNCHES] = {(unsigned)(a.nw * z.NB), (unsigned)(a.nw * z.NB),
                                    (unsigned)(a.nw * z.NRB), (unsigned)a.nw};
  for (int stage = 0; stage < LAUNCHES; stage++) {
    reduce_kernel<N, EXT><<<grids[stage], LB, 0, stream>>>(a, P, stage);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int N>
cudaError_t launch(int ext, const Args& a, const unsigned* p32, unsigned np0,
                   const unsigned* one32, const unsigned* b3_words, int b3_small,
                   cudaStream_t stream) {
  RedP<N> P;
  for (int i = 0; i < N; i++) {
    P.f.p[i] = p32[i];
    P.f.one[i] = one32[i];
    P.b3.c0.v[i] = b3_words[i];
    P.b3.c1.v[i] = b3_words[N + i];
  }
  P.f.np0 = np0;
  P.b3_small = b3_small;
  if (ext == 1) return launch_ext<N, 1>(a, P, stream);
  if (ext == 2) return launch_ext<N, 2>(a, P, stream);
  return cudaErrorInvalidValue;
}

template <int N, int EXT>
cudaError_t attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes at{};
  const cudaError_t err = cudaFuncGetAttributes(&at, reduce_kernel<N, EXT>);
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return err;
}

}  // namespace

// Words of device scratch a call with these sizes needs (the carry of every
// lane, the block totals, the row blocks' partials); -1 for a field width
// other than 8 or 12 words.
extern "C" long long snark_msm_reduce_scratch(int n32, int ext, int nw, int RL, int half) {
  if ((n32 != 8 && n32 != 12) || (ext != 1 && ext != 2)) return -1;
  const Sizes z = sizes(3 * n32 * ext, nw, RL, half);
  return z.carry + z.btot + z.part;
}

// Kernels a call launches.
extern "C" int snark_msm_reduce_launches() { return LAUNCHES; }

// st: (nw, C, 3*n32*ext, RL) u32, dsort: (nw, C*RL) i32, scratch: as many
// words as snark_msm_reduce_scratch says, out: (3*ext*2*n32, nw) i32.
// b3_words: 2*n32 words (c0 then c1).  Returns the cudaError_t of the launches.
extern "C" int snark_msm_reduce(int n32, int ext, const void* st, const void* dsort, void* scratch,
                                void* out, int nw, int C, int RL, int half, const unsigned* p32,
                                unsigned np0, const unsigned* one32, const unsigned* b3_words,
                                int b3_small, void* stream) {
  Args a{static_cast<const uint32_t*>(st), static_cast<const int32_t*>(dsort),
         static_cast<uint32_t*>(scratch), nullptr, nullptr, static_cast<uint32_t*>(out),
         nw, C, RL, half, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n32 == 8) return (int)launch<8>(ext, a, p32, np0, one32, b3_words, b3_small, s);
  if (n32 == 12) return (int)launch<12>(ext, a, p32, np0, one32, b3_words, b3_small, s);
  return (int)cudaErrorInvalidValue;
}

// Registers a thread and local memory a thread (spills and stack) of the
// kernel of one instantiation, as the loaded module holds it.  Returns the
// cudaError_t.
extern "C" int snark_msm_reduce_attributes(int n32, int ext, int* regs, int* local_bytes) {
  if (n32 == 8) return (int)(ext == 1 ? attributes<8, 1>(regs, local_bytes)
                                      : attributes<8, 2>(regs, local_bytes));
  if (n32 == 12) return (int)(ext == 1 ? attributes<12, 1>(regs, local_bytes)
                                       : attributes<12, 2>(regs, local_bytes));
  return (int)cudaErrorInvalidValue;
}
