// K-mm-norm: the digit-product DFT matmul of the matmul NTT with the column
// normalisation fused as its epilogue.
//
// Replaces snarkjs_tpu/ntt/ntt_mxu.py:_pallas_mm_norm.  For W8 (nd, r, q) int8
// and D8T (nd, m, q) int8 (the data digits with y contiguous) it computes the
// 2nd-1 product columns
//     cols[c][k][x] = sum_{i+j=c} sum_y W8[i][k][y] * D8T[j][x][y]
// and, without writing them anywhere as int32, reduces sum_c cols[c]*256^c
// mod p to (nl, r, m) canonical 16-bit limbs in [0, p): signed carry to u8
// digits, balanced recode of the high digits, fold with the 2^(8(n8+h)) mod p
// table, compensation constant, Barrett, two conditional subtracts (the steps
// of ntt_mm._normalize_cols, in int32).  The per-field tables come in a
// struct passed as a kernel argument, so they sit in the constant bank.
//
// What bounds it on an H100: operations, the same nd^2 * r*q*m int8 products
// as K-mm, on the int8 tensor cores (wgmma, digit_mma.cuh); the traffic is
// W8 + D8T in and nl*r*m words out.
//
// Design: a TPU kernel kept the (2nd-1, kt, mt) columns in scratch across a
// sequential grid axis.  Here a loop inside the block takes that axis: a
// block owns a 64 x TX tile and walks its columns upwards, L at a time, with
// the shared main loop.  The carry pass of the normalisation runs over the
// columns in that same order, so each finished column is retired at once:
// its low byte is the digit, the rest is added to the next column's
// accumulator (the carry needs no registers of its own).  The digits, one
// byte per output and column, go to a scratch of the block in device memory
// that only the writing thread reads back: 68 bytes an output in place of 260
// for the int32 columns, written once and read once.  When the last column is
// retired, every thread reduces its outputs from those bytes (steps 2-5).
// Blocks walk the tiles persistently, so the scratch is one slot per block.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "digit_mma.cuh"

namespace {

using namespace digit_mma;
// 64 x 64 tiles, so that the 1024 x 1024 outputs of a 2^20 stage make 256
// blocks, two to an SM; six live columns, the most the registers hold.
using NormTile = Tile<64, 6, 2>;
template <int N8>
struct NormConsts {
  static constexpr int ND = N8 + 1;        // signed digits per element
  static constexpr int NC = 2 * ND - 1;    // product columns
  static constexpr int NCAP = NC + 3;      // digits after the carry pass
  static constexpr int NH = NCAP - N8;     // high digits to fold
  static constexpr int NL = N8 / 2;        // 16-bit limbs
  static constexpr int SHIFT = N8 * 8 - 6; // Barrett shift
  int8_t F[((NH + 1) * (N8 + 1) + 3) & ~3];  // F[h][d]: digits of 2^(8(n8+h)) mod p
  int32_t p[NL + 1];                       // p as 16-bit limbs, then 0
  int32_t c[NL + 1];                       // 128*(nh+1)*p as 16-bit limbs
  uint32_t mu;                             // floor(2^(32+SHIFT) / p)
};

// Steps 2-5 on the NCAP u8 digits that the carry pass (step 1) left: digit c
// of this output is digs[c * stride].
template <int N8>
__device__ __forceinline__ void normalize_store(const uint8_t* digs_at, int64_t stride,
                                                const NormConsts<N8>& K, int32_t* out,
                                                int64_t plane) {
  using C = NormConsts<N8>;
  constexpr int NCAP = C::NCAP, NH = C::NH, NL = C::NL;
  int digs[NCAP];
#pragma unroll
  for (int i = 0; i < NCAP; i++) digs[i] = digs_at[i * stride];
  // 2) balanced-recode the high digits, fold with the table
  int hs[NH + 1];
  int hc = 0;
#pragma unroll
  for (int d = 0; d < NH; d++) {
    const int v = digs[N8 + d] + hc;
    const int mneg = v >= 128 ? 1 : 0;
    hs[d] = v - 256 * mneg;
    hc = mneg;
  }
  hs[NH] = hc;
  int fold[N8 + 1];
#pragma unroll
  for (int dd = 0; dd <= N8; dd++) {
    int s = 0;
#pragma unroll
    for (int h = 0; h <= NH; h++) s += hs[h] * (int)K.F[h * (N8 + 1) + dd];
    fold[dd] = s;
  }
  // 3) 16-bit limbs plus the compensation constant, signed carries
  int limbs[NL + 1];
  int cc = 0;
#pragma unroll
  for (int i = 0; i <= NL; i++) {
    const int d0 = 2 * i < N8 ? digs[2 * i] : 0;
    const int d1 = 2 * i + 1 < N8 ? digs[2 * i + 1] : 0;
    const int f0 = 2 * i < N8 + 1 ? fold[2 * i] : 0;
    const int f1 = 2 * i + 1 < N8 + 1 ? fold[2 * i + 1] : 0;
    const int v = d0 + f0 + (d1 + f1) * 256 + K.c[i] + cc;
    limbs[i] = v & 0xFFFF;
    cc = v >> 16;
  }
  // 4) Barrett: q_hat = ((V >> SHIFT) * mu) >> 32, V -= q_hat * p
  constexpr int SL = C::SHIFT / 16, SB = C::SHIFT % 16;
  int T = limbs[SL] >> SB;
#pragma unroll
  for (int j = SL + 1; j <= NL; j++) {
    if (16 * (j - SL) - SB < 22) T |= limbs[j] << (16 * (j - SL) - SB);
  }
  const int mu_lo = (int)(K.mu & 0xFFFF), mu_hi = (int)(K.mu >> 16);
  const int T_lo = T & 0xFFFF, T_hi = T >> 16;
  const int mid = T_lo * mu_hi + T_hi * mu_lo +
                  (int)(((uint32_t)T_lo * (uint32_t)mu_lo) >> 16);
  const int qv = T_hi * mu_hi + (mid >> 16);
  const uint32_t q_lo = (uint32_t)(qv & 0xFFFF), q_hi = (uint32_t)(qv >> 16);
  int outv[NL + 1];
  {
    uint32_t sc = 0;
    int bb = 0;
#pragma unroll
    for (int i = 0; i <= NL; i++) {
      const uint32_t pim = i >= 1 ? (uint32_t)K.p[i - 1] : 0u;
      const uint32_t sv = q_lo * (uint32_t)K.p[i] + q_hi * pim + sc;
      sc = sv >> 16;
      const int v = limbs[i] - (int)(sv & 0xFFFF) - bb;
      outv[i] = v & 0xFFFF;
      bb = (v >> 16) & 1;
    }
  }
  // 5) two conditional subtracts of p: V in [0, ~3p) -> [0, p)
#pragma unroll
  for (int rep = 0; rep < 2; rep++) {
    int diff[NL + 1];
    int b2 = 0;
#pragma unroll
    for (int i = 0; i <= NL; i++) {
      const int v = outv[i] - K.p[i] - b2;
      diff[i] = v & 0xFFFF;
      b2 = (v >> 16) & 1;
    }
#pragma unroll
    for (int i = 0; i <= NL; i++) outv[i] = b2 ? outv[i] : diff[i];
  }
#pragma unroll
  for (int l = 0; l < NL; l++) out[(int64_t)l * plane] = outv[l];
}

// Scratch of one block: digit c of accumulator e of thread t is byte e % 4 of
// word (c * (ACC / 4) + e / 4) * THREADS + t.
constexpr int SCRATCH_WORDS = NormConsts<32>::NCAP * (NormTile::ACC / 4) * THREADS;

template <int N8>
__global__ void __launch_bounds__(THREADS)
digit_mm_norm_kernel(const int8_t* __restrict__ W, const int8_t* __restrict__ DT,
                     const __grid_constant__ CUtensorMap mapW,
                     const __grid_constant__ CUtensorMap mapD, bool tma,
                     int32_t* __restrict__ out, uint32_t* scratch, int r, int q, int m,
                     int tiles_x, int tiles, const NormConsts<N8> K) {
  using C = NormConsts<N8>;
  constexpr int L = NormTile::L, ACC = NormTile::ACC;
  extern __shared__ uint8_t dynamic_smem[];
  Ring rings = make_rings<NormTile>(dynamic_smem);
  const Operands op{W, DT, &mapW, &mapD, tma};
  uint32_t* mine = scratch + (int64_t)blockIdx.x * SCRATCH_WORDS + threadIdx.x;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int x0 = (tile % tiles_x) * NormTile::TX, k0 = (tile / tiles_x) * TK;
    int acc[L][ACC];
#pragma unroll
    for (int l = 0; l < L; l++)
#pragma unroll
      for (int e = 0; e < ACC; e++) acc[l][e] = 0;

    for (int c0 = 0; c0 < C::NCAP; c0 += L) {
      // acc[0] comes in holding the carry out of column c0 - 1
      accumulate<NormTile>(acc, op, C::ND, r, q, m, k0, x0, c0, rings);
      // 1) retire the columns in order: digit = low byte, the rest carries on
#pragma unroll
      for (int l = 0; l < L; l++) {
        const int c = c0 + l;
        const int nxt = l + 1 < L ? l + 1 : 0;
#pragma unroll
        for (int e4 = 0; e4 < ACC / 4; e4++) {
          uint32_t word = 0;
#pragma unroll
          for (int b = 0; b < 4; b++) {
            const int e = 4 * e4 + b;
            const int v = acc[l][e];
            word |= (uint32_t)(v & 0xFF) << (8 * b);
            if (l > 0) acc[l][e] = 0;
            if (l + 1 < L) acc[nxt][e] += v >> 8;
            else acc[0][e] = v >> 8;
          }
          if (c < C::NCAP) mine[(c * (ACC / 4) + e4) * THREADS] = word;
        }
      }
    }
    // 2-5) every output of this thread from its digits
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(mine);
#pragma unroll 1
    for (int e = 0; e < ACC; e++) {
      const int k = k0 + acc_row(e), x = x0 + acc_col(e);
      if (k < r && x < m)
        normalize_store<N8>(bytes + (e >> 2) * THREADS * 4 + (e & 3), (ACC / 4) * THREADS * 4, K,
                            out + (int64_t)k * m + x, (int64_t)r * m);
    }
  }
}

// Blocks of one launch: one per tile, at most two per SM (two rings fit one
// SM's shared memory); they walk the tiles.
int norm_blocks(int r, int m) {
  const int64_t tiles = (int64_t)((m + NormTile::TX - 1) / NormTile::TX) * ((r + TK - 1) / TK);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
    return 0;
  const int64_t resident = (int64_t)sms * 2;
  return (int)(tiles < resident ? tiles : resident);
}

int launch(const int8_t* W, const int8_t* DT, int32_t* out, void* scratch, long long scratch_bytes,
           int r, int q, int m, const NormConsts<32>& K, cudaStream_t stream) {
  const int blocks = norm_blocks(r, m);
  if (blocks <= 0 || scratch_bytes < (long long)blocks * SCRATCH_WORDS * 4 ||
      (reinterpret_cast<uintptr_t>(scratch) & 3))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (m + NormTile::TX - 1) / NormTile::TX;
  const int64_t tiles = (int64_t)tiles_x * ((r + TK - 1) / TK);
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  CUtensorMap mapW, mapD;
  bool tma;
  if (!make_maps<NormTile>(&mapW, &mapD, &tma, W, DT, NormConsts<32>::ND, r, q, m))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(digit_mm_norm_kernel<32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, NormTile::SMEM);
  if (err != cudaSuccess) return (int)err;
  digit_mm_norm_kernel<32><<<blocks, THREADS, NormTile::SMEM, stream>>>(
      W, DT, mapW, mapD, tma, out, static_cast<uint32_t*>(scratch), r, q, m, tiles_x, (int)tiles,
      K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long snark_digit_mm_norm_scratch_bytes(int r, int m) {
  return (long long)norm_blocks(r, m) * SCRATCH_WORDS * 4;
}

// W: (nd, r, q) int8; DT: (nd, m, q) int8; out: (nl, r, m) int32; scratch:
// snark_digit_mm_norm_scratch_bytes(r, m) bytes, aligned to 4.
// consts: a NormConsts<32> image (F bytes padded to a multiple of 4, then the
// p limbs, the compensation limbs and mu as 32-bit words), built by the caller
// for its field.  Only n8 = 32 (nd = 33: both Fr fields) is instantiated.
extern "C" int snark_digit_mm_norm(const void* W, const void* DT, void* out, void* scratch,
                                   long long scratch_bytes, int nd, int r, int q, int m,
                                   const void* consts, int consts_bytes, void* stream) {
  using C = NormConsts<32>;
  if (nd != C::ND || consts_bytes != (int)sizeof(C) || r <= 0 || q <= 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  C K;
  std::memcpy(&K, consts, sizeof(C));
  return launch(static_cast<const int8_t*>(W), static_cast<const int8_t*>(DT),
                          static_cast<int32_t*>(out), scratch, scratch_bytes, r, q, m, K,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int snark_digit_mm_norm_consts_bytes() { return (int)sizeof(NormConsts<32>); }
