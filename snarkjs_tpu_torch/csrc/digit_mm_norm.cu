// K-mm-norm: the digit-product DFT matmul of the matmul NTT with the column
// normalisation fused as its epilogue.
//
// Replaces snarkjs_tpu/ntt/ntt_mxu.py:_pallas_mm_norm.  For W8 (nd, r, q) int8
// and D8 (nd, q, m) int8 it computes the 2nd-1 product columns
//     cols[c][k][x] = sum_{i+j=c} sum_y W8[i][k][y] * D8[j][y][x]
// and, without writing them anywhere, reduces sum_c cols[c]*256^c mod p to
// (nl, r, m) canonical 16-bit limbs in [0, p): signed carry to u8 digits,
// balanced recode of the high digits, fold with the 2^(8(n8+h)) mod p table,
// compensation constant, Barrett, two conditional subtracts (the steps of
// ntt_mm._normalize_cols, in int32).  The per-field tables come in a struct
// passed as a kernel argument, so they sit in the constant bank.
//
// What bounds it on an H100: operations, the same nd^2 * r*q*m int8 products
// as K-mm; the traffic is W8 + D8 in and nl*r*m words out, the column planes
// no longer move.  Like K-mm this version runs dp4a on the CUDA cores, well
// below the int8 tensor-core roofline.
//
// Design: a TPU kernel kept the (2nd-1, kt, mt) columns in scratch across a
// sequential grid axis; blocks here run in no order, so one thread owns one
// output (k, x) and all 2nd-1 = 65 of its columns as registers: the i, j
// loops are fully unrolled and acc[i + j] never becomes a local-memory array.
// A block is 8 rows x 32 columns of outputs (one warp per row: the W8 value
// is a shared-memory broadcast, the D8 values are consecutive words).  Per
// chunk of 32 y-values the block stages all nd digit planes of its W8 rows
// and D8 columns in shared memory, four y-values packed per int, and every
// thread runs nd^2 dp4a per packed int.  Edges are zero-filled, so any r, q,
// m works (the four-step stages go down to r or m = 4); rows of 4 bytes are
// loaded as words where q or m is a multiple of 4.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int TK = 8;           // output rows per block (one warp each)
constexpr int TX = 32;          // output columns per block
constexpr int KY = 32;          // y values per chunk
constexpr int KG = KY / 4;      // packed ints per chunk

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

template <int N8>
__device__ __forceinline__ void normalize_store(const int (&acc)[2 * N8 + 1],
                                                const NormConsts<N8>& K, int32_t* out,
                                                int64_t plane) {
  using C = NormConsts<N8>;
  constexpr int NC = C::NC, NCAP = C::NCAP, NH = C::NH, NL = C::NL;
  // 1) signed carry-normalise to u8 digits
  int digs[NCAP];
  int carry = 0;
#pragma unroll
  for (int i = 0; i < NCAP; i++) {
    const int v = (i < NC ? acc[i] : 0) + carry;
    digs[i] = v & 0xFF;
    carry = v >> 8;
  }
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

template <int N8>
__global__ void __launch_bounds__(TK * TX)
digit_mm_norm_kernel(const int8_t* __restrict__ W, const int8_t* __restrict__ D,
                     int32_t* __restrict__ out, int r, int q, int m,
                     const NormConsts<N8> K) {
  constexpr int ND = N8 + 1;
  __shared__ int Ws[ND][TK][KG];              // [i][k][y/4]
  __shared__ __align__(16) int Ds[ND][KG][TX];  // [j][y/4][x]
  const int tx = threadIdx.x & (TX - 1), tk = threadIdx.x / TX;
  const int x0 = blockIdx.x * TX, k0 = blockIdx.y * TK;
  const bool w_words = (q & 3) == 0, d_words = (m & 3) == 0;

  int acc[2 * ND - 1];
#pragma unroll
  for (int c = 0; c < 2 * ND - 1; c++) acc[c] = 0;

  for (int y0 = 0; y0 < q; y0 += KY) {
    // W8 rows of this block: ND x TK x KG packed ints, y contiguous in memory
    for (int e = threadIdx.x; e < ND * TK * KG; e += TK * TX) {
      const int g = e % KG, row = (e / KG) % TK, i = e / (KG * TK);
      const int k = k0 + row, y = y0 + 4 * g;
      uint32_t wv = 0;
      if (k < r && y < q) {
        const int8_t* src = W + ((int64_t)i * r + k) * q + y;
        if (w_words) {
          wv = *reinterpret_cast<const uint32_t*>(src);
        } else {
#pragma unroll
          for (int b = 0; b < 4; b++)
            if (y + b < q) wv |= (uint32_t)(uint8_t)src[b] << (8 * b);
        }
      }
      Ws[i][row][g] = (int)wv;
    }
    // D8 columns of this block: ND x KG x TX packed ints, x contiguous in memory
    if (d_words) {
      // four rows of four x-values each, transposed in registers
      for (int e = threadIdx.x; e < ND * KG * (TX / 4); e += TK * TX) {
        const int x4 = e % (TX / 4), g = (e / (TX / 4)) % KG, j = e / ((TX / 4) * KG);
        const int x = x0 + 4 * x4, y = y0 + 4 * g;
        uint32_t a[4] = {0, 0, 0, 0};
        if (x < m) {
#pragma unroll
          for (int b = 0; b < 4; b++)
            if (y + b < q)
              a[b] = *reinterpret_cast<const uint32_t*>(D + ((int64_t)j * q + y + b) * m + x);
        }
        const uint32_t lo01 = __byte_perm(a[0], a[1], 0x5140);
        const uint32_t lo23 = __byte_perm(a[2], a[3], 0x5140);
        const uint32_t hi01 = __byte_perm(a[0], a[1], 0x7362);
        const uint32_t hi23 = __byte_perm(a[2], a[3], 0x7362);
        int4 o;
        o.x = (int)__byte_perm(lo01, lo23, 0x5410);
        o.y = (int)__byte_perm(lo01, lo23, 0x7632);
        o.z = (int)__byte_perm(hi01, hi23, 0x5410);
        o.w = (int)__byte_perm(hi01, hi23, 0x7632);
        *reinterpret_cast<int4*>(&Ds[j][g][4 * x4]) = o;
      }
    } else {
      for (int e = threadIdx.x; e < ND * KG * TX; e += TK * TX) {
        const int xx = e % TX, g = (e / TX) % KG, j = e / (TX * KG);
        const int x = x0 + xx, y = y0 + 4 * g;
        uint32_t dv = 0;
        if (x < m) {
#pragma unroll
          for (int b = 0; b < 4; b++)
            if (y + b < q)
              dv |= (uint32_t)(uint8_t)D[((int64_t)j * q + y + b) * m + x] << (8 * b);
        }
        Ds[j][g][xx] = (int)dv;
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int g = 0; g < KG; g++) {
      int d[ND];
#pragma unroll
      for (int j = 0; j < ND; j++) d[j] = Ds[j][g][tx];
#pragma unroll
      for (int i = 0; i < ND; i++) {
        const int w = Ws[i][tk][g];
#pragma unroll
        for (int j = 0; j < ND; j++) acc[i + j] = __dp4a(w, d[j], acc[i + j]);
      }
    }
    __syncthreads();
  }

  const int k = k0 + tk, x = x0 + tx;
  if (k < r && x < m)
    normalize_store<N8>(acc, K, out + (int64_t)k * m + x, (int64_t)r * m);
}

}  // namespace

// consts: a NormConsts<32> image (F bytes padded to a multiple of 4, then the
// p limbs, the compensation limbs and mu as 32-bit words), built by the caller
// for its field.  Only n8 = 32 (nd = 33: both Fr fields) is instantiated.
extern "C" int snark_digit_mm_norm(const void* W, const void* D, void* out, int nd, int r, int q,
                                   int m, const void* consts, int consts_bytes, void* stream) {
  using C = NormConsts<32>;
  if (nd != C::ND || consts_bytes != (int)sizeof(C) || r <= 0 || q <= 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  C K;
  std::memcpy(&K, consts, sizeof(C));
  dim3 grid((m + TX - 1) / TX, (r + TK - 1) / TK);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  digit_mm_norm_kernel<32><<<grid, TK * TX, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(W), static_cast<const int8_t*>(D), static_cast<int32_t*>(out),
      r, q, m, K);
  return (int)cudaGetLastError();
}

extern "C" int snark_digit_mm_norm_consts_bytes() { return (int)sizeof(NormConsts<32>); }
