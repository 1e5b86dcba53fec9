// K-mm: the digit-product DFT matmul of the matmul NTT.
//
// Replaces snarkjs_tpu/ntt/ntt_mxu.py:_pallas_mm.  Computes
//     cols[c][k][x] = sum_{i+j=c} sum_y W8[i][k][y] * D8[j][y][x]
// for W8 (nd, r, q) int8, D8 (nd, q, m) int8 -> cols (2nd-1, r, m) int32.
// Exact in int32: |column| < r * 2^14 * nd < 2^31 (ntt_mxu.py:22-25).
//
// What bounds it on an H100: operations.  At the 2^20 Groth16 stage
// (r = q = m = 1024, nd = 33) it is nd^2 * r*q*m = 1.17e12 int8 products
// against 0.34 GB of traffic, far on the compute side of the card.  The
// ideal engine is the int8 tensor core (wgmma / mma.sync s8); this first
// version uses dp4a (four int8 products per instruction on the CUDA cores)
// and so sits well below that roofline.
//
// Design: one block per (64 x 64 output tile, column c), 256 threads, each
// thread 4 x 4 outputs spaced 16 apart (coalesced stores, conflict-free
// shared reads).  For each valid digit pair (i, c - i) the block walks y in
// chunks of 32: it stages a 64 x 32 slab of W8[i] and a 32 x 64 slab of
// D8[c - i] in shared memory, both packed four y-values per int, and every
// thread runs 8 x 16 dp4a.  Edges are zero-filled, so any r, q, m works
// (the small four-step stages have r or m down to 4).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 64;
constexpr int KY = 32;          // y values per chunk
constexpr int KG = KY / 4;      // packed ints per chunk row
constexpr int PAD = KG + 1;

__global__ void digit_mm_kernel(const int8_t* __restrict__ W, const int8_t* __restrict__ D,
                                int32_t* __restrict__ out, int nd, int r, int q, int m) {
  __shared__ int Ws[TILE][PAD];  // [k][y/4]
  __shared__ int Ds[TILE][PAD];  // [x][y/4]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int x0 = blockIdx.x * TILE, k0 = blockIdx.y * TILE, c = blockIdx.z;
  int acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; u++)
#pragma unroll
    for (int v = 0; v < 4; v++) acc[u][v] = 0;

  const int ilo = c - (nd - 1) > 0 ? c - (nd - 1) : 0;
  const int ihi = c < nd - 1 ? c : nd - 1;
  for (int i = ilo; i <= ihi; i++) {
    const int j = c - i;
    const int8_t* Wi = W + (int64_t)i * r * q;
    const int8_t* Dj = D + (int64_t)j * q * m;
    for (int y0 = 0; y0 < q; y0 += KY) {
      // 64 x 8 packed ints per slab, two per thread for each slab
      for (int e = threadIdx.x; e < TILE * KG; e += blockDim.x) {
        const int row = e / KG, g = e % KG;
        uint32_t wv = 0, dv = 0;
#pragma unroll
        for (int b = 0; b < 4; b++) {
          const int y = y0 + g * 4 + b;
          const int k = k0 + row, x = x0 + row;
          uint8_t wb = (k < r && y < q) ? (uint8_t)Wi[(int64_t)k * q + y] : 0;
          uint8_t db = (x < m && y < q) ? (uint8_t)Dj[(int64_t)y * m + x] : 0;
          wv |= (uint32_t)wb << (8 * b);
          dv |= (uint32_t)db << (8 * b);
        }
        Ws[row][g] = (int)wv;
        Ds[row][g] = (int)dv;
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < KG; g++) {
        int a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; u++) a[u] = Ws[ty + 16 * u][g];
#pragma unroll
        for (int v = 0; v < 4; v++) b[v] = Ds[tx + 16 * v][g];
#pragma unroll
        for (int u = 0; u < 4; u++)
#pragma unroll
          for (int v = 0; v < 4; v++) acc[u][v] = __dp4a(a[u], b[v], acc[u][v]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int u = 0; u < 4; u++) {
    const int k = k0 + ty + 16 * u;
    if (k >= r) continue;
#pragma unroll
    for (int v = 0; v < 4; v++) {
      const int x = x0 + tx + 16 * v;
      if (x < m) out[((int64_t)c * r + k) * m + x] = acc[u][v];
    }
  }
}

}  // namespace

extern "C" int snark_digit_mm(const void* W, const void* D, void* out, int nd, int r, int q,
                              int m, void* stream) {
  dim3 grid((m + TILE - 1) / TILE, (r + TILE - 1) / TILE, 2 * nd - 1);
  digit_mm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(W), static_cast<const int8_t*>(D), static_cast<int32_t*>(out),
      nd, r, q, m);
  return (int)cudaGetLastError();
}
