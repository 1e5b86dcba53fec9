// K-mm: the digit-product DFT matmul of the matmul NTT.
//
// Replaces snarkjs_tpu/ntt/ntt_mxu.py:_pallas_mm.  Computes
//     cols[c][k][x] = sum_{i+j=c} sum_y W8[i][k][y] * D8T[j][x][y]
// for W8 (nd, r, q) int8 and D8T (nd, m, q) int8 (the data digits with y
// contiguous) -> cols (2nd-1, r, m) int32.  Exact in int32:
// |column| < r * 2^14 * nd < 2^31 (ntt_mxu.py:22-25).
//
// What bounds it on an H100: operations.  At the 2^20 stage (r = q = m = 1024,
// nd = 33) it is nd^2 * r*q*m = 1.17e12 int8 products against 0.34 GB of
// traffic, so it runs on the int8 tensor cores (wgmma, digit_mma.cuh).
//
// Design: the columns are independent, so one block takes one 64 x 128 tile
// and 3 neighbouring columns, runs the shared main loop over their digit
// pairs and all of y with the sums in registers, and stores L int32 planes.
// Column c has min(c+1, 2nd-1-c) pairs, so blocks differ 33:1 in work: the
// grid is ordered from the middle columns outwards, the heavy blocks first.
// Edges are zero-filled in shared memory, so any r, q, m works.
#include <cuda_runtime.h>
#include <cstdint>

#include "digit_mma.cuh"

namespace {

using namespace digit_mma;
// 64 x 128 tiles, 3 live columns: the widest window whose 192 accumulators
// still leave two blocks to an SM
using MmTile = Tile<128, 3, 2>;

__global__ void __launch_bounds__(THREADS)
digit_mm_kernel(const int8_t* __restrict__ W, const int8_t* __restrict__ DT,
                const __grid_constant__ CUtensorMap mapW, const __grid_constant__ CUtensorMap mapD,
                bool tma, int32_t* __restrict__ out, int nd, int r, int q, int m, int tiles_x,
                int tiles, int groups) {
  extern __shared__ uint8_t dynamic_smem[];
  Ring rings = make_rings<MmTile>(dynamic_smem);
  // blockIdx.x = rank * tiles + tile; rank 0 is the middle column group
  const int rank = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int off = (rank + 1) >> 1;
  const int group = (rank & 1) ? groups / 2 - off : groups / 2 + off;
  const int c0 = group * MmTile::L;
  const int x0 = (tile % tiles_x) * MmTile::TX, k0 = (tile / tiles_x) * TK;

  int acc[MmTile::L][MmTile::ACC];
#pragma unroll
  for (int l = 0; l < MmTile::L; l++)
#pragma unroll
    for (int e = 0; e < MmTile::ACC; e++) acc[l][e] = 0;
  const Operands op{W, DT, &mapW, &mapD, tma};
  accumulate<MmTile>(acc, op, nd, r, q, m, k0, x0, c0, rings);

  const bool pairs = (m & 1) == 0;    // then (k, x even) is 8-byte aligned
#pragma unroll
  for (int l = 0; l < MmTile::L; l++) {
    if (c0 + l >= 2 * nd - 1) continue;
    int32_t* plane = out + (int64_t)(c0 + l) * r * m;
#pragma unroll
    for (int e = 0; e < MmTile::ACC; e += 2) {
      const int k = k0 + acc_row(e), x = x0 + acc_col(e);
      if (k >= r || x >= m) continue;
      int32_t* dst = plane + (int64_t)k * m + x;
      if (pairs) {
        *reinterpret_cast<int2*>(dst) = make_int2(acc[l][e], acc[l][e + 1]);
      } else {
        dst[0] = acc[l][e];
        if (x + 1 < m) dst[1] = acc[l][e + 1];
      }
    }
  }
}

int launch(const int8_t* W, const int8_t* DT, int32_t* out, int nd, int r, int q, int m,
           cudaStream_t stream) {
  const int tiles_x = (m + MmTile::TX - 1) / MmTile::TX;
  const int64_t tiles = (int64_t)tiles_x * ((r + TK - 1) / TK);
  const int groups = (2 * nd - 1 + MmTile::L - 1) / MmTile::L;
  if (tiles * groups > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  CUtensorMap mapW, mapD;
  bool tma;
  if (!make_maps<MmTile>(&mapW, &mapD, &tma, W, DT, nd, r, q, m)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(digit_mm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MmTile::SMEM);
  if (err != cudaSuccess) return (int)err;
  digit_mm_kernel<<<(unsigned)(tiles * groups), THREADS, MmTile::SMEM, stream>>>(
      W, DT, mapW, mapD, tma, out, nd, r, q, m, tiles_x, (int)tiles, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// W: (nd, r, q) int8; DT: (nd, m, q) int8; out: (2nd-1, r, m) int32.
extern "C" int snark_digit_mm(const void* W, const void* DT, void* out, int nd, int r, int q,
                              int m, void* stream) {
  if (nd <= 0 || r <= 0 || q <= 0 || m <= 0 || (reinterpret_cast<uintptr_t>(out) & 7))
    return (int)cudaErrorInvalidValue;
  return launch(static_cast<const int8_t*>(W), static_cast<const int8_t*>(DT),
                static_cast<int32_t*>(out), nd, r, q, m, static_cast<cudaStream_t>(stream));
}
