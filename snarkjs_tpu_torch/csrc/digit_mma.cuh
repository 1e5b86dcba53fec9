// The shared main loop of K-mm and K-mm-norm: the digit products of the matmul
// NTT on the H100's int8 tensor cores.
//
// For W8 (nd, r, q) int8 and D8T (nd, m, q) int8 (both with y, the summed
// index, contiguous: the K-major layout that 8-bit wgmma operands need) a
// block accumulates, for one TK x TX output tile and L neighbouring columns
// c0 .. c0+L-1,
//     acc[l][k][x] += sum_{i+j=c0+l} sum_y W8[i][k][y] * D8T[j][x][y]
// with wgmma.mma_async m64nTXk32 s32.s8.s8, both operands from shared memory,
// the int32 sums in registers of one warpgroup (128 threads).
//
// With one column at a time no tile would be used twice: a 64 x 128 tile
// would bring 1089 * (64 + 128) * q bytes through L2 into shared memory, whose
// bandwidth the wgmma operand reads already take most of.  So the loop
// slides a window over the digits: step i loads W8[i] and D8T[c0 - i] and
// multiplies W8[i] with the L tiles D8T[c0 - i .. c0 + L - 1 - i], of which
// L - 1 are still in the ring from the steps before.  One W and one D tile
// are loaded per L products; the L columns share every load.
//
// Two rings hold the tiles, P + 1 stages of W and P + L of D, each tile rows
// of 128 bytes of y in the 128-byte swizzle the wgmma descriptor names.  Tiles
// are filled P steps ahead by the tensor memory accelerator: one thread asks
// for a whole tile (zero-filled past r, m and q) and the copy reports to the
// stage's mbarrier, so no thread spends load instructions on operands.  A
// tensor map needs rows of a multiple of 16 bytes at a 16-byte aligned base;
// for any other q the threads fill the tiles themselves, byte by byte.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace digit_mma {

constexpr int TK = 64;         // output rows per tile: one warpgroup's wgmma M
constexpr int KY = 128;        // y bytes per tile row: one 128-byte swizzle row
constexpr int MMA_K = 32;      // y per wgmma
constexpr int THREADS = 128;   // one warpgroup

template <int TX_, int L_, int P_>
struct Tile {
  static constexpr int TX = TX_;             // output columns per tile: wgmma N
  static constexpr int L = L_;               // live product columns
  static constexpr int P = P_;               // steps loaded ahead
  static constexpr int SW = P + 1;           // stages of the W ring: a W tile serves one step
  static constexpr int SD = P + L;           // stages of the D ring: a D tile serves L steps
  static constexpr int ACC = TX / 2;         // accumulators per thread and column
  static constexpr int W_BYTES = TK * KY;
  static constexpr int D_BYTES = TX * KY;
  static constexpr int D_RING = SW * W_BYTES;              // offset of the D ring
  static constexpr int ZERO = D_RING + SD * D_BYTES;       // 1 KB of zeros after the rings
  static constexpr int BARS = ZERO + 1024;                 // SW + SD mbarriers
  static constexpr int SMEM = BARS + 8 * (SW + SD) + 1024;  // + slack to align the ring to 1024
  static_assert(TX == 64 || TX == 128, "wgmma wrappers exist for N = 64 and 128");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spins until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 3-d tensor map (y, row, digit) into shared memory; completes
// on the mbarrier with the box's bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int y,
                                         int row, int digit) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(y), "r"(row), "r"(digit)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving definitions of the accumulators into the
// span between wgmma_fence and wgmma_wait, where they would serialise the
// products.
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; e++) asm volatile("" : "+r"(d[e])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, groups of 8 rows `sbo` bytes apart (1024 for a tile; 0
// reads one group for all rows, which is how 1 KB of zeros serves as a whole
// zero tile), base aligned to 1024.  Adding 2 moves 32 bytes along y.
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr, int sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mma_n64(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void mma_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "n"(1));
}

template <int TX>
__device__ __forceinline__ void mma(int (&d)[TX / 2], uint64_t a, uint64_t b) {
  if constexpr (TX == 64) mma_n64(d, a, b);
  else mma_n128(d, a, b);
}

// ROWS x 128 bytes of one digit plane (rows of q bytes) into a swizzled tile,
// by all threads, byte by byte: rows row0.. of `nrows`, bytes y0.. of q, zero
// beyond either.  The way in for operands that no tensor map can describe.
template <int ROWS>
__device__ __forceinline__ void load_rows(uint32_t tile, const int8_t* plane, int row0, int nrows,
                                          int q, int y0) {
#pragma unroll
  for (int n = 0; n < ROWS * 8 / THREADS; n++) {
    const int id = threadIdx.x + n * THREADS;
    const int row = id >> 3, ch = id & 7;
    const int y = y0 + ch * 16;
    int bytes = q - y;
    bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
    if (row0 + row >= nrows) bytes = 0;
    const uint32_t dst = tile + row * KY + ((ch ^ (row & 7)) << 4);
    const int8_t* src = plane + (int64_t)(row0 + row) * q + y;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; b++)
      if (b < bytes) w[b >> 2] |= (uint32_t)(uint8_t)src[b] << (8 * (b & 3));
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(w[0]), "r"(w[1]),
                 "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// The operands of one launch: the planes, and their tensor maps where they
// allow one (`tma`); the maps live in the kernel's parameters.
struct Operands {
  const int8_t* W;          // (nd, r, q)
  const int8_t* DT;         // (nd, m, q)
  const CUtensorMap* mapW;  // boxes of (128 y, TK rows, 1 digit)
  const CUtensorMap* mapD;  // boxes of (128 y, TX rows, 1 digit)
  bool tma;
};

// A block's rings: their shared-memory address (aligned to 1024), the stage
// the next step takes in each, and the parity of those stages' barrier phases.
struct Ring {
  uint32_t base;
  int w, d;
  uint32_t pw, pd;
};

// acc[l] += column c0 + l of the tile at (k0, x0), l = 0 .. L-1.  Columns past
// 2nd - 2 get nothing.  Every thread of the block calls it, converged.
template <class T>
__device__ __forceinline__ void accumulate(int (&acc)[T::L][T::ACC], const Operands& op, int nd,
                                           int r, int q, int m, int k0, int x0, int c0,
                                           Ring& rings) {
  constexpr int L = T::L, P = T::P, SW = T::SW, SD = T::SD;
  // steps i_first .. i_last; those below 0 only bring in the D tiles that the
  // first products of columns c0+1 .. c0+L-1 need
  const int i_first = max(c0 - (nd - 1), -(L - 1));
  const int i_last = min(nd - 1, c0 + L - 1);
  if (i_last < i_first) return;
  const int steps = (i_last - i_first + 1) * ((q + KY - 1) / KY);
  const uint32_t ring = rings.base;
  const uint64_t zero = make_desc(ring + T::ZERO, 0);
  const uint32_t barW = ring + T::BARS, barD = barW + 8 * SW;

  __syncthreads();                    // the rings are free: every earlier product is done
  int li = i_first, ly = 0, lw = rings.w, ld = rings.d;   // the loader's digit, y chunk, stages
  auto load_step = [&]() {
    const int j = c0 - li;
    const bool has_d = j >= 0 && j < nd;
    const uint32_t wt = ring + lw * T::W_BYTES, dt = ring + T::D_RING + ld * T::D_BYTES;
    if (!op.tma) {
      if (li >= 0) load_rows<TK>(wt, op.W + (int64_t)li * r * q, k0, r, q, ly * KY);
      if (has_d) load_rows<T::TX>(dt, op.DT + (int64_t)j * m * q, x0, m, q, ly * KY);
    } else if (threadIdx.x == 0) {
      // every step completes one phase of both its barriers, tile or not
      if (li >= 0) {
        mbar_expect(barW + 8 * lw, T::W_BYTES);
        tma_load(wt, op.mapW, barW + 8 * lw, ly * KY, k0, li);
      } else {
        mbar_arrive(barW + 8 * lw);
      }
      if (has_d) {
        mbar_expect(barD + 8 * ld, T::D_BYTES);
        tma_load(dt, op.mapD, barD + 8 * ld, ly * KY, x0, j);
      } else {
        mbar_arrive(barD + 8 * ld);
      }
    }
    if (++li > i_last) { li = i_first; ly++; }
    if (++lw == SW) lw = 0;
    if (++ld == SD) ld = 0;
  };

#pragma unroll
  for (int p = 0; p < P; p++)
    if (p < steps) load_step();
  int ci = i_first, cw = rings.w, cd = rings.d;   // the products' digit and stages
  uint32_t pw = rings.pw, pd = rings.pd;          // ... and their barriers' phase parity
  for (int g = 0; g < steps; g++) {
    if (!op.tma) fence_proxy_async();  // tiles stored by threads, for the tensor cores
    __syncthreads();                  // step g-1's products are done, in every warp
    if (g + P < steps) load_step();   // into the stages steps g-1 and g-L used last
    if (op.tma) {
      mbar_wait(barW + 8 * cw, pw);
      mbar_wait(barD + 8 * cd, pd);
    }
    if (ci >= 0) {
      // L x 4 products in one straight line (branches between them would make
      // the compiler fence each one): a pair that does not exist multiplies
      // by the zero tile, and y past q is zero in the tiles themselves
      const uint64_t dw = make_desc(ring + cw * T::W_BYTES, 1024);
      uint64_t dd[L];
#pragma unroll
      for (int l = 0; l < L; l++) {
        const int j = c0 + l - ci;    // D8T[j] came in l steps ago
        const int ds = cd - l < 0 ? cd - l + SD : cd - l;
        dd[l] = (j >= 0 && j < nd) ? make_desc(ring + T::D_RING + ds * T::D_BYTES, 1024) : zero;
      }
#pragma unroll
      for (int l = 0; l < L; l++) fence_regs(acc[l]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KY / MMA_K; ks++)
#pragma unroll
        for (int l = 0; l < L; l++) mma<T::TX>(acc[l], dw + 2 * ks, dd[l] + 2 * ks);
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int l = 0; l < L; l++) fence_regs(acc[l]);
    }
    if (++ci > i_last) ci = i_first;
    if (++cw == SW) { cw = 0; pw ^= 1; }
    if (++cd == SD) { cd = 0; pd ^= 1; }
  }
  rings = Ring{ring, cw, cd, pw, pd};
}

// The block's rings inside its dynamic allocation of T::SMEM bytes: aligns
// them up to 1024, zeroes the zero tile behind them and arms the stages'
// mbarriers (one arrival each: the thread that asks for the tile).  Every
// thread of the block calls it once, before the first `accumulate`.
template <class T>
__device__ __forceinline__ Ring make_rings(const void* dynamic_smem) {
  const uint32_t ring = ((uint32_t)__cvta_generic_to_shared(dynamic_smem) + 1023u) & ~1023u;
  if (threadIdx.x < 64)
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(ring + T::ZERO +
                                                                     16 * threadIdx.x),
                 "r"(0)
                 : "memory");
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::SW + T::SD; s++) mbar_init(ring + T::BARS + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  return Ring{ring, 0, 0, 0u, 0u};
}

// Where accumulator e of a thread sits in the 64 x TX tile (the wgmma D
// fragment): registers 4n .. 4n+3 hold columns 8n + 2*(lane%4) + {0, 1} of
// rows 16*warp + lane/4 and that + 8.
__device__ __forceinline__ int acc_row(int e) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int e) {
  return 8 * (e >> 2) + 2 * (threadIdx.x & 3) + (e & 1);
}

// Tensor map of digit planes (nd, rows, q) int8 with boxes of (1, box_rows,
// 128 y) in the 128-byte swizzle.  False when cuTensorMapEncodeTiled fails.
inline bool encode_planes(CUtensorMap* map, const void* base, int nd, int rows, int q,
                          int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess || found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)q, (cuuint64_t)rows, (cuuint64_t)nd};
  const cuuint64_t strides[2] = {(cuuint64_t)q, (cuuint64_t)rows * q};
  const cuuint32_t box[3] = {KY, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Both maps of a launch; `tma` is false (and the maps unused) where q or a
// base does not allow them.  Returns false when a map that should encode
// does not.
template <class T>
inline bool make_maps(CUtensorMap* mapW, CUtensorMap* mapD, bool* tma, const void* W,
                      const void* DT, int nd, int r, int q, int m) {
  memset(mapW, 0, sizeof(CUtensorMap));
  memset(mapD, 0, sizeof(CUtensorMap));
  *tma = q % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(DT)) & 15) == 0;
  return !*tma || (encode_planes(mapW, W, nd, r, q, TK) && encode_planes(mapD, DT, nd, m, q, T::TX));
}

}  // namespace digit_mma
