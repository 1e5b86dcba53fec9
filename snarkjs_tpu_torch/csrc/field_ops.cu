// K-field: elementwise mont_mul / add / sub / neg over (NL, B) limb arrays.
//
// Replaces snarkjs_tpu/fields/fpal.py:PalField (mont_mul -> _mm_kernel_fori,
// add -> _add_kernel, sub -> _sub_kernel, neg -> _neg_kernel, all launched
// through PalField._run's pallas_call).
//
// What bounds it on an H100: bytes.  mont_mul reads two and writes one
// (NL, B) array of 16-bit limbs in u32 words (12*NL bytes per element) and
// issues 4*N^2 + N 32-bit multiply instructions (N = NL/2, field.cuh:fmul);
// at NL = 16 that is 192 bytes against 264 multiplies, under the card's
// ratio of integer multiply rate to memory rate.  add/sub/neg are pure
// streams.
//
// Design: one thread per element, the whole element in registers as N
// 32-bit words (field.cuh), limb-major boundary layout so each warp's loads
// and stores of one limb row are coalesced.  No shared memory, no
// synchronisation; a grid-stride loop covers any B.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

enum Op { MONT_MUL = 0, ADD = 1, SUB = 2, NEG = 3 };

template <int N, int OP>
__global__ void field_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                             uint32_t* __restrict__ out, int64_t B, FieldP<N> f) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < B;
       j += (int64_t)gridDim.x * blockDim.x) {
    Fe<N> x = load_limbs16<N>(a, B, j);
    Fe<N> r;
    if (OP == NEG) {
      r = fneg<N>(x, f);
    } else {
      Fe<N> y = load_limbs16<N>(b, B, j);
      // b < p and a < R (to_mont hands limbs in [p, R) as a): fmul scans
      // its second operand word by word and may take that one wide
      if (OP == MONT_MUL) r = fmul<N>(y, x, f);
      if (OP == ADD) r = fadd<N>(x, y, f);
      if (OP == SUB) r = fsub<N>(x, y, f);
    }
    store_limbs16<N>(out, B, j, r);
  }
}

template <int N>
cudaError_t launch(int op, const void* a, const void* b, void* out, long long B,
                   const unsigned* p32, unsigned np0, const unsigned* one32, cudaStream_t stream) {
  FieldP<N> f;
  for (int i = 0; i < N; i++) {
    f.p[i] = p32[i];
    f.one[i] = one32[i];
  }
  f.np0 = np0;
  const int threads = 256;
  long long blocks = (B + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  auto A = static_cast<const uint32_t*>(a);
  auto Bp = static_cast<const uint32_t*>(b);
  auto O = static_cast<uint32_t*>(out);
  switch (op) {
    case MONT_MUL: field_kernel<N, MONT_MUL><<<blocks, threads, 0, stream>>>(A, Bp, O, B, f); break;
    case ADD: field_kernel<N, ADD><<<blocks, threads, 0, stream>>>(A, Bp, O, B, f); break;
    case SUB: field_kernel<N, SUB><<<blocks, threads, 0, stream>>>(A, Bp, O, B, f); break;
    case NEG: field_kernel<N, NEG><<<blocks, threads, 0, stream>>>(A, Bp, O, B, f); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// n32: words per element (8 or 12).  Returns the cudaError_t of the launch.
extern "C" int snark_field_op(int op, int n32, const void* a, const void* b, void* out,
                              long long B, const unsigned* p32, unsigned np0,
                              const unsigned* one32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n32 == 8) return (int)launch<8>(op, a, b, out, B, p32, np0, one32, s);
  if (n32 == 12) return (int)launch<12>(op, a, b, out, B, p32, np0, one32, s);
  return (int)cudaErrorInvalidValue;
}
