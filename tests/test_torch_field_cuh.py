"""The card's field arithmetic (csrc/field.cuh), K-scan's mixed add
(csrc/msm_scan.cu) and K-reduce's kernel (csrc/msm_reduce.cu, four stages),
compiled for the host with g++.

The sources are CUDA; what keeps them from a host compiler is only the PTX of
the carry-chain steps and the kernel around the mixed add.  Here each carry
step becomes a C function on an explicit carry flag, the same source is
compiled as C++, and its results are held against Python bigints (fadd,
fsub, fneg, fmul, fmul with a wide operand) and against `msm_gpu.scan_plain`
(the scan step by step, y negated on signed lanes), word for word.  K-reduce's
stages run whole, each block as LB threads of the host meeting at a barrier
for `__syncthreads()`, blocks one after another, and their window partials
are held against `msm_gpu.reduce_plain` as affine points.
"""

import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from snarkjs_tpu_torch.curves import host_curve as hc
from snarkjs_tpu_torch.curves import msm_gpu
from snarkjs_tpu_torch.fields import fcuda, ftorch
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "snarkjs_tpu_torch", "csrc")

# the PTX carry steps of field.cuh, on an explicit carry flag
CARRY_STEPS = r"""
static uint32_t CF;
static inline uint32_t add_cc(uint32_t a, uint32_t b) { uint64_t s = (uint64_t)a + b; CF = s >> 32; return (uint32_t)s; }
static inline uint32_t addc_cc(uint32_t a, uint32_t b) { uint64_t s = (uint64_t)a + b + CF; CF = s >> 32; return (uint32_t)s; }
static inline uint32_t addc(uint32_t a, uint32_t b) { return (uint32_t)((uint64_t)a + b + CF); }
static inline uint32_t sub_cc(uint32_t a, uint32_t b) { uint64_t d = (uint64_t)a - b; CF = (d >> 63) & 1; return (uint32_t)d; }
static inline uint32_t subc_cc(uint32_t a, uint32_t b) { uint64_t d = (uint64_t)a - b - CF; CF = (d >> 63) & 1; return (uint32_t)d; }
static inline uint32_t subc(uint32_t a, uint32_t b) { return (uint32_t)((uint64_t)a - b - CF); }
static inline uint32_t mlo(uint32_t a, uint32_t b) { return (uint32_t)((uint64_t)a * b); }
static inline uint32_t mhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
static inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { uint64_t s = (uint64_t)mlo(a, b) + c; CF = s >> 32; return (uint32_t)s; }
static inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) { uint64_t s = (uint64_t)mlo(a, b) + c + CF; CF = s >> 32; return (uint32_t)s; }
static inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) { uint64_t s = (uint64_t)mhi(a, b) + c + CF; CF = s >> 32; return (uint32_t)s; }
static inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) { return (uint32_t)((uint64_t)mhi(a, b) + c + CF); }
"""

MAIN = r"""
static void rd(FILE* f, uint32_t* x, size_t n) { if (fread(x, 4, n, f) != n) exit(3); }

template <int N>
int run_field(FILE* f, FILE* o) {
  FieldP<N> F; rd(f, F.p, N); rd(f, &F.np0, 1); rd(f, F.one, N);
  uint32_t cnt; rd(f, &cnt, 1);
  for (uint32_t i = 0; i < cnt; i++) {
    Fe<N> x, y; rd(f, x.v, N); rd(f, y.v, N);
    const Fe<N> r[4] = {fmul<N>(x, y, F), fadd<N>(x, y, F), fsub<N>(x, y, F), fneg<N>(x, F)};
    for (const auto& z : r) fwrite(z.v, 4, N, o);
  }
  return 0;
}

// the kernel's loop for every (window, lane), one lane's staged rows LT apart
template <int N, typename T>
int run_scan(FILE* f, FILE* o) {
  ScanP<N> P; rd(f, P.f.p, N); rd(f, &P.f.np0, 1); rd(f, P.f.one, N);
  rd(f, P.b3.c0.v, N); rd(f, P.b3.c1.v, N);
  uint32_t s; rd(f, &s, 1); P.b3_small = (int)s;
  uint32_t d[4]; rd(f, d, 4);
  const size_t nw = d[0], C = d[1], NIN = d[2], RL = d[3], NOUT = 3 * (sizeof(T) / 4);
  std::vector<uint32_t> xy(nw * C * NIN * RL), out(nw * C * NOUT * RL), buf(NIN * LT);
  rd(f, xy.data(), xy.size());
  for (size_t w = 0; w < nw; w++)
    for (size_t l = 0; l < RL; l++) {
      T X, Y, Z;
      set_zero_one<N>(X, Y, P.f);
      Z = X;
      for (size_t c = C; c-- > 0;) {
        for (size_t r = 0; r < NIN; r++) buf[r * LT] = xy[((w * C + c) * NIN + r) * RL + l];
        const Staged<N, T> in{buf.data()};
        in.apply_sign(P.f);
        rcb_madd<N, T>(X, Y, Z, in, P);
        uint32_t* q = &out[(w * C + c) * NOUT * RL + l];
        for_each_fe(X, [&](const Fe<N>& x) { store_e<N>(q, (int)RL, x); q += N * RL; });
        for_each_fe(Y, [&](const Fe<N>& x) { store_e<N>(q, (int)RL, x); q += N * RL; });
        for_each_fe(Z, [&](const Fe<N>& x) { store_e<N>(q, (int)RL, x); q += N * RL; });
      }
    }
  fwrite(out.data(), 4, out.size(), o);
  return 0;
}

int main(int argc, char** argv) {
  FILE* f = fopen(argv[2], "rb");
  FILE* o = fopen(argv[3], "wb");
  switch (atoi(argv[1])) {
    case 0: return run_field<8>(f, o);
    case 1: return run_field<12>(f, o);
    case 2: return run_scan<8, Fe<8>>(f, o);
    case 3: return run_scan<8, Fe2<8>>(f, o);
    case 4: return run_scan<12, Fe<12>>(f, o);
    case 5: return run_scan<12, Fe2<12>>(f, o);
  }
  return 1;
}
"""


def _host_source():
    """field.cuh with the carry steps as C functions, then msm_scan.cu from
    its constants to the mixed add (the kernel and its launch left out)."""
    with open(os.path.join(CSRC, "field.cuh")) as f:
        field = f.read()
    with open(os.path.join(CSRC, "msm_scan.cu")) as f:
        scan = f.read()
    a = field.index("// ------------------------------------------------------------- carry chains")
    b = field.index("// -------------------------------------------------------------- boundary I/O")
    field = field[:a] + CARRY_STEPS + field[b:]
    step = scan[scan.index("constexpr int LT"):scan.index("__device__ __forceinline__ void cp_async4")]
    step = step.replace('asm volatile("" : "+l"(p));', "")
    return ("#define __device__\n#define __forceinline__ inline\n"
            "#include <cstdio>\n#include <cstdlib>\n#include <vector>\n"
            + field.replace("#pragma once", "") + "\nnamespace {\n" + step + "}\n" + MAIN)


@pytest.fixture(scope="module")
def host_prog(tmp_path_factory):
    d = tmp_path_factory.mktemp("field_cuh")
    src = d / "field_cuh.cpp"
    src.write_text(_host_source())
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "no host C++ compiler"
    out = subprocess.run([cxx, "-O1", "-std=c++17", "-w", "-o", str(d / "prog"), str(src)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]

    def run(mode, words):
        np.asarray(words, dtype=np.uint32).tofile(d / "in.bin")
        subprocess.run([str(d / "prog"), str(mode), str(d / "in.bin"), str(d / "out.bin")],
                       check=True, timeout=300)
        return np.fromfile(d / "out.bin", dtype=np.uint32)

    return run


def _words(v, n):
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def _int(ws):
    return sum(int(w) << (32 * i) for i, w in enumerate(ws))


@pytest.mark.parametrize("name", ["bn254_fq", "bn254_fr", "bls12_381_fq", "bls12_381_fr"])
def test_field_cuh_matches_bigints(host_prog, name):
    """fmul / fadd / fsub / fneg on canonical operands with the edge values,
    and fmul(a, b) with a < p and b in [p, R), the operand order K-field's
    to_mont gives it."""
    fp = ftorch.get_ctx(name).fp
    n, p = fp.nl // 2, fp.p
    R = 1 << (32 * n)
    rinv = pow(R, -1, p)
    p32, np0, one32 = fcuda.consts(fp)
    rng = random.Random(11)
    pairs = [(0, 0), (1, 1), (p - 1, p - 1), (p - 1, 1), (0, p - 1), (1, 0)]
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(600)]
    wide = [(p - 1, R - 1), (1, p)] + [(rng.randrange(p), rng.randrange(p, R)) for _ in range(300)]
    words = list(p32) + [np0] + list(one32) + [len(pairs) + len(wide)]
    for x, y in pairs + wide:
        words += _words(x, n) + _words(y, n)
    out = host_prog(0 if n == 8 else 1, words).reshape(-1, 4, n)
    for i, (x, y) in enumerate(pairs):
        got = [_int(out[i, k]) for k in range(4)]
        assert got == [x * y * rinv % p, (x + y) % p, (x - y) % p, -x % p], (x, y)
    for i, (x, y) in enumerate(wide, len(pairs)):
        assert _int(out[i, 0]) == x * y * rinv % p, (x, y)


SCANS = {"g1_bn254": ("BN254", 1, 2, 3, 8), "g2_bn254": ("BN254", 2, 3, 3, 8),
         "g1_bls12_381": ("BLS12_381", 1, 4, 3, 8), "g2_bls12_381": ("BLS12_381", 2, 5, 2, 4)}


@pytest.mark.parametrize("case", sorted(SCANS))
def test_msm_scan_step_matches_scan_plain(host_prog, case):
    """K-scan's mixed add in its evaluation order, with the sign applied in
    the staged rows, over a sorted cw = 8 input (three windows)."""
    curve, ext, mode, C, RL = SCANS[case]
    cv = getattr(hc, curve)
    fq = cv.fq
    group = "g1" if ext == 1 else "g2"
    m = msm_gpu.get_msm(cv.name, group, cw=8)
    n = C * RL
    add, gen = (hc.g1_add, cv.g1) if ext == 1 else (hc.g2_add, cv.g2)
    pts, acc = [], gen
    for _ in range(n):
        pts.append(acc)
        acc = add(cv, acc, gen)
    coord = lambda f: ftorch.to_tensor(
        ftorch.np_from_ints(fq, [fq.to_mont(f(q)) for q in pts]), "cpu")
    if ext == 1:
        px, py = coord(lambda q: q[0]), coord(lambda q: q[1])
    else:
        px = (coord(lambda q: q[0][0]), coord(lambda q: q[0][1]))
        py = (coord(lambda q: q[1][0]), coord(lambda q: q[1][1]))
    rng = np.random.default_rng(3)
    scal = torch.from_numpy(rng.integers(0, 256, (2, n)).astype(np.int32))
    xyT = m.scan_input(px, py, torch.zeros(n, dtype=torch.bool), scal, lanes=RL)
    assert (xyT[:, :, -1] & 1).any()
    want = msm_gpu.scan_plain(fq, m.b, ext, xyT)
    p32, np0, one32 = fcuda.consts(fq)
    words = (list(p32) + [np0] + list(one32) + list(msm_gpu._b3_words(fq, m.b, ext))
             + [3 * m.b if ext == 1 else 0] + list(xyT.shape))
    words = np.concatenate([np.asarray(words, dtype=np.uint32),
                            xyT.numpy().view(np.uint32).ravel()])
    got = host_prog(mode, words).reshape(want.shape)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))


# ------------------------------------------------------------- K-reduce

REDUCE_SHIM = r"""
#define __device__
#define __forceinline__ inline
#define __global__
#define __shared__ static
#define __launch_bounds__(...)
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <thread>
#include <type_traits>
#include <vector>
struct Dim { unsigned x; };
static thread_local Dim threadIdx, blockIdx;
struct Barrier {
  std::mutex m; std::condition_variable cv; int n, waiting = 0; long gen = 0;
  explicit Barrier(int n) : n(n) {}
  void wait() {
    std::unique_lock<std::mutex> l(m);
    const long g = gen;
    if (++waiting == n) { waiting = 0; gen++; cv.notify_all(); }
    else cv.wait(l, [&] { return gen != g; });
  }
};
static thread_local Barrier* block_barrier;
#define __syncthreads() block_barrier->wait()
"""

REDUCE_MAIN = r"""
static void rd(FILE* f, void* x, size_t n) { if (fread(x, 4, n, f) != n) exit(3); }

// a launch: blocks one after another, each as LB threads
template <typename F>
static void grid(int blocks, F kernel) {
  for (int b = 0; b < blocks; b++) {
    Barrier bar(LB);
    std::vector<std::thread> ts;
    for (int t = 0; t < LB; t++)
      ts.emplace_back([&, b, t] { blockIdx.x = b; threadIdx.x = t; block_barrier = &bar; kernel(); });
    for (auto& th : ts) th.join();
  }
}

template <int N, int EXT>
int run_reduce(FILE* f, FILE* o) {
  RedP<N> P; rd(f, P.f.p, N); rd(f, &P.f.np0, 1); rd(f, P.f.one, N);
  rd(f, P.b3.c0.v, N); rd(f, P.b3.c1.v, N);
  uint32_t s; rd(f, &s, 1); P.b3_small = (int)s;
  uint32_t d[4]; rd(f, d, 4);
  const int nw = d[0], C = d[1], RL = d[2], half = d[3];
  constexpr int NO = 3 * N * EXT;
  std::vector<uint32_t> st((size_t)nw * C * NO * RL);
  std::vector<int32_t> keys((size_t)nw * C * RL);
  rd(f, st.data(), st.size()); rd(f, keys.data(), keys.size());
  const Sizes z = sizes(NO, nw, RL, half);
  std::vector<uint32_t> scratch(z.carry + z.btot + z.part), out((size_t)3 * EXT * 2 * N * nw);
  Args a{st.data(), keys.data(), scratch.data(), scratch.data() + z.carry,
         scratch.data() + z.carry + z.btot, out.data(), nw, C, RL, half, z.NB, z.NRB};
  const int grids[4] = {nw * z.NB, nw * z.NB, nw * z.NRB, nw};
  for (int stage = 0; stage < 4; stage++)
    grid(grids[stage], [&] { reduce_kernel<N, EXT>(a, P, stage); });
  fwrite(out.data(), 4, out.size(), o);
  return 0;
}

int main(int argc, char** argv) {
  FILE* f = fopen(argv[2], "rb");
  FILE* o = fopen(argv[3], "wb");
  switch (atoi(argv[1])) {
    case 0: return run_reduce<8, 1>(f, o);
    case 1: return run_reduce<8, 2>(f, o);
    case 2: return run_reduce<12, 1>(f, o);
    case 3: return run_reduce<12, 2>(f, o);
  }
  return 1;
}
"""


def _reduce_source():
    """field.cuh with the carry steps as C functions on a carry flag of each
    thread, then msm_reduce.cu from its constants to its launcher (left out)."""
    with open(os.path.join(CSRC, "field.cuh")) as f:
        field = f.read()
    with open(os.path.join(CSRC, "msm_reduce.cu")) as f:
        red = f.read()
    a = field.index("// ------------------------------------------------------------- carry chains")
    b = field.index("// -------------------------------------------------------------- boundary I/O")
    steps = CARRY_STEPS.replace("static uint32_t CF;", "static thread_local uint32_t CF;")
    field = field[:a] + steps + field[b:]
    body = red[red.index("constexpr int LB"):red.index("template <int N, int EXT>\ncudaError_t launch_ext")]
    body = body.replace("__noinline__", "__attribute__((noinline))")
    return REDUCE_SHIM + field.replace("#pragma once", "") + "\nnamespace {\n" + body + REDUCE_MAIN.replace(
        "int main(", "}\nint main(", 1)


@pytest.fixture(scope="module")
def reduce_prog(tmp_path_factory):
    d = tmp_path_factory.mktemp("msm_reduce")
    src = d / "msm_reduce.cpp"
    src.write_text(_reduce_source())
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "no host C++ compiler"
    out = subprocess.run([cxx, "-O1", "-std=c++17", "-w", "-pthread", "-o", str(d / "prog"),
                          str(src)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]

    def run(mode, words):
        words.tofile(d / "in.bin")
        subprocess.run([str(d / "prog"), str(mode), str(d / "in.bin"), str(d / "out.bin")],
                       check=True, timeout=300)
        return np.fromfile(d / "out.bin", dtype=np.uint32)

    return run


REDUCES = {"g1_bn254": ("bn254", 1, 0), "g2_bn254": ("bn254", 2, 1),
           "g1_bls12_381": ("bls12_381", 1, 2), "g2_bls12_381": ("bls12_381", 2, 3)}


@pytest.mark.parametrize("case", sorted(REDUCES))
def test_msm_reduce_kernels_match_reduce_plain(reduce_prog, case):
    """K-reduce's four kernels over a cw = 10 input of 100 points on 70
    lanes (two lane blocks, the second ragged; two row blocks; whole lanes
    of padding), against the plain twin, window by window as affine points."""
    from tests.test_torch_msm_reduce import CURVES, affine_windows, reduce_input

    curve, ext, mode = REDUCES[case]
    cv = CURVES[curve]
    fq = cv.fq
    st_all, dsort, _, m = reduce_input(curve, ext, 10, 100, 70, "cpu", rows=4)
    nw, C, _, RL = st_all.shape
    want = msm_gpu.reduce_plain(fq, m.b, ext, 10, st_all, dsort)
    p32, np0, one32 = fcuda.consts(fq)
    head = (list(p32) + [np0] + list(one32) + list(msm_gpu._b3_words(fq, m.b, ext))
            + [3 * m.b if ext == 1 else 0, nw, C, RL, 1 << 9])
    words = np.concatenate([np.asarray(head, dtype=np.uint32),
                            st_all.numpy().view(np.uint32).ravel(),
                            dsort.numpy().view(np.uint32).ravel()])
    got = reduce_prog(mode, words).reshape(want.shape)
    assert affine_windows(fq, got, ext) == affine_windows(fq, want, ext)
