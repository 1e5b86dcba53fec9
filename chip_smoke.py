#!/usr/bin/env python3
"""Drive snarkjs_tpu_torch on one NVIDIA card: build, check, prove, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. the card's name and power limit;
  2. build csrc/*.cu with nvcc (one process per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, limb for limb:
     K-field (all four ops; bn254 Fr/Fq, bls12-381 Fq; 2^20 elements with the
     edge values and to_mont of limbs in [p, R)), K-scan (bn254 G1/G2, cw=8,
     2^12 points), K-mm (1024 x 1024 x 1024, bn254 Fr);
  4. the stored tiny bn128 fixture proved through `prove_files`, byte-equal to
     the proof the JAX package made, verified, a tampered public rejected;
  5. the full-width prove: a 2^20-domain bn128 Groth16 key (the 600,000
     constraint squaring chain of bench.py, point sections tiled from 512
     multiples of G1 and 64 of G2), launch counts set to 0 just before and
     read just after; its five MSMs against their closed forms on host
     bigints, P_odd against the plain-version QAP on the card, the proof
     against the one assembled from the closed forms; then each kernel
     against its plain version at the shapes this prove gives it;
  6. where the warm prove's time goes (QAP and each MSM alone, one prove
     under torch.profiler), then times (CUDA events) of each kernel, its
     plain version and, for K-mm, one torch._int_mm on the Toeplitz-expanded
     digit matrix;
  7. the kernels line, then the contract line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from snarkjs_tpu_torch import _build
from snarkjs_tpu_torch.curves import host_curve as hc
from snarkjs_tpu_torch.curves import msm as msm_mod
from snarkjs_tpu_torch.curves import msm_gpu
from snarkjs_tpu_torch.fields import fcuda, ftorch
from snarkjs_tpu_torch.formats.wtns import Witness
from snarkjs_tpu_torch.formats.zkey import Groth16Zkey
from snarkjs_tpu_torch.ntt import ntt_mm
from snarkjs_tpu_torch.protocols import groth16

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "snarkjs_tpu_torch", "fixtures")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15   # H100 SXM dense int8 tensor-core peak
IMAD_PER_CLK_SM = 64        # 32-bit integer multiply-add results/clk/SM, cc 9.0
N_CONSTRAINTS = 600_000


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def max_abs_err(a, b):
    """Largest difference of two integer tensors, read as u32 words."""
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    a = a.to(torch.int64) & 0xFFFFFFFF
    b = b.to(torch.int64) & 0xFFFFFFFF
    return int((a - b).abs().max()) if a.numel() else 0


def cuda_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def wall_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def reset_counts():
    fcuda.reset_counts()
    msm_gpu.LAUNCHES[0] = 0
    ntt_mm.LAUNCHES[0] = 0


def counts():
    return {"field_ops": sum(fcuda.LAUNCHES.values()),
            "field_by_op": dict(fcuda.LAUNCHES),
            "msm_scan": msm_gpu.LAUNCHES[0], "digit_mm": ntt_mm.LAUNCHES[0]}


# ------------------------------------------------------------------ inputs

def rand_field(fp, n, dev, gen, wide=False):
    """(NL, n) limbs < p (or in (p, R) when wide), edge values first."""
    x = torch.randint(0, 1 << 16, (fp.nl, n), generator=gen, device=dev,
                      dtype=torch.int32)
    ptop = fp.limbs(fp.p)[-1]
    if wide:
        x[-1] = torch.randint(ptop + 1, 1 << 16, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        edges = [(1 << (16 * fp.nl)) - 1, fp.p + 1]
    else:
        x[-1] %= ptop
        edges = [0, 1, fp.p - 1]
    x[:, :len(edges)] = ftorch.to_tensor(
        np.array([fp.limbs(v) for v in edges], dtype=np.uint32).T, dev)
    return x


def point_tables(cv):
    """512 multiples of G1 and 64 of G2 (i+1)*G, Montgomery limbs."""
    fq = cv.fq
    g1, acc = [], cv.g1
    for _ in range(512):
        g1.append(acc)
        acc = hc.g1_add(cv, acc, cv.g1)
    g2, acc = [], cv.g2
    for _ in range(64):
        g2.append(acc)
        acc = hc.g2_add(cv, acc, cv.g2)
    m = lambda vs: ftorch.np_from_ints(fq, [fq.to_mont(v) for v in vs])
    return ((m([p[0] for p in g1]), m([p[1] for p in g1])),
            ((m([p[0][0] for p in g2]), m([p[0][1] for p in g2])),
             (m([p[1][0] for p in g2]), m([p[1][1] for p in g2]))))


def tiled(t, n):
    if isinstance(t, tuple):
        return tuple(tiled(x, n) for x in t)
    return np.ascontiguousarray(np.tile(t, (1, -(-n // t.shape[1])))[:, :n])


def synthetic_key(cv, tables):
    """The 2^20 squaring-chain key: real coefficients, tiled point sections."""
    fr = cv.fr
    nc = N_CONSTRAINTS
    n_vars, n_public = nc + 2, 1
    i = np.arange(nc, dtype=np.int32)
    m = np.concatenate([np.tile([0, 1], nc), [0, 0]]).astype(np.int32)
    c = np.concatenate([np.repeat(i, 2), [nc, nc + 1]]).astype(np.int32)
    s = np.concatenate([np.repeat(i + 1, 2), [0, 1]]).astype(np.int32)
    val = np.tile(np.array(fr.limbs(fr.R2), dtype=np.uint32)[:, None], (1, len(m)))
    (gx, gy), (g2x, g2y) = tables
    domain = 1 << (nc + n_public).bit_length()
    inf = lambda n: np.zeros(n, dtype=bool)
    g1 = lambda n: (tiled(gx, n), tiled(gy, n), inf(n))
    g = lambda k: hc.g1_mul(cv, cv.g1, k)
    g2 = lambda k: hc.g2_mul(cv, cv.g2, k)
    return Groth16Zkey(
        curve=cv, n8q=cv.fq.n8, n8r=fr.n8, n_vars=n_vars, n_public=n_public,
        domain_size=domain, power=domain.bit_length() - 1, vk_alpha_1=g(5), vk_beta_1=g(7),
        vk_beta_2=g2(7), vk_gamma_2=g2(1), vk_delta_1=g(11), vk_delta_2=g2(11),
        ic=[g(1), g(2)], coeffs={"m": m, "c": c, "s": s, "val": val},
        a_points=g1(n_vars), b1_points=g1(n_vars),
        b2_points=(tiled(g2x, n_vars), tiled(g2y, n_vars), inf(n_vars)),
        c_points=g1(n_vars - n_public - 1), h_points=g1(domain))


def squaring_witness(fr):
    w = [1, 0xDEADBEEF]
    for _ in range(N_CONSTRAINTS):
        w.append(w[-1] * w[-1] % fr.p)
    return Witness(n8=fr.n8, q=fr.p, n=len(w), values=ftorch.np_from_ints(fr, w))


def weighted_sum(limbs, period, p):
    """sum_i ((i mod period) + 1) * value_i mod p, from (NL, n) plain limbs."""
    n = limbs.shape[1]
    k = (torch.arange(n, device=limbs.device) % period + 1)[None]
    per_limb = (limbs.to(torch.int64) * k).sum(dim=1).tolist()
    return sum(v << (16 * j) for j, v in enumerate(per_limb)) % p


# ------------------------------------------------------------------ phases

def phase_kernels_small(dev, gen, tables):
    errs = {"field_ops": 0, "msm_scan": 0, "digit_mm": 0}
    for name in ("bn254_fr", "bn254_fq", "bls12_381_fq"):
        ctx = ftorch.get_ctx(name)
        fp = ctx.fp
        a = rand_field(fp, 1 << 20, dev, gen)
        b = rand_field(fp, 1 << 20, dev, gen).flip(1).contiguous()
        w = rand_field(fp, 1 << 20, dev, gen, wide=True)
        cases = {"add": (ftorch.add, a, b), "sub": (ftorch.sub, a, b),
                 "mont_mul": (ftorch.mont_mul, a, b), "neg": (ftorch.neg, a),
                 "to_mont[p,R)": (ftorch.to_mont, w)}
        for op, (fn, *args) in cases.items():
            got = fn(ctx, *args)
            with ftorch.plain_versions():
                want = fn(ctx, *args)
            e = max_abs_err(got, want)
            check(e == 0, f"K-field {op} {name} differs from plain ({e})")
            errs["field_ops"] = max(errs["field_ops"], e)
        log(f"  K-field {name}: add sub mont_mul neg to_mont == plain at 2^20")
    cv = hc.BN254
    (gx, gy), (g2x, g2y) = tables
    n = 1 << 12
    scal = rand_field(cv.fr, n, dev, gen)
    scal8 = torch.stack([scal & 0xFF, (scal >> 8) & 0xFF], dim=1).reshape(32, n)
    for group, px, py in (("g1", gx, gy), ("g2", g2x, g2y)):
        m = msm_gpu.get_msm(cv.name, group, cw=8)
        t = lambda a: tuple(t(x) for x in a) if isinstance(a, tuple) \
            else ftorch.to_tensor(tiled(a, n), dev)
        xyT = m.scan_input(t(px), t(py), torch.zeros(n, dtype=torch.bool, device=dev),
                           scal8, lanes=512)
        got = msm_gpu.scan(cv.fq, m.b, m.ext, xyT)
        want = msm_gpu.scan_plain(cv.fq, m.b, m.ext, xyT)
        e = max_abs_err(got, want)
        check(e == 0, f"K-scan {group} cw=8 differs from plain ({e})")
        errs["msm_scan"] = max(errs["msm_scan"], e)
        log(f"  K-scan {group} cw=8 2^12 points {tuple(xyT.shape)} == plain")
    return errs


def mm_inputs(dev, gen):
    fp = ftorch.get_ctx("bn254_fr").fp
    W8 = torch.from_numpy(ntt_mm._w_matrix_digits(fp.name, 10, False)).to(dev)
    D8 = ntt_mm._to_digits(fp, rand_field(fp, 1 << 20, dev, gen).reshape(
        fp.nl, 1024, 1024))
    return W8, D8


def phase_fixture(dev):
    with open(os.path.join(FIXTURES, "tiny_bn128_proof.json")) as f:
        want = json.load(f)
    zk = os.path.join(FIXTURES, "tiny_bn128.zkey")
    proof, publics = groth16.prove_files(
        zk, os.path.join(FIXTURES, "tiny_bn128.wtns"), r=want["r"], s=want["s"],
        device=dev)
    check(json.dumps([proof, publics]) ==
          json.dumps([want["proof"], want["publicSignals"]]),
          "tiny fixture proof differs from the stored JAX proof")
    from snarkjs_tpu_torch.formats.zkey import read_groth16_zkey

    vk = groth16.export_verification_key(read_groth16_zkey(zk))
    check(groth16.verify(vk, publics, proof), "tiny proof does not verify")
    bad = [str(int(publics[0]) + 1)] + publics[1:]
    check(not groth16.verify(vk, bad, proof), "tampered public accepted")
    log("  tiny bn128 fixture: proof bytes == stored JAX proof; verified; "
        "tampered public rejected")


def qap_inputs(zkey, witness, dev):
    co = zkey.coeffs
    idx = lambda a: torch.from_numpy(a.astype("int64")).to(dev)
    return (ftorch.to_tensor(co["val"], dev), idx(co["m"]), idx(co["c"]),
            idx(co["s"]), ftorch.to_tensor(witness.values, dev))


def phase_full_prove(dev, tables):
    cv = hc.BN254
    fr = cv.fr
    t = time.perf_counter()
    zkey = synthetic_key(cv, tables)
    wit = squaring_witness(fr)
    log(f"  2^20 key + witness built on host in {time.perf_counter() - t:.1f} s "
        f"(n_vars={zkey.n_vars}, coefficients={len(zkey.coeffs['m'])})")
    r, s = 0x1234567, 0x7654321
    t = time.perf_counter()
    groth16.prove(zkey, wit, r=r, s=s, device=dev)
    torch.cuda.synchronize()
    log(f"  first prove (uploads the key): {time.perf_counter() - t:.3f} s")

    out = {}
    reset_counts()
    prove_ms, (proof, publics) = wall_ms(
        lambda: groth16.prove(zkey, wit, r=r, s=s, device=dev, out=out))
    launches = counts()
    log(f"  warm prove: {prove_ms:.1f} ms; launches {launches}")
    check(launches["field_ops"] > 0 and launches["msm_scan"] > 0
          and launches["digit_mm"] > 0, "a kernel of the path was not launched")
    check(launches["digit_mm"] == 12, "expected 12 K-mm launches (6 NTTs of 2^20)")

    # closed forms of the five MSMs
    w = ftorch.to_tensor(wit.values, dev)
    p = fr.p
    kA = weighted_sum(w, 512, p)
    kC = weighted_sum(w[:, zkey.n_public + 1:], 512, p)
    kB2 = weighted_sum(w, 64, p)
    kH = weighted_sum(out["p_odd"], 512, p)
    want = {"A": hc.g1_mul(cv, cv.g1, kA), "B1": hc.g1_mul(cv, cv.g1, kA),
            "B2": hc.g2_mul(cv, cv.g2, kB2), "C": hc.g1_mul(cv, cv.g1, kC),
            "H": hc.g1_mul(cv, cv.g1, kH)}
    for name, pt in want.items():
        got = msm_mod.host_jac_to_affine(cv.fq, out[name], 2 if name == "B2" else 1)
        check(got == pt, f"MSM {name} differs from its closed form")
    log("  five MSMs == closed forms on host bigints")

    with ftorch.plain_versions():
        p_plain = groth16.qap(ftorch.get_ctx(fr.name), zkey.domain_size,
                              *qap_inputs(zkey, wit, dev))
    check(torch.equal(p_plain, out["p_odd"]), "P_odd differs from the plain QAP")
    log("  P_odd == plain-version QAP on the card")
    host_proof = groth16.blind(zkey, want["A"], want["B1"], want["B2"],
                               want["C"], want["H"], r, s)
    check(json.dumps(host_proof) == json.dumps(proof),
          "proof differs from the one assembled from the closed forms")
    log("  proof == proof assembled on host from the closed forms")
    return zkey, wit, prove_ms, launches


def imad_per_s():
    props = torch.cuda.get_device_properties(0)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.split()
    check(clk and clk[0].replace(".", "", 1).isdigit(),
          f"nvidia-smi gave no max SM clock ({clk})")
    mhz = float(clk[0])
    log(f"  32-bit multiply-add rate: {IMAD_PER_CLK_SM} x "
        f"{props.multi_processor_count} SMs x {mhz:.0f} MHz")
    return IMAD_PER_CLK_SM * props.multi_processor_count * mhz * 1e6


def mont_mul_imads(n32):
    """32-bit multiply instructions of one CIOS product (field.cuh:fmul):
    2*n32^2 wide 32x32->64 products (lo and hi, two each) and n32 low-half
    products m = t[0] * np0."""
    return 4 * n32 * n32 + n32


def madd_products(b, ext):
    """Full Montgomery products in one K-scan mixed add (msm_scan.cu:rcb_madd):
    11 over the base field, less the two 3b products when G1's 3b is a small
    integer (msm_gpu.scan's b3_small: an add ladder, no multiplies); three Fq
    products per Fq2 product for G2."""
    if ext == 2:
        return 33
    return 9 if 0 < 3 * b < 64 else 11


def bound(nbytes, ops, rate):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_breakdown(dev, zkey, wit, prove_ms):
    """Where the warm prove's time goes: the QAP and each MSM alone (host
    clock around synchronised work), then one prove under torch.profiler
    for device time per kernel.  The busy share is that device time over
    the warm prove's wall time without the profiler (prove_ms), since the
    profiler stretches the host side of the profiled prove."""
    cv = hc.BN254
    fr, fq = cv.fr, cv.fq
    ctx = ftorch.get_ctx(fr.name)
    ins = qap_inputs(zkey, wit, dev)
    parts = {"qap": wall_ms(lambda: groth16.qap(ctx, zkey.domain_size, *ins))[0]}
    a, b1, b2, c, h = groth16._dev_points(zkey, dev)
    w = ins[-1]
    p_odd = groth16.qap(ctx, zkey.domain_size, *ins)
    g1 = msm_mod.MSMContext(ftorch.get_ctx(fq.name), fq, 1)
    g2 = msm_mod.MSMContext(ftorch.get_ctx(fq.name), fq, 2)
    for name, m, pts, sc in (("msm_A", g1, a, w), ("msm_B1", g1, b1, w),
                             ("msm_B2", g2, b2, w),
                             ("msm_C", g1, c, w[:, zkey.n_public + 1:]),
                             ("msm_H", g1, h, p_odd)):
        parts[name] = wall_ms(lambda: m.run(*pts, sc))[0]
    log("  stage ms: " + json.dumps({k: round(v, 1) for k, v in parts.items()}))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = wall_ms(lambda: groth16.prove(zkey, wit, r=1, s=2, device=dev))
    by_kernel = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0)
        if t > 0:
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + t / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    if busy == 0:
        log("  profiler: no device time recorded (device busy share not measured)")
    else:
        log(f"  profiled prove: wall {wall:.1f} ms (profiler on), device busy "
            f"{busy:.1f} ms; over the unprofiled warm prove ({prove_ms:.1f} ms): "
            f"busy {100 * busy / prove_ms:.1f}%, idle {100 - 100 * busy / prove_ms:.1f}%")
        for k, v in top:
            log(f"    {v:9.2f} ms  {k[:90]}")
    return parts


def phase_main_shapes_and_times(dev, gen, zkey, wit, errs):
    cv = hc.BN254
    rate32 = imad_per_s()
    entries = {}

    # K-field at (16, 2^20), the NTT / coset shape
    ctx = ftorch.get_ctx("bn254_fr")
    a = rand_field(ctx.fp, 1 << 20, dev, gen)
    b = rand_field(ctx.fp, 1 << 20, dev, gen)
    n32 = ctx.nl // 2
    ops = {}
    for op, fn, args in (("mont_mul", ftorch.mont_mul, (a, b)),
                         ("add", ftorch.add, (a, b)), ("sub", ftorch.sub, (a, b)),
                         ("neg", ftorch.neg, (a,))):
        ms = cuda_ms(lambda: fn(ctx, *args), 20)
        with ftorch.plain_versions():
            plain_ms = cuda_ms(lambda: fn(ctx, *args), 2)
        nbytes = (len(args) + 1) * ctx.nl * 4 * (1 << 20)
        wide = mont_mul_imads(n32) * (1 << 20) if op == "mont_mul" else 0
        bms, by = bound(nbytes, wide, rate32) if wide else (
            nbytes / HBM_BYTES_PER_S * 1e3, "bytes")
        ops[op] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}
        log(f"  K-field {op} (16, 2^20): {ms:.4f} ms  plain {plain_ms:.2f} ms  "
            f"bound {bms:.4f} ms ({by})")
    entries["field_ops"] = dict(ops["mont_mul"], ops=ops)

    # K-scan at the prove's shapes: the A (G1) and B2 (G2) MSM inputs
    for group, which in (("g1", 0), ("g2", 2)):
        m = msm_gpu.get_msm(cv.name, group, cw=16)
        dp = groth16._dev_points(zkey, dev)[which]
        xyT = m.scan_input(dp[0], dp[1], dp[2], ftorch.to_tensor(wit.values, dev))
        ms = cuda_ms(lambda: msm_gpu.scan(cv.fq, m.b, m.ext, xyT), 3)
        got = msm_gpu.scan(cv.fq, m.b, m.ext, xyT)
        plain_ms, want = wall_ms(lambda: msm_gpu.scan_plain(cv.fq, m.b, m.ext, xyT))
        e = max_abs_err(got, want)
        check(e == 0, f"K-scan {group} main shape differs from plain ({e})")
        errs["msm_scan"] = max(errs["msm_scan"], e)
        nw, C, nin, RL = xyT.shape
        nbytes = xyT.numel() * 4 + got.numel() * 4
        wide = nw * C * RL * madd_products(m.b, m.ext) * mont_mul_imads(cv.fq.nl // 2)
        bms, by = bound(nbytes, wide, rate32)
        log(f"  K-scan {group} {tuple(xyT.shape)} == plain: {ms:.3f} ms  "
            f"plain {plain_ms:.0f} ms  bound {bms:.3f} ms ({by})")
        entries[f"msm_scan_{group}"] = {"ms": ms, "plain_ms": plain_ms,
                                        "bound_ms": bms, "bound_by": by}
        del xyT, got, want

    # K-mm at 1024^3, bn254 Fr (each of the 12 stages of the prove)
    W8, D8 = mm_inputs(dev, gen)
    nd, r, q = W8.shape
    mm = D8.shape[2]
    got = ntt_mm.digit_mm(W8, D8)
    plain_ms, want = wall_ms(lambda: ntt_mm.digit_mm_plain(W8, D8))
    e = max_abs_err(got, want)
    check(e == 0, f"K-mm differs from plain ({e})")
    errs["digit_mm"] = e
    ms = cuda_ms(lambda: ntt_mm.digit_mm(W8, D8), 5)
    nc = 2 * nd - 1
    toe = torch.zeros((nd, q, nc, mm), dtype=torch.int8, device=dev)
    for i in range(nd):
        toe[i, :, i:i + nd] = D8.permute(1, 0, 2)
    Wcat = W8.permute(1, 0, 2).reshape(r, nd * q).contiguous()
    toe = toe.reshape(nd * q, nc * mm)
    lib = torch._int_mm(Wcat, toe).reshape(r, nc, mm).permute(1, 0, 2)
    check(max_abs_err(lib, got) == 0, "torch._int_mm yardstick differs from K-mm")
    library_ms = cuda_ms(lambda: torch._int_mm(Wcat, toe), 3)
    del toe, lib, want
    bms, by = bound(W8.numel() + D8.numel() + got.numel() * 4,
                    2 * nd * nd * r * q * mm, INT8_OPS_PER_S)
    log(f"  K-mm (33,1024,1024)x(33,1024,1024) == plain: {ms:.3f} ms  plain "
        f"{plain_ms:.1f} ms  torch._int_mm {library_ms:.3f} ms  bound {bms:.3f} ms ({by})")
    entries["digit_mm"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                           "bound_by": by, "library_ms": library_ms}
    return entries


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"device: {name} x{torch.cuda.device_count()}  torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    t = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {time.perf_counter() - t:.1f} s")
    for src, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    tables = point_tables(hc.BN254)
    t = time.perf_counter()
    log("[kernels vs plain]")
    errs = phase_kernels_small(dev, gen, tables)
    log(f"[fixture proof] ({time.perf_counter() - t:.1f} s so far)")
    phase_fixture(dev)
    log("[2^20 Groth16 prove]")
    zkey, wit, prove_ms, launches = phase_full_prove(dev, tables)
    log("[where the time goes]")
    phase_breakdown(dev, zkey, wit, prove_ms)
    log("[main-path shapes and times]")
    entries = phase_main_shapes_and_times(dev, gen, zkey, wit, errs)

    scan_g1 = entries["msm_scan_g1"]
    rows = [
        ("field_ops", "snarkjs_tpu_torch/csrc/field_ops.cu",
         "snarkjs_tpu/fields/fpal.py:449", entries["field_ops"]),
        ("msm_scan", "snarkjs_tpu_torch/csrc/msm_scan.cu",
         "snarkjs_tpu/curves/msm_tpu.py:213",
         dict(scan_g1, g2=entries["msm_scan_g2"])),
        ("digit_mm", "snarkjs_tpu_torch/csrc/digit_mm.cu",
         "snarkjs_tpu/ntt/ntt_mxu.py:320", entries["digit_mm"]),
    ]
    kernels = []
    for kname, src, replaces, e in rows:
        kernels.append(dict({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": errs[kname],
            "library_ms": None}, **e))
    kernels[0]["launches_by_op"] = launches["field_by_op"]
    log(f"prove_2^20_warm_ms: {prove_ms}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
