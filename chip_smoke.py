#!/usr/bin/env python3
"""Drive snarkjs_tpu_torch on one NVIDIA card: build, check, prove, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. the card's name and power limit;
  2. build csrc/*.cu with nvcc (one process per source, in parallel); print
     each K-scan instantiation's registers and local memory (from the loaded
     library) and spills (the ptxas report of that library) and the SASS
     instructions of one step by class; the SASS of K-mm and K-mm-norm must
     hold tensor-core instructions (IGMMA / IMMA);
  3. each kernel against its plain PyTorch version on the card, limb for limb:
     K-field (all four ops; bn254 Fr/Fq, bls12-381 Fq; 2^20 elements with the
     edge values and to_mont of limbs in [p, R)), K-scan (every instantiation:
     bn254 and bls12-381, G1 and G2, cw=8, 2^12 points; bn254 G1 also on a
     lane count that is no multiple of 128 and with C = 1), K-mm and
     K-mm-norm (1024 x 1024 x 1024, r = 4 with
     m = 2^16, m = 4 with r = 1024, and a shape that is no multiple of 4;
     K-mm-norm on bn254 Fr and bls12-381 Fr);
  4. the stored tiny bn128 fixtures proved through `prove_files`, byte-equal
     to the proofs the JAX package made, verified, a tampered public rejected:
     Groth16, then PLONK;
  5. the full-width prove: a 2^20-domain bn128 Groth16 key (the 600,000
     constraint squaring chain of bench.py, point sections tiled from 512
     multiples of G1 and 64 of G2), launch counts set to 0 just before and
     read just after; its five MSMs against their closed forms on host
     bigints, P_odd against the plain-version QAP on the card, the proof
     against the one assembled from the closed forms; then each kernel
     against its plain version at the shapes this prove gives it;
  6. where the warm prove's time goes (QAP and each MSM alone, one prove
     under torch.profiler), warm proves paired over the two NTT routes, then
     times (CUDA events) of each kernel, its plain version and, for K-mm, one
     torch._int_mm on the Toeplitz-expanded digit matrix; K-field also its
     device time a launch under torch.profiler;
  7. the full-width PLONK prove: the 200,000-constraint squaring chain
     (domain n = 2^18, 4n = 2^20), its key written by `_write_plonk_zkey` on
     the card with an SRS tiled from the 512 multiples of G1; launch counts
     set to 0 just before, read just after; nine commitments against their
     closed forms, six evaluations against host Horner, the quotient identity
     at xi on host bigints; then K-scan and K-mm-norm against their plain
     versions at every shape that prove called them with (the shapes are
     recorded during the counted prove: the scan input is rebuilt from the
     key's SRS and the blinded polynomial A), each with its time and bound;
  8. PLONK times: warm proves paired over the two NTT routes (medians,
     spread, peak memory; the proofs equal), rounds 1-5, one prove under
     torch.profiler;
  9. the NTT path: a forward and an inverse 2^20 NTT and an inverse 2^18 NTT
     on bn254 Fr through `fused=False` (K-mm, then `_normalize_cols` in
     PyTorch), launch counts set to 0 just before and read just after, each
     result equal limb for limb to the default route's; then K-mm against its
     plain version at every shape that path gave it;
 10. K-scan's registers, local memory and spills, the kernels line, then the
     contract line.

Every NTT stage of the proves goes through K-mm-norm, the one route of
`ntt_mm._mm_stage`; K-mm is driven by phase 9.  The paired timings send a
prove's stages the other way by patching `ntt_mm._mm_stage`.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
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
from snarkjs_tpu_torch.formats import points as pcodec
from snarkjs_tpu_torch.formats.r1cs import R1cs
from snarkjs_tpu_torch.formats.wtns import Witness
from snarkjs_tpu_torch.formats.zkey import Groth16Zkey, read_plonk_zkey
from snarkjs_tpu_torch.ntt import ntt_mm
from snarkjs_tpu_torch.poly import fops
from snarkjs_tpu_torch.protocols import groth16, plonk, plonk_setup

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "snarkjs_tpu_torch", "fixtures")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15   # H100 SXM dense int8 tensor-core peak
IMAD_PER_CLK_SM = 64        # 32-bit integer multiply-add results/clk/SM, cc 9.0
N_CONSTRAINTS = 600_000
PLONK_CONSTRAINTS = 200_000  # + 1 public-input row: domain 2^18
PAIRED_PROVES = 7            # warm proves per NTT route in a paired timing


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


def shapes_json(shapes):
    return json.dumps({k: {"x".join(map(str, sh)): n for sh, n in v.items()}
                       for k, v in shapes.items() if v})


def reset_counts():
    fcuda.reset_counts()
    msm_gpu.LAUNCHES[0] = 0
    ntt_mm.LAUNCHES[0] = 0
    ntt_mm.NORM_LAUNCHES[0] = 0


def counts():
    return {"field_ops": sum(fcuda.LAUNCHES.values()),
            "field_by_op": dict(fcuda.LAUNCHES),
            "msm_scan": msm_gpu.LAUNCHES[0], "digit_mm": ntt_mm.LAUNCHES[0],
            "digit_mm_norm": ntt_mm.NORM_LAUNCHES[0]}


@contextlib.contextmanager
def unfused_stages():
    """Send every NTT stage of a block through K-mm and the PyTorch
    `_normalize_cols` (what `fused=False` asks of `ntt_mm.ntt`)."""
    stage = ntt_mm._mm_stage
    ntt_mm._mm_stage = lambda ctx, k, inverse, a, fused=True: stage(ctx, k, inverse, a, False)
    try:
        yield
    finally:
        ntt_mm._mm_stage = stage


def paired_proves(prove, what):
    """Warm proves alternating the default NTT route (K-mm-norm) and the other
    (K-mm + `_normalize_cols`), PAIRED_PROVES each in one process: medians,
    spread and peak device memory per route.  The proofs must be equal."""
    ms = {"fused": [], "unfused": []}
    peak = {"fused": 0, "unfused": 0}
    proofs = set()
    for _ in range(PAIRED_PROVES):
        for route, ctx in (("fused", contextlib.nullcontext()), ("unfused", unfused_stages())):
            torch.cuda.reset_peak_memory_stats()
            with ctx:
                t, got = wall_ms(prove)
            ms[route].append(t)
            peak[route] = max(peak[route], torch.cuda.max_memory_allocated())
            proofs.add(json.dumps(got))
    check(len(proofs) == 1, f"{what}: the two NTT routes give different proofs")
    out = {}
    for route, ts in ms.items():
        out[route] = {"median_ms": float(np.median(ts)), "min_ms": min(ts), "max_ms": max(ts),
                      "peak_gib": peak[route] / 2**30}
        log(f"  {what}, {route} route, {len(ts)} warm proves alternating: median "
            f"{out[route]['median_ms']:.1f} ms, spread {min(ts):.1f} .. {max(ts):.1f} ms, "
            f"peak device memory {out[route]['peak_gib']:.2f} GiB")
    log(f"  {what}: unfused - fused median = "
        f"{out['unfused']['median_ms'] - out['fused']['median_ms']:.1f} ms; proofs equal")
    return out


@contextlib.contextmanager
def recorded_shapes():
    """Count, per kernel, the shapes its wrapper is called with in a block:
    (r, q, m) for the two digit matmuls, the input's shape for the scan.  The
    calls go on to the wrappers unchanged."""
    seen = {k: collections.Counter() for k in ("digit_mm", "digit_mm_norm", "msm_scan")}
    mm, mm_norm, scan = ntt_mm.digit_mm, ntt_mm.digit_mm_norm, msm_gpu.scan

    def rec_mm(W8, D8, y_major=False):
        seen["digit_mm"][(*W8.shape[1:], D8.shape[1 if y_major else 2])] += 1
        return mm(W8, D8, y_major)

    def rec_mm_norm(fp, W8, D8, y_major=False):
        seen["digit_mm_norm"][(*W8.shape[1:], D8.shape[1 if y_major else 2])] += 1
        return mm_norm(fp, W8, D8, y_major)

    def rec_scan(fq, b, ext, xyT):
        seen["msm_scan"][tuple(xyT.shape)] += 1
        return scan(fq, b, ext, xyT)

    ntt_mm.digit_mm, ntt_mm.digit_mm_norm, msm_gpu.scan = rec_mm, rec_mm_norm, rec_scan
    try:
        yield seen
    finally:
        ntt_mm.digit_mm, ntt_mm.digit_mm_norm, msm_gpu.scan = mm, mm_norm, scan


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


def point_tables(cv, n1=512, n2=64):
    """n1 multiples of G1 and n2 of G2, (i+1)*G, Montgomery limbs."""
    fq = cv.fq
    g1, acc = [], cv.g1
    for _ in range(n1):
        g1.append(acc)
        acc = hc.g1_add(cv, acc, cv.g1)
    g2, acc = [], cv.g2
    for _ in range(n2):
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
    errs["msm_scan"] = scan_small_cases(dev, gen, tables)
    errs["digit_mm_norm"] = 0
    for name in ("bn254_fr", "bls12_381_fr"):
        fp = ftorch.get_ctx(name).fp
        for k, r, q, m in ((10, 1024, 1024, 1024), (2, 4, 4, 1 << 16),
                           (10, 1024, 1024, 4), (None, 70, 33, 50)):
            W8, D8 = mm_inputs(dev, gen, name, k, r, q, m)
            cols = ntt_mm.digit_mm_plain(W8, D8)
            got = ntt_mm.digit_mm_norm(fp, W8, D8)
            torch.cuda.synchronize()
            e = max_abs_err(got, ntt_mm._normalize_cols(fp, cols))
            check(e == 0, f"K-mm-norm {name} {(r, q, m)} differs from plain ({e})")
            if name == "bn254_fr":      # K-mm does not depend on the field
                got = ntt_mm.digit_mm(W8, D8)
                torch.cuda.synchronize()
                e = max_abs_err(got, cols)
                check(e == 0, f"K-mm {(r, q, m)} differs from plain ({e})")
        log(f"  K-mm-norm {name}: 1024^3, (4,4,2^16), (1024,1024,4), (70,33,50) "
            "== plain, limb for limb" + ("; K-mm too" if name == "bn254_fr" else ""))
    return errs


SCAN_INSTANCES = {(8, 1): "bn254 G1", (8, 2): "bn254 G2", (12, 1): "bls12-381 G1",
                  (12, 2): "bls12-381 G2"}


def scan_small_cases(dev, gen, tables):
    """K-scan against its plain version, word for word, on bn254 and
    bls12-381, G1 and G2 (every instantiation): cw = 8, 2^12 points over 512
    lanes; bn254 G1 also over 200 lanes (no multiple of a block's 128) and
    with 300 points on 300 lanes (C = 1, one ragged block).  Returns the
    largest difference (0)."""
    err = 0
    bls = point_tables(hc.BLS12_381, 64, 16)
    for cv, ((gx, gy), (g2x, g2y)) in ((hc.BN254, tables), (hc.BLS12_381, bls)):
        n = 1 << 12
        scal = rand_field(cv.fr, n, dev, gen)
        scal8 = torch.stack([scal & 0xFF, (scal >> 8) & 0xFF], dim=1).reshape(-1, n)
        for group, px, py in (("g1", gx, gy), ("g2", g2x, g2y)):
            m = msm_gpu.get_msm(cv.name, group, cw=8)
            cases = [(n, 512)]
            if cv is hc.BN254 and group == "g1":
                cases += [(n, 200), (300, 300)]
            for npts, lanes in cases:
                t = lambda a: tuple(t(x) for x in a) if isinstance(a, tuple) \
                    else ftorch.to_tensor(tiled(a, npts), dev)
                xyT = m.scan_input(t(px), t(py),
                                   torch.zeros(npts, dtype=torch.bool, device=dev),
                                   scal8[:, :npts].contiguous(), lanes=lanes)
                got = msm_gpu.scan(cv.fq, m.b, m.ext, xyT)
                want = msm_gpu.scan_plain(cv.fq, m.b, m.ext, xyT)
                e = max_abs_err(got, want)
                check(e == 0, f"K-scan {cv.name} {group} {tuple(xyT.shape)} differs from "
                              f"plain ({e})")
                err = max(err, e)
                log(f"  K-scan {cv.name} {group} cw=8 {npts} points {tuple(xyT.shape)} == plain")
    return err


def _scan_instance(symbol):
    m = re.search(r"scan_kernelILi(\d+)ELi(\d+)E", symbol)
    return SCAN_INSTANCES.get((int(m.group(1)), int(m.group(2)))) if m else None


def scan_registers():
    """Registers and local memory a thread of each K-scan instantiation, read
    from the loaded library (cudaFuncGetAttributes), and its spill bytes from
    the ptxas report that the build wrote under the same digest; the two
    register counts must agree."""
    path = _build.log_path("msm_scan")
    check(os.path.exists(path), f"no ptxas report of the loaded K-scan library ({path})")
    with open(path) as f:
        text = f.read()
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Function properties for|Compiling entry function) '?([^' ]+)", line)
        if m:
            cur = _scan_instance(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    check(set(out) == set(SCAN_INSTANCES.values()),
          f"the ptxas report lacks a K-scan instantiation: {sorted(out)}")
    for (n32, ext), name in SCAN_INSTANCES.items():
        attrs = msm_gpu.kernel_attributes(n32, ext)
        check(attrs["registers"] == out[name]["registers"],
              f"K-scan {name}: the loaded library has {attrs['registers']} registers, "
              f"its ptxas report {out[name]['registers']}")
        out[name]["local_bytes"] = attrs["local_bytes"]
    return out


def _cuobjdump():
    nvcc = _build._nvcc()
    return os.path.join(os.path.dirname(nvcc), "cuobjdump") if os.sep in nvcc else "cuobjdump"


def scan_sass_counts():
    """SASS instructions of one K-scan step in each instantiation: the body
    of the kernel's outermost loop (the loop over C), by class.  G2 is
    straight-line there; G1's 3b ladder (fmul_small) is an inner loop whose
    body counts once, though it runs up to four trips a step."""
    sass = subprocess.run([_cuobjdump(), "-sass", _build.lib_path("msm_scan")],
                          capture_output=True, text=True)
    check(sass.returncode == 0, f"cuobjdump failed on msm_scan: {sass.stderr[-500:]}")
    out = {}
    for part in sass.stdout.split("Function : ")[1:]:
        name = _scan_instance(part.split(None, 1)[0])
        if name is None:
            continue
        ops, at, branches = [], {}, []   # at: instruction address -> index
        for line in part.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);",
                         line)
            if m:
                at[int(m.group(1), 16)] = len(ops)
                t = re.search(r"\b0x([0-9a-f]+)\b", m.group(3))
                if m.group(2).startswith("BRA") and t:
                    branches.append((int(t.group(1), 16), len(ops)))
                ops.append(m.group(2))
        loops = [(at[t], i) for t, i in branches if t in at and at[t] <= i]
        check(loops, f"no loop found in the SASS of K-scan {name}")
        lo, hi = max(loops, key=lambda l: l[1] - l[0])
        body = ops[lo:hi + 1]
        imad = [op for op in body if op.startswith("IMAD")]
        moves = sum(op.startswith("IMAD.MOV") for op in imad)
        iadd = sum(op.startswith("IADD3") for op in body)
        out[name] = {"total": len(body), "imad": len(imad) - moves, "imad_mov": moves,
                     "iadd3": iadd, "other": len(body) - len(imad) - iadd}
    check(set(out) == set(SCAN_INSTANCES.values()),
          f"the SASS lacks a K-scan instantiation: {sorted(out)}")
    return out


def device_ms_per_launch(fn, iters, match):
    """Device time per launch of the kernels whose name holds `match`, from
    torch.profiler over `iters` calls of fn (after one warm call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if match in evt.key:
            t = getattr(evt, "self_device_time_total", None)
            if t is None:
                t = getattr(evt, "self_cuda_time_total", 0)
            total += t / 1e3
            count += evt.count
    return (total / count, count) if count and total > 0 else (None, count)


def mm_inputs(dev, gen, name="bn254_fr", k=10, r=1024, q=1024, m=1024):
    """Digit-matmul operands: the size-2^k DFT matrix (random digits when k is
    None) and the digits of q*m random field elements."""
    fp = ftorch.get_ctx(name).fp
    if k is None:
        W8 = torch.randint(-128, 128, (fp.n8 + 1, r, q), generator=gen, device=dev,
                           dtype=torch.int8)
    else:
        W8 = torch.from_numpy(ntt_mm._w_matrix_digits(fp.name, k, False)).to(dev)
    D8 = ntt_mm._to_digits(fp, rand_field(fp, q * m, dev, gen).reshape(fp.nl, q, m))
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


def phase_plonk_fixture(dev):
    with open(os.path.join(FIXTURES, "tiny_plonk_bn128_proof.json")) as f:
        want = json.load(f)
    zk = os.path.join(FIXTURES, "tiny_plonk_bn128.zkey")
    proof, publics = plonk.prove_files(
        zk, os.path.join(FIXTURES, "tiny_plonk_bn128.wtns"), b=want["b"], device=dev)
    check(json.dumps([proof, publics]) ==
          json.dumps([want["proof"], want["publicSignals"]]),
          "tiny PLONK fixture proof differs from the stored JAX proof")
    vk = plonk.export_verification_key(read_plonk_zkey(zk))
    check(plonk.verify(vk, publics, proof), "tiny PLONK proof does not verify")
    bad = [str(int(publics[0]) + 1)] + publics[1:]
    check(not plonk.verify(vk, bad, proof), "tampered public accepted (PLONK)")
    log("  tiny bn128 PLONK fixture: proof bytes == stored JAX proof; verified; "
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
    with recorded_shapes() as shapes:
        reset_counts()
        prove_ms, (proof, publics) = wall_ms(
            lambda: groth16.prove(zkey, wit, r=r, s=s, device=dev, out=out))
        launches = counts()
    log(f"  warm prove: {prove_ms:.1f} ms; launches {launches}")
    log(f"  shapes: {shapes_json(shapes)}")
    check(launches["field_ops"] > 0 and launches["msm_scan"] > 0
          and launches["digit_mm_norm"] > 0 and launches["digit_mm"] == 0,
          "a kernel of the Groth16 path was not launched (or K-mm was)")
    check(launches["digit_mm_norm"] == 12,
          "expected 12 K-mm-norm launches (6 NTTs of 2^20)")

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
    return zkey, wit, prove_ms, launches, shapes


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


def madd_products(ext):
    """Full Montgomery products over the base field in one K-scan mixed add
    (msm_scan.cu:rcb_madd, the operations of rcb.rcb_madd): 11 products and
    two products by 3b.  On G1 3b is a small integer and those two are an add
    ladder (fmul_small), no multiplies; on G2 3b is a full Fq2 element, so
    all 13 are Fq2 products of three Fq products each."""
    return 11 if ext == 1 else 3 * 13


def bound(nbytes, ops, rate):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def profile_busy(fn, warm_ms):
    """One run of `fn` under torch.profiler: device time per kernel, and the
    busy share as that device time over `warm_ms`, the same work's warm wall
    time without the profiler (the profiler stretches the host side)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = wall_ms(fn)
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
        return None
    log(f"  profiled prove: wall {wall:.1f} ms (profiler on), device busy "
        f"{busy:.1f} ms; over the unprofiled warm prove ({warm_ms:.1f} ms): "
        f"busy {100 * busy / warm_ms:.1f}%, idle {100 - 100 * busy / warm_ms:.1f}%")
    for k, v in top:
        log(f"    {v:9.2f} ms  {k[:90]}")
    return busy


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

    profile_busy(lambda: groth16.prove(zkey, wit, r=1, s=2, device=dev), prove_ms)
    paired = paired_proves(lambda: groth16.prove(zkey, wit, r=1, s=2, device=dev),
                           "Groth16 2^20")
    return parts, paired


def scan_case(cv, group, pts, scal, seen, path, rate32, errs):
    """K-scan against its plain version on the input `run` builds for these
    points and scalars, which must have a shape recorded in `seen`; its time
    and bound at that shape."""
    m = msm_gpu.get_msm(cv.name, group, cw=16)
    xyT = m.scan_input(*pts, scal)
    shape = tuple(xyT.shape)
    check(shape in seen, f"K-scan {group} input {shape} is no shape of the {path} prove")
    ms = cuda_ms(lambda: msm_gpu.scan(cv.fq, m.b, m.ext, xyT), 3)
    got = msm_gpu.scan(cv.fq, m.b, m.ext, xyT)
    plain_ms, want = wall_ms(lambda: msm_gpu.scan_plain(cv.fq, m.b, m.ext, xyT))
    e = max_abs_err(got, want)
    check(e == 0, f"K-scan {group} {shape} differs from plain ({e})")
    errs["msm_scan"] = max(errs["msm_scan"], e)
    nw, C, nin, RL = shape
    nbytes = xyT.numel() * 4 + got.numel() * 4
    wide = nw * C * RL * madd_products(m.ext) * mont_mul_imads(cv.fq.nl // 2)
    bms, by = bound(nbytes, wide, rate32)
    log(f"  K-scan {group} {shape} x{seen[shape]} ({path}) == plain: {ms:.3f} ms  "
        f"plain {plain_ms:.0f} ms  bound {bms:.3f} ms ({by})")
    return {"path": path, "group": group, "shape": list(shape), "launches": seen[shape],
            "max_abs_err": e, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by}


def mm_case(dev, gen, kernel, shape, launches, path, errs):
    """K-mm or K-mm-norm (bn254 Fr) against its plain version at one stage
    shape (r, q, m), with its time and bound there.  Compared in both operand
    layouts; timed as the NTT calls it, with the data digits y-major."""
    r, q, m = shape
    fp = ftorch.get_ctx("bn254_fr").fp
    W8, D8 = mm_inputs(dev, gen, "bn254_fr", r.bit_length() - 1, r, q, m)
    DT = ntt_mm._y_major(D8)
    if kernel == "digit_mm_norm":
        fn, jax_layout, plain = (lambda: ntt_mm.digit_mm_norm(fp, W8, DT, y_major=True),
                                 lambda: ntt_mm.digit_mm_norm(fp, W8, D8),
                                 lambda: ntt_mm.digit_mm_norm_plain(fp, W8, D8))
    else:
        fn, jax_layout, plain = (lambda: ntt_mm.digit_mm(W8, DT, y_major=True),
                                 lambda: ntt_mm.digit_mm(W8, D8),
                                 lambda: ntt_mm.digit_mm_plain(W8, D8))
    plain_ms, want = wall_ms(plain)
    e = max(max_abs_err(fn(), want), max_abs_err(jax_layout(), want))
    check(e == 0, f"{kernel} {shape} differs from plain ({e})")
    errs[kernel] = max(errs[kernel], e)
    ms = cuda_ms(fn, 5)
    nd = W8.shape[0]
    bms, by = bound(W8.numel() + D8.numel() + want.numel() * 4,
                    2 * nd * nd * r * q * m, INT8_OPS_PER_S)
    log(f"  {kernel} {shape} x{launches} ({path}) == plain: {ms:.3f} ms  "
        f"plain {plain_ms:.1f} ms  bound {bms:.3f} ms ({by})")
    return {"path": path, "shape": list(shape), "launches": launches, "max_abs_err": e,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def phase_main_shapes_and_times(dev, gen, zkey, wit, errs, shapes, rate32):
    cv = hc.BN254
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
        dev_ms, _ = device_ms_per_launch(lambda: fn(ctx, *args), 20, "field_kernel")
        with ftorch.plain_versions():
            plain_ms = cuda_ms(lambda: fn(ctx, *args), 2)
        nbytes = (len(args) + 1) * ctx.nl * 4 * (1 << 20)
        wide = mont_mul_imads(n32) * (1 << 20) if op == "mont_mul" else 0
        bms, by = bound(nbytes, wide, rate32) if wide else (
            nbytes / HBM_BYTES_PER_S * 1e3, "bytes")
        ops[op] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by}
        log(f"  K-field {op} (16, 2^20): {ms:.4f} ms (CUDA events over 20 launches), "
            f"device {dev_ms} ms a launch (torch.profiler)  plain {plain_ms:.2f} ms  "
            f"bound {bms:.4f} ms ({by})")
    entries["field_ops"] = dict(ops["mont_mul"], ops=ops)

    # K-scan at every shape the prove gave it: the A, B1 and C inputs share
    # one (A's is taken), then H's (G1) and B2's (G2)
    a_pts, _, b2_pts, _, h_pts = groth16._dev_points(zkey, dev)
    w = ftorch.to_tensor(wit.values, dev)
    p_odd = groth16.qap(ctx, zkey.domain_size, *qap_inputs(zkey, wit, dev))
    seen = shapes["msm_scan"]
    scans = [scan_case(cv, group, pts, scal, seen, "groth16", rate32, errs)
             for group, pts, scal in (("g1", a_pts, w), ("g1", h_pts, p_odd),
                                      ("g2", b2_pts, w))]
    check({tuple(e["shape"]) for e in scans} == set(seen),
          f"a K-scan shape of the Groth16 prove was not compared: {sorted(seen)}")
    entries["msm_scan"] = scans
    del p_odd

    # K-mm-norm's only shape in this prove is 1024^3 (12 stages); K-mm is held
    # and timed there too, beside the library yardstick
    check(dict(shapes["digit_mm_norm"]) == {(1024, 1024, 1024): 12},
          f"the Groth16 prove's K-mm-norm shapes are not 12 x 1024^3: "
          f"{shapes['digit_mm_norm']}")
    W8, D8 = mm_inputs(dev, gen)
    DT = ntt_mm._y_major(D8)          # the layout the NTT hands the kernels
    nd, r, q = W8.shape
    mm = D8.shape[2]
    got = ntt_mm.digit_mm(W8, DT, y_major=True)
    plain_ms, want = wall_ms(lambda: ntt_mm.digit_mm_plain(W8, D8))
    e = max(max_abs_err(got, want), max_abs_err(ntt_mm.digit_mm(W8, D8), want))
    check(e == 0, f"K-mm differs from plain ({e})")
    errs["digit_mm"] = e
    ms = cuda_ms(lambda: ntt_mm.digit_mm(W8, DT, y_major=True), 5)
    log(f"  K-mm at 1024^3 from the JAX layout (nd, q, m), transposed in the wrapper: "
        f"{cuda_ms(lambda: ntt_mm.digit_mm(W8, D8), 5):.3f} ms, of which the transpose "
        f"{cuda_ms(lambda: ntt_mm._y_major(D8), 5):.3f} ms")
    nc = 2 * nd - 1
    toe = torch.zeros((nd, q, nc, mm), dtype=torch.int8, device=dev)
    for i in range(nd):
        toe[i, :, i:i + nd] = D8.permute(1, 0, 2)
    Wcat = W8.permute(1, 0, 2).reshape(r, nd * q).contiguous()
    toe = toe.reshape(nd * q, nc * mm)
    lib = torch._int_mm(Wcat, toe).reshape(r, nc, mm).permute(1, 0, 2)
    check(max_abs_err(lib, got) == 0, "torch._int_mm yardstick differs from K-mm")
    library_ms = cuda_ms(lambda: torch._int_mm(Wcat, toe), 3)
    check(ms < library_ms, f"K-mm ({ms:.3f} ms) is not faster than torch._int_mm "
                           f"({library_ms:.3f} ms)")
    # the library's way to the normalised limbs: the same _int_mm, then the
    # PyTorch _normalize_cols on its columns
    fp = ctx.fp
    lib_norm_ms = cuda_ms(lambda: ntt_mm._normalize_cols(fp, lib), 3)
    lib_limbs = ntt_mm._normalize_cols(fp, lib)
    del toe, lib, want
    bms, by = bound(W8.numel() + D8.numel() + got.numel() * 4,
                    2 * nd * nd * r * q * mm, INT8_OPS_PER_S)
    log(f"  K-mm (33,1024,1024)x(33,1024,1024) == plain: {ms:.3f} ms  plain "
        f"{plain_ms:.1f} ms  torch._int_mm {library_ms:.3f} ms  bound {bms:.3f} ms ({by})")
    entries["digit_mm"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                           "bound_by": by, "library_ms": library_ms}

    # K-mm-norm at the same 1024^3 stage (all 12 stages of the Groth16 prove,
    # 12 of the 20 of a PLONK prove)
    gotn = ntt_mm.digit_mm_norm(fp, W8, DT, y_major=True)
    plain_n_ms, wantn = wall_ms(lambda: ntt_mm.digit_mm_norm_plain(fp, W8, D8))
    e = max(max_abs_err(gotn, wantn), max_abs_err(gotn, lib_limbs),
            max_abs_err(ntt_mm.digit_mm_norm(fp, W8, D8), wantn))
    check(e == 0, f"K-mm-norm differs from plain or from _int_mm + normalize ({e})")
    errs["digit_mm_norm"] = max(errs["digit_mm_norm"], e)
    ms_n = cuda_ms(lambda: ntt_mm.digit_mm_norm(fp, W8, DT, y_major=True), 5)
    unfused_ms = cuda_ms(
        lambda: ntt_mm._normalize_cols(fp, ntt_mm.digit_mm(W8, DT, y_major=True)), 5)
    bms, by = bound(W8.numel() + D8.numel() + gotn.numel() * 4,
                    2 * nd * nd * r * q * mm, INT8_OPS_PER_S)
    log(f"  K-mm-norm (33,1024,1024)x(33,1024,1024) == plain: {ms_n:.3f} ms  "
        f"K-mm + PyTorch _normalize_cols {unfused_ms:.3f} ms  plain {plain_n_ms:.1f} ms  "
        f"torch._int_mm + _normalize_cols {library_ms:.3f} + {lib_norm_ms:.3f} ms  "
        f"bound {bms:.3f} ms ({by})")
    entries["digit_mm_norm"] = {
        "ms": ms_n, "plain_ms": plain_n_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": library_ms + lib_norm_ms, "unfused_ms": unfused_ms}
    return entries


# ------------------------------------------------------------- PLONK phases

def plonk_circuit(fr):
    """The squaring chain as an r1cs (wire 0 = 1, wire 1 = public x,
    wire i+2 = wire_{i+1}^2) with its witness."""
    nc = PLONK_CONSTRAINTS
    i = np.arange(nc, dtype=np.int32)
    r1cs = R1cs(
        n8=fr.n8, prime=fr.p, n_wires=nc + 2, n_pub_out=0, n_pub_in=1, n_prv_in=0,
        n_labels=nc + 2, n_constraints=nc, m=np.tile(np.array([0, 1, 2], np.int32), nc),
        c=np.repeat(i, 3), s=np.stack([i + 1, i + 1, i + 2], 1).reshape(-1),
        vals=np.tile(np.array(fr.limbs(1), dtype=np.uint32)[:, None], (1, 3 * nc)))
    w = [1, 0xDEADBEEF]
    for _ in range(nc):
        w.append(w[-1] * w[-1] % fr.p)
    return r1cs, Witness(n8=fr.n8, q=fr.p, n=len(w), values=ftorch.np_from_ints(fr, w))


def plonk_synthetic_key(cv, tables, r1cs, dev):
    """The PLONK key of `r1cs`, written by the port's own writer on the card.
    The SRS is tiled from the 512 multiples of G1 (point i is ((i mod 512) +
    1) G), and the key's commitments are the closed forms over that tiling."""
    fr, fq = cv.fr, cv.fq
    domain = 1 << max((r1cs.n_constraints + r1cs.n_public - 1).bit_length(), 3)
    M = domain + 6
    (gx, gy), _ = tables
    ptau_lem = pcodec.g1_lem_to_bytes(fq, tiled(gx, M), tiled(gy, M),
                                      np.zeros(M, dtype=bool))

    def commit(vals_plain):
        k = sum(v * (i % 512 + 1) for i, v in enumerate(vals_plain)) % fr.p
        return hc.g1_mul(cv, cv.g1, k)

    zbytes = plonk_setup._write_plonk_zkey(cv, r1cs, commit, ptau_lem,
                                           hc.g2_mul(cv, cv.g2, 5), device=dev)
    zk = read_plonk_zkey(zbytes)
    check(zk.domain_size == domain and zk.ptau[2].shape[0] == M,
          "synthetic PLONK key has an unexpected domain or SRS length")
    return zk, len(zbytes)


def plain_ints(ctx, t):
    """(NL, n) Montgomery tensor on the card -> list of plain ints."""
    return ftorch.np_to_ints(ctx.fp, ftorch.from_mont(ctx, t.contiguous()))


def horner(coefs, x, p):
    acc = 0
    for c in reversed(coefs):
        acc = (acc * x + c) % p
    return acc


POINTS = ("A", "B", "C", "Z", "T1", "T2", "T3", "Wxi", "Wxiw")
EVALS = ("eval_a", "eval_b", "eval_c", "eval_s1", "eval_s2", "eval_zw")


def check_plonk_proof(cv, zk, proof, publics, out, dev):
    """A key tiled from 512 points has no tau, so no pairing check: instead
    every commitment against its closed form, every evaluation against host
    Horner over the downloaded polynomials, and the quotient identity at xi,
    all on host bigints."""
    fr = cv.fr
    p = fr.p
    ctx = ftorch.get_ctx(fr.name)
    n = zk.domain_size
    pts = {k: plonk._g1_from_obj(proof[k]) for k in POINTS}
    evals = {k: int(proof[k]) for k in EVALS}
    for name in POINTS:
        k = weighted_sum(ftorch.from_mont(ctx, out[name].contiguous()), 512, p)
        check(hc.g1_mul(cv, cv.g1, k) == pts[name],
              f"PLONK commitment {name} differs from its closed form")
    log("  nine commitments == closed forms on host bigints")

    vk = {"Qm": zk.qm, "Ql": zk.ql, "Qr": zk.qr, "Qo": zk.qo, "Qc": zk.qc,
          "S1": zk.s1, "S2": zk.s2, "S3": zk.s3}
    pubs = [int(x) for x in publics]
    ch = plonk.compute_challenges(cv, vk, pubs, pts, evals)
    beta, gamma, alpha, xi = ch["beta"], ch["gamma"], ch["alpha"], ch["xi"]
    w = fr.w[zk.power]
    pol = {name: plain_ints(ctx, out[name]) for name in ("A", "B", "C", "Z", "T1", "T2", "T3")}
    keyp = lambda name: plain_ints(ctx, ftorch.to_tensor(getattr(zk, name + "_p4")[0], dev))
    at = lambda name, x: horner(keyp(name), x, p)
    s1, s2, s3 = at("sigma1", xi), at("sigma2", xi), at("sigma3", xi)
    host = {"eval_a": horner(pol["A"], xi, p), "eval_b": horner(pol["B"], xi, p),
            "eval_c": horner(pol["C"], xi, p), "eval_s1": s1, "eval_s2": s2,
            "eval_zw": horner(pol["Z"], xi * w % p, p)}
    for name in EVALS:
        check(host[name] == evals[name], f"PLONK {name} differs from host Horner")
    log("  six evaluations == host Horner over the downloaded polynomials")

    a, b, c, zw = evals["eval_a"], evals["eval_b"], evals["eval_c"], evals["eval_zw"]
    z = horner(pol["Z"], xi, p)
    xin = pow(xi, n, p)
    zh = (xin - 1) % p
    lag = lambda wi: wi * zh % p * pow(n * (xi - wi) % p, p - 2, p) % p
    pi = -sum(x * lag(pow(w, i, p)) for i, x in enumerate(pubs)) % p
    gate = (a * b * at("qm", xi) + a * at("ql", xi) + b * at("qr", xi)
            + c * at("qo", xi) + pi + at("qc", xi)) % p
    bx = beta * xi % p
    perm = ((a + bx + gamma) * (b + bx * zk.k1 + gamma) * (c + bx * zk.k2 + gamma) * z
            - (a + beta * s1 + gamma) * (b + beta * s2 + gamma)
            * (c + beta * s3 + gamma) * zw) % p
    rhs = (gate + alpha * perm + alpha * alpha * (z - 1) * lag(1)) % p
    tval = (horner(pol["T1"], xi, p) + xin * horner(pol["T2"], xi, p)
            + xin * xin * horner(pol["T3"], xi, p)) % p
    check(tval * zh % p == rhs, "PLONK quotient identity fails at xi")
    log("  quotient identity t(xi) * Z_H(xi) == gates + alpha * permutation + "
        "alpha^2 * (z - 1) * L_1 holds at xi on host bigints")


def phase_plonk_prove(dev, tables):
    cv = hc.BN254
    fr = cv.fr
    t = time.perf_counter()
    r1cs, wit = plonk_circuit(fr)
    zk, nbytes = plonk_synthetic_key(cv, tables, r1cs, dev)
    log(f"  2^{zk.power} PLONK key ({nbytes / 1e6:.0f} MB, {zk.n_constraints} gates, "
        f"SRS {zk.ptau[2].shape[0]} points) + witness built in "
        f"{time.perf_counter() - t:.1f} s")
    check(zk.power == 18, "the PLONK domain is not 2^18")
    b = list(range(101, 113))
    t = time.perf_counter()
    plonk.prove(zk, wit, b=b, device=dev)
    torch.cuda.synchronize()
    log(f"  first prove (uploads the key): {time.perf_counter() - t:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    with recorded_shapes() as shapes:
        reset_counts()
        prove_ms, (proof, publics) = wall_ms(lambda: plonk.prove(zk, wit, b=b, device=dev))
        launches = counts()
    peak = torch.cuda.max_memory_allocated()
    # the same prove once more through the rounds function, which also hands
    # back the polynomials behind the proof
    proof2, publics2, out = plonk._prove_rounds(zk, wit, b, None, dev)
    check(json.dumps([proof2, publics2]) == json.dumps([proof, publics]),
          "the rounds function and `prove` give different PLONK proofs")
    log(f"  warm prove: {prove_ms:.1f} ms; launches {launches}; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    log(f"  shapes: {shapes_json(shapes)}")
    check(launches["field_ops"] > 0 and launches["msm_scan"] == 9
          and launches["digit_mm_norm"] == 20 and launches["digit_mm"] == 0,
          "PLONK path: expected 9 K-scan, 20 K-mm-norm and no K-mm launches")
    check_plonk_proof(cv, zk, proof, publics, out, dev)
    return zk, wit, b, prove_ms, launches, shapes, out["A"]


STAGE_SHAPES = {(1024, 1024, 1024): 12, (256, 256, 1024): 4, (1024, 1024, 256): 4}
BIG = (1024, 1024, 1024)


def phase_plonk_shapes(dev, gen, zk, pol_a, shapes, errs, rate32):
    """K-scan and K-mm-norm against their plain versions at every shape the
    counted PLONK prove called them with, each with its time and bound there.
    The 1024^3 stage has been held and timed with the Groth16 shapes; its
    entry is completed there."""
    cv = hc.BN254
    ctx = ftorch.get_ctx(cv.fr.name)
    seen = shapes["msm_scan"]
    check(len(seen) == 1 and sum(seen.values()) == 9,
          f"the PLONK prove's nine MSMs do not share one K-scan shape: {dict(seen)}")
    M = zk.ptau[2].shape[0]
    scal = fops.pad_to(ftorch.from_mont(ctx, pol_a.contiguous()), M)
    scan = scan_case(cv, "g1", plonk._dev_key(zk, dev, M)["ptau"], scal, seen,
                     "plonk", rate32, errs)
    norm = shapes["digit_mm_norm"]
    check(dict(norm) == STAGE_SHAPES,
          f"the PLONK prove's 20 NTT stage shapes are not the expected ones: {dict(norm)}")
    norms = [mm_case(dev, gen, "digit_mm_norm", sh, n, "plonk", errs)
             for sh, n in sorted(norm.items()) if sh != BIG]
    return scan, norms


def phase_ntt_path(dev, gen, errs):
    """K-mm's path: a forward and an inverse 2^20 NTT and an inverse 2^18 NTT on
    bn254 Fr with `fused=False`, counted; each result equal limb for limb to
    the default route's; then K-mm against its plain version at every shape
    the path gave it but 1024^3, which the Groth16 phase held and timed."""
    ctx = ftorch.get_ctx("bn254_fr")
    a20 = rand_field(ctx.fp, 1 << 20, dev, gen)
    a18 = rand_field(ctx.fp, 1 << 18, dev, gen)
    cases = (("ntt 2^20", ntt_mm.ntt, a20), ("intt 2^20", ntt_mm.intt, a20),
             ("intt 2^18", ntt_mm.intt, a18))
    with recorded_shapes() as shapes:
        reset_counts()
        ms, got = wall_ms(lambda: [fn(ctx, a, fused=False) for _, fn, a in cases])
        launches = counts()
    log(f"  ntt, intt 2^20 and intt 2^18 with fused=False: {ms:.1f} ms; launches {launches}")
    log(f"  shapes: {shapes_json(shapes)}")
    check(launches["digit_mm"] == 6 and launches["digit_mm_norm"] == 0
          and launches["field_ops"] > 0,
          "NTT path: expected 6 K-mm launches, no K-mm-norm, and K-field twiddles")
    check(dict(shapes["digit_mm"]) == {BIG: 4, (256, 256, 1024): 1, (1024, 1024, 256): 1},
          f"the NTT path's K-mm shapes are not the expected ones: {dict(shapes['digit_mm'])}")
    for (what, fn, a), g in zip(cases, got):
        e = max_abs_err(g, fn(ctx, a))
        check(e == 0, f"{what}: fused=False differs from the default route ({e})")
        errs["digit_mm"] = max(errs["digit_mm"], e)
    check(max_abs_err(ntt_mm.intt(ctx, got[0]), a20) == 0, "intt(ntt(a)) != a at 2^20")
    log("  each == the default route's output limb for limb; intt(ntt(a)) == a")
    mms = [mm_case(dev, gen, "digit_mm", sh, n, "ntt fused=False", errs)
           for sh, n in sorted(shapes["digit_mm"].items()) if sh != BIG]
    return launches, shapes, mms


class RoundClock:
    """A logger for `plonk.prove`: the prover announces each round with
    `debug`; this synchronises the card there and keeps the host time."""

    def __init__(self):
        self.marks = [("start", time.perf_counter())]

    def debug(self, msg):
        torch.cuda.synchronize()
        self.marks.append((msg.split(":")[0], time.perf_counter()))

    def rounds_ms(self, end):
        names = ["before round 1"] + [m[0] for m in self.marks[1:]]
        times = [m[1] for m in self.marks] + [end]
        return {nm: round((t1 - t0) * 1e3, 1)
                for nm, t0, t1 in zip(names, times, times[1:])}


def phase_plonk_times(dev, zk, wit, b, prove_ms):
    paired = paired_proves(lambda: plonk.prove(zk, wit, b=b, device=dev), "PLONK 2^18")
    clock = RoundClock()
    plonk.prove(zk, wit, b=b, device=dev, logger=clock)
    torch.cuda.synchronize()
    log("  rounds ms: " + json.dumps(clock.rounds_ms(time.perf_counter())))
    profile_busy(lambda: plonk.prove(zk, wit, b=b, device=dev), prove_ms)
    return paired


def sass_tensor_core_counts():
    """IGMMA (wgmma) and IMMA (mma.sync) instructions in the SASS of the two
    digit-matmul libraries; fails unless each holds some."""
    for src in ("digit_mm", "digit_mm_norm"):
        sass = subprocess.run([_cuobjdump(), "-sass", _build.lib_path(src)],
                              capture_output=True, text=True)
        check(sass.returncode == 0, f"cuobjdump failed on {src}: {sass.stderr[-500:]}")
        igmma, imma = sass.stdout.count("IGMMA"), sass.stdout.count("IMMA.")
        log(f"  {src}: SASS holds {igmma} IGMMA and {imma} IMMA instructions")
        check(igmma + imma > 0, f"{src} holds no tensor-core instruction")


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

    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for src, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    regs = scan_registers()
    log(f"  K-scan registers, local memory and spills: {json.dumps(regs)}")
    check(all(regs[k]["spill_stores"] == 0 for k in ("bn254 G1", "bn254 G2")),
          "a bn254 K-scan instantiation spills")
    log(f"  K-scan SASS of one step: {json.dumps(scan_sass_counts())}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    sass_tensor_core_counts()
    tables = point_tables(hc.BN254)
    log("[kernels vs plain]")
    errs = phase_kernels_small(dev, gen, tables)
    log(f"[fixture proofs] ({time.perf_counter() - t0:.1f} s so far)")
    phase_fixture(dev)
    phase_plonk_fixture(dev)
    log("[2^20 Groth16 prove]")
    zkey, wit, prove_ms, launches, shapes = phase_full_prove(dev, tables)
    log("[where the time goes]")
    _, paired_g = phase_breakdown(dev, zkey, wit, prove_ms)
    log("[Groth16 main-path shapes and times]")
    rate32 = imad_per_s()
    entries = phase_main_shapes_and_times(dev, gen, zkey, wit, errs, shapes, rate32)
    del zkey, wit
    torch.cuda.empty_cache()
    log(f"[2^18 PLONK prove] ({time.perf_counter() - t0:.1f} s so far)")
    pzk, pwit, pb, plonk_ms, pl, pshapes, pol_a = phase_plonk_prove(dev, tables)
    log("[PLONK main-path shapes and times]")
    pscan, pnorms = phase_plonk_shapes(dev, gen, pzk, pol_a, pshapes, errs, rate32)
    del pol_a
    log("[where the PLONK prove's time goes]")
    paired_p = phase_plonk_times(dev, pzk, pwit, pb, plonk_ms)
    del pzk, pwit
    torch.cuda.empty_cache()
    log(f"[NTT path: K-mm] ({time.perf_counter() - t0:.1f} s so far)")
    nl, nshapes, nmms = phase_ntt_path(dev, gen, errs)

    # `launches` is a kernel's count on a driven path: the PLONK prove, but
    # for K-mm, which no prove runs (the NTT path's).  `ms`, `plain_ms` and
    # `bound_ms` belong to `shape`, the shape that path gave the kernel most
    # often.  `shapes` lists every shape the paths gave the kernel (K-field
    # has too many), each with its own launches, error, times and bound.
    mm_big = dict(entries["digit_mm"], path="ntt fused=False", shape=list(BIG),
                  launches=nshapes["digit_mm"][BIG], max_abs_err=errs["digit_mm"])
    norm_big = dict(entries["digit_mm_norm"], path="plonk", shape=list(BIG),
                    launches=pshapes["digit_mm_norm"][BIG],
                    max_abs_err=errs["digit_mm_norm"])
    rows = [
        ("field_ops", "snarkjs_tpu_torch/csrc/field_ops.cu",
         "snarkjs_tpu/fields/fpal.py:449",
         dict(entries["field_ops"], shape=[16, 1 << 20]), []),
        ("msm_scan", "snarkjs_tpu_torch/csrc/msm_scan.cu",
         "snarkjs_tpu/curves/msm_tpu.py:213", pscan, [pscan] + entries["msm_scan"]),
        ("digit_mm", "snarkjs_tpu_torch/csrc/digit_mm.cu",
         "snarkjs_tpu/ntt/ntt_mxu.py:320", mm_big, [mm_big] + nmms),
        ("digit_mm_norm", "snarkjs_tpu_torch/csrc/digit_mm_norm.cu",
         "snarkjs_tpu/ntt/ntt_mxu.py:457", norm_big, [norm_big] + pnorms),
    ]
    kernels = []
    for kname, src, replaces, first, every in rows:
        k = dict({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                  "library_ms": None}, **first)
        k.update(launches=nl[kname] if kname == "digit_mm" else pl[kname],
                 max_abs_err=errs[kname], launches_groth16=launches[kname],
                 launches_plonk=pl[kname], launches_ntt_path=nl[kname], shapes=every)
        check(k["launches"] > 0, f"{kname} was launched on no driven path")
        kernels.append(k)
    kernels[0]["launches_by_op"] = pl["field_by_op"]
    kernels[0]["launches_by_op_groth16"] = launches["field_by_op"]
    log(f"prove_2^20_warm_ms: {prove_ms}  paired: {json.dumps(paired_g)}")
    log(f"plonk_prove_2^18_warm_ms: {plonk_ms}  paired: {json.dumps(paired_p)}")
    kernels[1]["registers"] = regs
    log(f"K-scan registers, local memory and spills: {json.dumps(kernels[1]['registers'])}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
