#!/usr/bin/env python3
"""Drive snarkjs_tpu_torch on one NVIDIA card: build, check, prove, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. the card's name and power limit;
  2. build csrc/*.cu with nvcc (one process per source, in parallel); print
     each K-scan instantiation's registers and local memory (from the loaded
     library) and spills (the ptxas report of that library) and the SASS
     instructions of one step by class, and the registers and local memory
     of each K-reduce instantiation; the SASS of K-mm and
     K-mm-norm must hold tensor-core instructions (IGMMA / IMMA);
  3. each kernel against its plain PyTorch version on the card, limb for limb:
     K-field (all four ops; bn254 Fr/Fq, bls12-381 Fq; 2^20 elements with the
     edge values and to_mont of limbs in [p, R)), K-scan (every instantiation:
     bn254 and bls12-381, G1 and G2, cw=8, 2^12 points; bn254 G1 also on a
     lane count that is no multiple of 128 and with C = 1), K-reduce on each
     of those K-scan outputs (each window's partial equal, as an affine
     point), K-mm and K-mm-norm (1024 x 1024 x 1024, r = 4 with
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
     against the one assembled from the closed forms;
  6. each kernel against its plain version at the shapes that prove gave it,
     with times (CUDA events) of the kernel, its plain version and, for K-mm
     and K-mm-norm at 1024^3, one torch._int_mm on the Toeplitz-expanded
     digit matrix; K-field also its device time a launch under
     torch.profiler;
  7. the full-width PLONK prove: the 200,000-constraint squaring chain
     (domain n = 2^18, 4n = 2^20), its key written by `_write_plonk_zkey` on
     the card with an SRS tiled from the 512 multiples of G1; launch counts
     set to 0 just before, read just after; nine commitments against their
     closed forms, six evaluations against host Horner, the quotient identity
     at xi on host bigints; then K-scan and K-mm-norm against their plain
     versions at every shape that prove called them with (the shapes are
     recorded during the counted prove: the scan input is rebuilt from the
     key's SRS and the blinded polynomial A), each with its time and bound;
  8. K-mm, which no route of the program launches (held only), against its
     plain version at (512, 512, 512), with its time and bound;
  9. the NTT's stage split (`ntt_mm._split`): each 2^k NTT a driven path runs
     (k = 11, 12, 16, 18-23, and a rank's 4096-point axes of the mesh's 2^24
     NTT) timed, its inverse giving the input back; K-mm-norm against its
     plain version at every stage shape of the split at 2^21-2^23 and on the
     mesh's axes (2^22's also on bls12-381 Fr), none under a 64-row tile;
 10. Groth16 setup from a prepared .ptau: a power-19 bn128 .ptau built on the
     card from fixed secrets (every point by the port's batched
     double-and-add; sections 2-6, 12-15 as one contribution and
     preparePhase2 leave them), round-tripped through `tobytes`/`read_ptau`;
     K-field against its plain version at 2^21 and at 2^18 + 37 elements;
     `groth16_setup.setup_from_ptau` on the 200,000-constraint chain (domain
     2^18), timed once with every coefficient 1 and then on the chain with
     circom's coefficients (p - 1 on a factor and on the output, so every
     segmented MSM runs all 254 steps): sections 1-9 of that zkey equal to
     `write_groth16_zkey(setup_from_secrets(...))` with the same secrets, one run under
     torch.profiler for the busy share; a Groth16 proof with the key passing
     the pairing check, a tampered public rejected;
 11. PLONK setup from the same .ptau: `plonk_setup.setup_from_ptau` on the
     same chain and a PLONK proof the same way.  Launch counts set to 0 just
     before each of the .ptau build and the two setups and read just after
     (`launches_setup`);
 12. FFLONK at domain 2^18: `fflonk_setup.setup_from_secrets` on the
     200,000-constraint chain with a fixed tau (SRS of 9n + 18 = 2,359,314
     points by the batched double-and-add, checked against host scalar
     multiplication at five indices; the host tau powers and their limb
     packing timed alone beside it), counted; `fflonk_setup.setup_from_ptau`
     of a 60,000-constraint chain (domain 2^16, 589,842 SRS points) from
     phase 10's .ptau, byte-equal to `setup_from_secrets` with that .ptau's
     tau; one counted 2^18 prove (launch counts set to 0 just before, read
     just after) that passes `fflonk.verify`'s pairing check while a tampered
     public and a tampered evaluation are rejected; warm proves (median,
     spread, peak memory), rounds 1-5 through a logger, one prove under
     torch.profiler; then K-scan and K-mm-norm against their plain versions
     at every shape the phase gave them, each with its time and bound;
 13. the powers-of-tau ceremony on bn128 at power 19: phase 10's secrets are
     the private keys that ChaCha(CEREMONY_SEED) gives `keypair.create_ptau_key`
     on a blank accumulator's first challenge, so one `contribute` to
     `new_accumulator` must give phase 10's sections 2-6 byte for byte; the
     rest of the phase runs on a contribution of power 14 with the same seed
     (CEREMONY_CHAIN_POWER, cut from 19 for time: the group iNTT's blocks of
     2^15 to 2^20 points run on the card only in the profiled stages below),
     whose sections 2-6 must be phase 10's prefixes: `prepare_phase2` of it
     gives phase 10's sections 12-15 as `prepared_equal` holds them (13-15
     and 12's blocks up to 2^14 are prefixes, 12's last block follows by the
     reference's zero-point identity); `verify` (with the
     Lagrange check, a fixed numpy Generator) accepts the prepared file and
     rejects a copy with two tauG1 points swapped; export_challenge ->
     challenge_contribute -> import_response -> beacon -> verify accepts; a
     response with one flipped point byte is refused; truncate to power 10,
     convert (held by `prepared_equal`, as prepare_phase2 of that file
     would be, which is not run again for time) and export_json.
     Launch counts set to 0 just before contribute, prepare_phase2 and
     verify and read just after, beside
     the counts predicted from the code; one G1 and one G2 stage of the
     batched group iNTT timed and profiled alone; K-field, K-scan and
     K-mm-norm against their plain versions at the shapes the phase gave them
     (a shape held in an earlier phase is not held again, here and in the
     phases after);
 14. Groth16 phase 2 at domain 2^18 on phase 10's key (the chain with
     circom's coefficients) and .ptau: zkey contribute and beacon, five
     points of sections 8 and 9 and the header's delta against host bigints,
     verify_from_init (accepts the result; rejects two swapped L points and a
     flipped transcript byte), verify_from_r1cs, export_mpc_params ->
     bellman_contribute -> import_mpc_params with the imported key verified
     and a flipped csHash byte refused, Groth16 proofs with the final and the
     imported key passing the pairing check (tampered publics rejected), and
     the Solidity verifier of the final key holding its constants.  Launch
     counts set to 0 just before contribute, verify_from_init, the export
     and the import and read just after, beside the counts predicted from
     the code; one stage of the H points' group iNTT timed and profiled
     alone; K-field, K-scan and K-mm-norm against their plain versions at
     the shapes the phase gave them;
 15. the CLI and witness calculation at domain 2^18: the 200,000-constraint
     chain with circom's coefficients as circom would give it (.wasm with
     circom 2's witness ABI, .r1cs, .sym, input.json from
     tests/_wasm_chain.py) and phase 10's .ptau written to a temporary
     directory; `python -m snarkjs_tpu_torch r1cs info` once as a
     subprocess, then every step through `cli.main` in-process, launch
     counts set to 0 just before each and read just after (`launches_cli`):
     `wtns calculate` (the native VM's instantiation, calculation and
     read-out timed alone; its .wtns byte-equal to circom_chain's witness;
     the Python VM on a chain of 2^10 equal to the native one), `wtns check`
     (accepts; 16 K-field launches as counted; a flipped value exits 1),
     `groth16 setup` (byte-equal to phase 10's
     key), `groth16 prove` / `fullprove` / `verify` (a tampered public exits
     1) and `zkey export soliditycalldata`, `plonk setup` / `fullprove` /
     `verify`, `fflonk setup` / `fullprove` / `verify` on a chain of 60,000
     (domain 2^16); each step's wall time beside the in-process time of the
     same call in the earlier phases; the shapes every CLI step gave K-field,
     K-scan and K-mm-norm recorded, and each kernel held against its plain
     version at every one of them;
 16. the multi-device path on the one card (`parallel.distributed`,
     `parallel.sharded`): the keys, witnesses and proofs of phases 5, 7 and
     12 and phase 10's .ptau are written to a temporary directory; one rank
     over NCCL proves the 2^20 Groth16 key over a mesh of one (byte-equal to
     phase 5's proof; its warm time beside phase 5's); then four Gloo ranks,
     all on cuda:0, in one spawn: `ntt_sharded` forward and inverse at 2^24
     (both axes through K-mm-norm) and 2^20 (butterflies), limb-equal to the
     unsharded `ntt_mm` NTTs; the Groth16 (2^20), PLONK and FFLONK (2^18)
     proves over the mesh byte-equal to phases 5, 7 and 12; `contribute`
     over the mesh (sections 2-6 equal to phase 10's) and `prepare_phase2`
     of the power-8 truncation of phase 10's file (PREPARE_POWER, cut from
     19 for time: the least power whose G1 and G2 blocks both reach the
     sharded group iNTT, which must take exactly the blocks of 2^8 points
     and more on every rank; held by `prepared_equal`);
     `msm_sharded` and the legacy Pippenger at 2^12
     equal to `GpuMSM.run`.  Each step's launches counted on every rank
     (`launches_mesh`), every shape the ranks gave K-scan, K-mm-norm and
     K-field held against the plain version (but those held in the earlier
     phases); the CLI's `--devices 2` refused before any rank starts and
     `--devices 1` proving;
 17. the MSM keywords: phase 7's bn128 PLONK key proved once more with
     msm_c=4, msm_cw=8 (launch counts set to 0 just before, read just
     after: 9 K-scan over 32 windows, 20 K-mm-norm), the proof byte-equal to
     phase 7's; K-scan held against its plain version at the cw = 8 shapes
     it gave;
 18. the stored bls12-381 fixtures on the card, counted: the PLONK proof of
     tiny_plonk_bls12381 byte-equal to the stored JAX proof, verified, a
     tampered public rejected; Groth16 `setup_from_ptau` of the 3-constraint
     chain from tiny_p4_bls12381.ptau byte-equal to
     tiny3_bls12381_from_ptau.zkey, and a proof with it equal to the CPU
     prove's, passing the pairing check, a tampered public rejected; the
     bls12381_p3 ceremony chain of tests/_torch_ceremony.py (new ->
     contribute -> challenge / response -> beacon -> prepare -> verify ->
     truncate -> convert -> json) equal to the stored JAX run in every hash
     and verify result; then K-field, K-scan and K-mm-norm against their
     plain versions at every shape the phase gave them;
 19. phase 5's 2^20 Groth16 prove on bls12-381 (point sections tiled from
     512 multiples of its G1 and 64 of its G2), with phase 5's checks and
     launch counts (12 K-mm-norm, 5 K-scan, no K-mm; K-field logged beside
     phase 5's count); K-field's times on bls12-381 Fr and Fq at (NL,
     2^20); K-scan against its plain version at the prove's
     three shapes, K-mm-norm on bls12-381 Fr at 1024^3 and
     K-field at every (field, elements) the prove gave it;
 20. phase 7's 2^18 PLONK prove on bls12-381 (SRS tiled from its 512
     multiples of G1), with phase 7's checks and launch counts (9 K-scan,
     20 K-mm-norm, no K-mm), WARM_BLS warm proves, then K-scan, K-mm-norm
     and K-field against their plain versions
     at every shape it gave them;
 21. K-scan's registers, local memory and spills, the kernels line (K-field,
     K-scan, K-reduce, K-mm, K-mm-norm: launches on each path, times, bounds;
     K-reduce's launches on every path, step and rank 4 for each K-scan's),
     then the contract line.

K-scan is held against its plain version on every lane of each bn128
shape, and on the first BLS_HOLD_LANES lanes of each bls12-381 shape: the
kernel runs the whole shape, a lane's scan reads only its own points, and
the MSM closed forms, proofs and file bytes of each phase check every lane
end to end.  Wherever K-scan is held, K-reduce is held on its output, on
the same lanes (their keys are a prefix of the sorted keys), window by
window as affine points, and timed on the whole shape.

Depths cut for the time limit (no check dropped): phase 13's chain at
CEREMONY_CHAIN_POWER, phase 16's prepare_phase2 at PREPARE_POWER (above);
FFLONK_PROVES warm proves in phase 12, WARM_BLS in phase 20; a shape
held against the plain version in one phase is not held again in a later
one.  The whole proves' times of the benchmark's cells are the benchmark's
(benchmark/run.py); bounds take the card's peaks from
benchmark/harness/peaks.py.

Every NTT stage goes through K-mm-norm, the one route of
`ntt_mm._mm_stage`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import hashlib
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import peaks
from snarkjs_tpu_torch import _build, cli, tools, trace
from snarkjs_tpu_torch.ceremony import bellman, keypair, ptau_ops, zkey_mpc
from snarkjs_tpu_torch.curves import host_curve as hc
from snarkjs_tpu_torch.curves import jac
from snarkjs_tpu_torch.curves import msm as msm_mod
from snarkjs_tpu_torch.curves import msm_gpu
from snarkjs_tpu_torch.export import solidity
from snarkjs_tpu_torch.fields import fcuda, ftorch
from snarkjs_tpu_torch.formats import points as pcodec
from snarkjs_tpu_torch.formats import ptau as ptau_fmt
from snarkjs_tpu_torch.formats.binfile import BinFile
from snarkjs_tpu_torch.formats.r1cs import read_r1cs
from snarkjs_tpu_torch.formats.wtns import Witness, write_wtns
from snarkjs_tpu_torch.formats.zkey import Groth16Zkey, read_groth16_zkey, read_plonk_zkey
from snarkjs_tpu_torch.formats.zkey import read_fflonk_zkey
from snarkjs_tpu_torch.ntt import ntt_mm
from snarkjs_tpu_torch.poly import fops
from snarkjs_tpu_torch.protocols import groth16, groth16_setup, plonk, plonk_setup
from snarkjs_tpu_torch.protocols import fflonk, fflonk_setup
from snarkjs_tpu_torch.utils.chacha import ChaCha
from snarkjs_tpu_torch.wasm import native as wasm_native
from snarkjs_tpu_torch.wasm import witness_calculator as wvm
from tests import _wasm_chain as wasm_chain
from tests._torch_inputs import (add_products, build_ptau, circom_chain, madd_products,
                                  plonk_circuit, point_tables, ptau_scalars, tiled)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "snarkjs_tpu_torch", "fixtures")
INT8_OPS_PER_S = 1.979e15   # H100 SXM dense int8 tensor-core peak
N_CONSTRAINTS = 600_000
BLS_HOLD_LANES = 1024        # K-scan's plain version runs on this many lanes of a
                             # bls12-381 prove's shape (a lane reads only its own
                             # points, and the MSMs' checks cover every lane)


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


STASH = {"dir": None}   # files the earlier phases hand to phase 16's ranks


def stash_path(name):
    return os.path.join(STASH["dir"], name)


def stash_bytes(name, data):
    with open(stash_path(name), "wb") as f:
        f.write(data)


def stash_json(name, obj):
    with open(stash_path(name), "w") as f:
        json.dump(obj, f)


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
    trace.reset_counters()


def counts():
    c = trace.counters()
    return {"field_ops": c["k_field"],
            "field_by_op": {op: c["k_field." + op] for op in fcuda.OPS},
            "msm_scan": c["k_scan"], "msm_reduce": c["k_reduce"], "digit_mm": c["k_mm"],
            "digit_mm_norm": c["k_mm_norm"]}


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
    k = min(n, len(edges))
    x[:, :k] = ftorch.to_tensor(
        np.array([fp.limbs(v) for v in edges[:k]], dtype=np.uint32).T, dev)
    return x


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
    errs = {"field_ops": 0, "msm_scan": 0, "msm_reduce": 0, "digit_mm": 0}
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
    with 300 points on 300 lanes (C = 1, one ragged block).  K-reduce on each
    K-scan output against its plain version, window by window as affine
    points.  Returns the largest difference of K-scan (0)."""
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
                e = reduce_held(cv, m, got, sorted_keys(xyT), xyT.shape[3])[0]
                check(e == 0, f"K-reduce {cv.name} {group} {tuple(got.shape)} differs from "
                              f"plain in {e} windows")
                log(f"  K-scan {cv.name} {group} cw=8 {npts} points {tuple(xyT.shape)} == plain; "
                    "K-reduce's window points == plain")
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


def phase_plonk_fixture(dev, stem="tiny_plonk_bn128"):
    with open(os.path.join(FIXTURES, f"{stem}_proof.json")) as f:
        want = json.load(f)
    zk = os.path.join(FIXTURES, f"{stem}.zkey")
    proof, publics = plonk.prove_files(
        zk, os.path.join(FIXTURES, f"{stem}.wtns"), b=want["b"], device=dev)
    check(json.dumps([proof, publics]) ==
          json.dumps([want["proof"], want["publicSignals"]]),
          f"{stem}: PLONK proof differs from the stored JAX proof")
    vk = plonk.export_verification_key(read_plonk_zkey(zk))
    check(plonk.verify(vk, publics, proof), f"{stem}: PLONK proof does not verify")
    bad = [str(int(publics[0]) + 1)] + publics[1:]
    check(not plonk.verify(vk, bad, proof), f"{stem}: tampered public accepted (PLONK)")
    log(f"  {stem} PLONK fixture: proof bytes == stored JAX proof; verified; "
        "tampered public rejected")


def qap_inputs(zkey, witness, dev):
    co = zkey.coeffs
    idx = lambda a: torch.from_numpy(a.astype("int64")).to(dev)
    return (ftorch.to_tensor(co["val"], dev), idx(co["m"]), idx(co["c"]),
            idx(co["s"]), ftorch.to_tensor(witness.values, dev))


def phase_full_prove(dev, tables, cv=hc.BN254):
    """The counted 2^20 Groth16 prove on `cv` and its checks.  Only bn128's
    key, witness and proof are written for phase 16.  Returns the key, the
    witness, the warm time, the launches, the shapes of the two digit
    matmuls and K-scan, and the (field, elements) of every K-field launch."""
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
    with recorded_shapes() as shapes, field_shapes() as fseen:
        reset_counts()
        prove_ms, (proof, publics) = wall_ms(
            lambda: groth16.prove(zkey, wit, r=r, s=s, device=dev, out=out))
        launches = counts()
    log(f"  warm prove ({cv.name}): {prove_ms:.1f} ms; launches {launches}")
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
    if cv is hc.BN254:
        t = time.perf_counter()
        stash_bytes("groth16.zkey", groth16_setup.write_groth16_zkey(zkey))
        stash_bytes("groth16.wtns", write_wtns(fr, wit.values))
        stash_json("groth16.json", {"r": r, "s": s, "proof": proof, "publics": publics,
                                    "warm_ms": prove_ms})
        log(f"  key, witness and proof written for phase 16 in "
            f"{time.perf_counter() - t:.1f} s")
    return zkey, wit, prove_ms, launches, shapes, fseen


def reduce_work(dsort, RL, half):
    """(adds, rows): the complete adds phase 2 needs at least, in any order,
    and the rows it reads.  A window of RL lanes takes RL - 1 adds for the
    exclusive suffix of its lane totals; each of its v valid rows (v =
    min(half, its largest magnitude): t = 1 .. v has a first sorted index
    with |digit| >= t) one add for its lane's carry and one into the sum.
    K-reduce makes about twice as many: its lane scan and its carry stage
    are not work-efficient."""
    v = (dsort[:, -1] >> 1).clamp(max=half).to(torch.int64)
    rows = int(v.sum())
    return int((RL - 1) * dsort.shape[0] + (2 * v - 1).clamp(min=0).sum()), rows


def profile_busy(fn, warm_ms):
    """One run of `fn` under torch.profiler: device time per kernel, and the
    busy share as that device time over `warm_ms`, the same work's wall time
    without the profiler (the profiler stretches the host side).  Only the
    device's own events count (kernels, copies): an aten op's row carries the
    device time of the kernels it launched, which have rows of their own.
    The device events are read from the profiler's raw results: building
    `key_averages()` costs about a millisecond a launch, minutes for a
    setup of 10^5 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = wall_ms(fn)
    t_read = time.perf_counter()
    by_kernel = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA and evt.duration_ns() > 0:
            by_kernel[evt.name()] = by_kernel.get(evt.name(), 0.0) + evt.duration_ns() / 1e6
    busy = sum(by_kernel.values())
    log(f"  profiler events read in {time.perf_counter() - t_read:.1f} s")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    if busy == 0:
        log("  profiler: no device time recorded (device busy share not measured)")
        return None
    log(f"  profiled run: wall {wall:.1f} ms (profiler on), device busy "
        f"{busy:.1f} ms; over the unprofiled run ({warm_ms:.1f} ms): "
        f"busy {100 * busy / warm_ms:.1f}%, idle {100 - 100 * busy / warm_ms:.1f}%")
    for k, v in top:
        log(f"    {v:9.2f} ms  {k[:90]}")
    return busy


BIG = (1024, 1024, 1024)
STAGE_SHAPES = {BIG: 12, (512, 512, 512): 8}   # a 2^18 PLONK prove's NTT stages
# what has been held against the plain version so far in the run, by
# (kernel, field): shapes of K-scan (field: the curve's Fq), K-mm and
# K-mm-norm (Fr), element counts of K-field
HELD = collections.defaultdict(set)


def sorted_keys(xyT):
    """The (nw, C*RL) sorted keys K-reduce reads, at position lane*C + c,
    from the last row of K-scan's input."""
    nw, C, _, RL = xyT.shape
    return xyT[:, :, -1].permute(0, 2, 1).reshape(nw, C * RL).contiguous()


def window_points(fq, flat, ext):
    """(3*nl*ext, nw) projective window partials -> affine host points
    (None for the identity)."""
    flat = ftorch.to_numpy(flat)
    nl, nw = fq.nl, flat.shape[1]
    ints = ftorch.np_to_ints(fq, flat.reshape(3 * ext, nl, nw).transpose(1, 0, 2))
    at = lambda k, w: fq.from_mont(ints[k * nw + w])
    el = lambda k, w: at(k, w) if ext == 1 else (at(2 * k, w), at(2 * k + 1, w))
    out = []
    for w in range(nw):
        X, Y, Z = el(0, w), el(1, w), el(2, w)
        if msm_mod._f_is_zero(Z, ext):
            out.append(None)
            continue
        zi = msm_gpu._f_inv(fq, Z, ext)
        out.append((msm_mod._f_mul(fq, X, zi, ext), msm_mod._f_mul(fq, Y, zi, ext)))
    return out


def reduce_held(cv, m, st_all, dsort, held):
    """K-reduce against its plain version on K-scan's output and its sorted
    keys, on the first `held` lanes (those lanes' scan is the scan of their
    points alone, and their keys are the first held * C of `dsort`):
    (windows whose affine points differ, plain ms)."""
    C, RL = st_all.shape[1], st_all.shape[3]
    if held < RL:
        st_all, dsort = st_all[..., :held].contiguous(), dsort[:, :held * C].contiguous()
    got = msm_gpu.reduce(cv.fq, m.b, m.ext, m.cw, st_all, dsort)
    plain_ms, want = wall_ms(lambda: msm_gpu.reduce_plain(cv.fq, m.b, m.ext, m.cw,
                                                          st_all, dsort))
    got, want = window_points(cv.fq, got, m.ext), window_points(cv.fq, want, m.ext)
    return sum(a != b for a, b in zip(got, want)), plain_ms


def reduce_case(cv, m, st_all, dsort, calls, path, errs, held):
    """K-reduce at the shape K-scan's output `st_all` has on a driven path
    (`calls` MSMs there): held against its plain version (on the first
    `held` lanes), its time on the whole shape, and its bound there from
    `reduce_work`'s adds."""
    nw, C, nro2, RL = st_all.shape
    shape = tuple(st_all.shape)
    before = trace.counters()["k_reduce"]
    msm_gpu.reduce(cv.fq, m.b, m.ext, m.cw, st_all, dsort)
    per = trace.counters()["k_reduce"] - before
    check(0 < per <= 4, f"K-reduce took {per} launches an MSM")
    ms = cuda_ms(lambda: msm_gpu.reduce(cv.fq, m.b, m.ext, m.cw, st_all, dsort), 3)
    e, plain_ms = reduce_held(cv, m, st_all, dsort, held)
    check(e == 0, f"K-reduce {cv.name} G{m.ext} {shape} differs from plain in {e} windows "
                  f"on {held} lanes")
    errs["msm_reduce"] = max(errs["msm_reduce"], e)
    adds, rows = reduce_work(dsort, RL, m.nb // 2)
    bs, by = peaks.bound_s((nw * RL + rows) * nro2 * 4,
                           adds * add_products(m.ext) * peaks.imads_per_product(cv.fq.nl // 2))
    bms = bs * 1e3
    log(f"  K-reduce {cv.name} {shape} cw={m.cw} x{calls} ({path}) == plain on {held} "
        f"lanes: {ms:.3f} ms  plain {plain_ms:.0f} ms  bound {bms:.3f} ms ({by}, {adds} adds)")
    out = {"path": path, "curve": cv.name, "ext": m.ext, "cw": m.cw, "shape": list(shape),
           "launches": calls * per, "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "adds": adds}
    if held < RL:
        out.update(plain_ms=None, plain_lanes_ms=plain_ms, plain_lanes=held)
    return out


def scan_case(cv, group, pts, scal, seen, path, errs, cw=16, lanes=None):
    """K-scan against its plain version on the input `run` builds for these
    points and scalars (window digits of cw bits), which must have a shape
    recorded in `seen`; its time and bound at that shape.  The kernel runs at
    the whole shape and is held against the plain version on every lane, on
    bls12-381 on its first BLS_HOLD_LANES lanes (a lane's scan reads only its
    own points); `plain_ms` is the plain version's time on the whole shape,
    and null where it ran on fewer lanes (`plain_lanes_ms`, `plain_lanes`).
    K-reduce on the kernel's output, held on the same lanes, under "reduce"
    (`reduce_case`)."""
    m = msm_gpu.get_msm(cv.name, group, cw=cw)
    xyT = m.scan_input(*pts, scal, lanes=lanes)
    shape = tuple(xyT.shape)
    check(shape in seen, f"K-scan {group} input {shape} is no shape of the {path} prove")
    ms = cuda_ms(lambda: msm_gpu.scan(cv.fq, m.b, m.ext, xyT), 3)
    got = msm_gpu.scan(cv.fq, m.b, m.ext, xyT)
    held = shape[3] if cv is hc.BN254 else min(BLS_HOLD_LANES, shape[3])
    part = xyT if held == shape[3] else xyT[..., :held].contiguous()
    plain_ms, want = wall_ms(lambda: msm_gpu.scan_plain(cv.fq, m.b, m.ext, part))
    e = max_abs_err(got[..., :held], want)
    check(e == 0, f"K-scan {cv.name} {group} {shape} differs from plain on {held} lanes ({e})")
    errs["msm_scan"] = max(errs["msm_scan"], e)
    HELD[("msm_scan", cv.fq.name)].add(shape)
    nw, C, nin, RL = shape
    nbytes = xyT.numel() * 4 + got.numel() * 4
    bs, by = peaks.bound_s(
        nbytes, nw * C * RL * madd_products(m.ext) * peaks.imads_per_product(cv.fq.nl // 2))
    bms = bs * 1e3
    log(f"  K-scan {cv.name} {group} {shape} x{seen[shape]} ({path}) == plain on {held} "
        f"lanes: {ms:.3f} ms  plain {plain_ms:.0f} ms ({held} lanes)  bound {bms:.3f} ms ({by})")
    out = {"path": path, "curve": cv.name, "group": group, "shape": list(shape),
           "launches": seen[shape], "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by}
    if held < shape[3]:
        out.update(plain_ms=None, plain_lanes_ms=plain_ms, plain_lanes=held)
    out["reduce"] = reduce_case(cv, m, got, sorted_keys(xyT), seen[shape], path,
                                errs, held)
    return out


def mm_bound_ms(nbytes, ops):
    """A digit matmul's least time in ms: its bytes at the card's HBM rate
    (benchmark/harness/peaks.py) or its int8 products at INT8_OPS_PER_S,
    whichever is longer."""
    tb, to = nbytes / peaks.HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def mm_case(dev, gen, kernel, shape, launches, path, errs, field="bn254_fr"):
    """K-mm or K-mm-norm (on `field`) against its plain version at one stage
    shape (r, q, m), with its time and bound there.  Compared in both operand
    layouts; timed as the NTT calls it, with the data digits y-major."""
    r, q, m = shape
    fp = ftorch.get_ctx(field).fp
    W8, D8 = mm_inputs(dev, gen, field, r.bit_length() - 1, r, q, m)
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
    check(e == 0, f"{kernel} {field} {shape} differs from plain ({e})")
    errs[kernel] = max(errs[kernel], e)
    HELD[(kernel, field)].add(tuple(shape))
    ms = cuda_ms(fn, 5)
    nd = W8.shape[0]
    bms, by = mm_bound_ms(W8.numel() + D8.numel() + want.numel() * 4, 2 * nd * nd * r * q * m)
    log(f"  {kernel} {field} {shape} x{launches} ({path}) == plain: {ms:.3f} ms  "
        f"plain {plain_ms:.1f} ms  bound {bms:.3f} ms ({by})")
    return {"path": path, "field": field, "shape": list(shape), "launches": launches,
            "max_abs_err": e, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def field_times(dev, gen, name):
    """K-field's four ops on `name` at (NL, 2^20): CUDA-event time, device
    time a launch (torch.profiler), the plain version's time and the bound.
    Returns mont_mul's entry with every op's under "ops"."""
    ctx = ftorch.get_ctx(name)
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
        bs, by = peaks.bound_s(
            nbytes, peaks.imads_per_product(n32) * (1 << 20) if op == "mont_mul" else 0)
        bms = bs * 1e3
        ops[op] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by}
        log(f"  K-field {name} {op} ({ctx.nl}, 2^20): {ms:.4f} ms (CUDA events over 20 "
            f"launches), device {dev_ms} ms a launch (torch.profiler)  plain {plain_ms:.2f} ms  "
            f"bound {bms:.4f} ms ({by})")
    return dict(ops["mont_mul"], field=name, ops=ops)


def phase_main_shapes_and_times(dev, gen, zkey, wit, errs, shapes):
    cv = hc.BN254
    ctx = ftorch.get_ctx("bn254_fr")
    # K-field at (16, 2^20), the NTT / coset shape
    entries = {"field_ops": field_times(dev, gen, "bn254_fr")}

    # K-scan at every shape the prove gave it: the A, B1 and C inputs share
    # one (A's is taken), then H's (G1) and B2's (G2)
    a_pts, _, b2_pts, _, h_pts = groth16._dev_points(zkey, dev)
    w = ftorch.to_tensor(wit.values, dev)
    p_odd = groth16.qap(ctx, zkey.domain_size, *qap_inputs(zkey, wit, dev))
    seen = shapes["msm_scan"]
    scans = [scan_case(cv, group, pts, scal, seen, "groth16", errs)
             for group, pts, scal in (("g1", a_pts, w), ("g1", h_pts, p_odd),
                                      ("g2", b2_pts, w))]
    check({tuple(e["shape"]) for e in scans} == set(seen),
          f"a K-scan shape of the Groth16 prove was not compared: {sorted(seen)}")
    entries["msm_scan"] = scans
    del p_odd

    # K-mm-norm's only shape in this prove is 1024^3 (12 stages, 12 of the 20
    # of a PLONK prove); K-mm is held and timed there too, both beside the
    # library yardstick
    check(dict(shapes["digit_mm_norm"]) == {BIG: 12},
          f"the Groth16 prove's K-mm-norm shapes are not 12 x 1024^3: "
          f"{shapes['digit_mm_norm']}")
    lib_ms, lib_norm_ms = int_mm_yardstick(dev, gen, ctx.fp)
    mm = mm_case(dev, gen, "digit_mm", BIG, 0, "held only", errs)
    check(mm["ms"] < lib_ms, f"K-mm ({mm['ms']:.3f} ms) is not faster than torch._int_mm "
                             f"({lib_ms:.3f} ms)")
    entries["digit_mm"] = dict(mm, library_ms=lib_ms)
    entries["digit_mm_norm"] = dict(mm_case(dev, gen, "digit_mm_norm", BIG, 12, "groth16", errs),
                                    library_ms=lib_ms + lib_norm_ms)
    return entries


def int_mm_yardstick(dev, gen, fp):
    """The library's way to K-mm's columns at 1024^3, torch._int_mm on the
    Toeplitz-expanded digit matrix, and to K-mm-norm's limbs, the same
    product and then the PyTorch `_normalize_cols`: each equal to the
    kernel's output; their times (ms)."""
    W8, D8 = mm_inputs(dev, gen, fp.name)
    nd, r, q = W8.shape
    m, nc = D8.shape[2], 2 * nd - 1
    toe = torch.zeros((nd, q, nc, m), dtype=torch.int8, device=dev)
    for i in range(nd):
        toe[i, :, i:i + nd] = D8.permute(1, 0, 2)
    Wcat = W8.permute(1, 0, 2).reshape(r, nd * q).contiguous()
    toe = toe.reshape(nd * q, nc * m)
    lib = torch._int_mm(Wcat, toe).reshape(r, nc, m).permute(1, 0, 2)
    check(max_abs_err(lib, ntt_mm.digit_mm(W8, D8)) == 0,
          "torch._int_mm yardstick differs from K-mm")
    check(max_abs_err(ntt_mm._normalize_cols(fp, lib), ntt_mm.digit_mm_norm(fp, W8, D8)) == 0,
          "torch._int_mm + _normalize_cols differs from K-mm-norm")
    lib_ms = cuda_ms(lambda: torch._int_mm(Wcat, toe), 3)
    norm_ms = cuda_ms(lambda: ntt_mm._normalize_cols(fp, lib), 3)
    log(f"  torch._int_mm at 1024^3 == K-mm: {lib_ms:.3f} ms; + _normalize_cols == K-mm-norm: "
        f"{norm_ms:.3f} ms")
    return lib_ms, norm_ms


# ------------------------------------------------------------- PLONK phases

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

    zbytes = plonk_setup._write_plonk_zkey(cv, r1cs, plonk_setup.process_constraints(fr, r1cs),
                                           commit, ptau_lem,
                                           hc.g2_mul(cv, cv.g2, 5), device=dev)
    zk = read_plonk_zkey(zbytes)
    check(zk.domain_size == domain and zk.ptau[2].shape[0] == M,
          "synthetic PLONK key has an unexpected domain or SRS length")
    if cv is hc.BN254:          # phase 16's ranks read bn128's key
        stash_bytes("plonk.zkey", zbytes)
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


def phase_plonk_prove(dev, tables, cv=hc.BN254):
    """The counted 2^18 PLONK prove on `cv` and its checks (bn128's witness
    and proof written for phase 16)."""
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
    with recorded_shapes() as shapes, field_shapes() as fseen:
        reset_counts()
        prove_ms, (proof, publics) = wall_ms(lambda: plonk.prove(zk, wit, b=b, device=dev))
        launches = counts()
    peak = torch.cuda.max_memory_allocated()
    # the same prove once more through the rounds function, which also hands
    # back the polynomials behind the proof
    proof2, publics2, out = plonk._prove_rounds(zk, wit, b, None, dev)
    check(json.dumps([proof2, publics2]) == json.dumps([proof, publics]),
          "the rounds function and `prove` give different PLONK proofs")
    log(f"  warm prove ({cv.name}): {prove_ms:.1f} ms; launches {launches}; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    log(f"  shapes: {shapes_json(shapes)}")
    check(launches["field_ops"] > 0 and launches["msm_scan"] == 9
          and launches["digit_mm_norm"] == 20 and launches["digit_mm"] == 0,
          "PLONK path: expected 9 K-scan, 20 K-mm-norm and no K-mm launches")
    check_plonk_proof(cv, zk, proof, publics, out, dev)
    if cv is hc.BN254:
        stash_bytes("plonk.wtns", write_wtns(fr, wit.values))
        stash_json("plonk.json", {"b": b, "proof": proof, "publics": publics,
                                  "warm_ms": prove_ms})
    return {"zk": zk, "wit": wit, "b": b, "ms": prove_ms, "launches": launches,
            "shapes": shapes, "fields": fseen, "pol_a": out["A"], "proof": [proof, publics],
            "peak_gib": peak / 2**30}




def phase_plonk_shapes(dev, gen, zk, pol_a, shapes, errs, cv=hc.BN254,
                       path="plonk"):
    """K-scan and K-mm-norm against their plain versions at every shape the
    counted PLONK prove called them with, each with its time and bound there
    (but the stages held earlier: on bn128 the 1024^3 stage has been held and
    timed with the Groth16 shapes, and its entry is completed there)."""
    ctx = ftorch.get_ctx(cv.fr.name)
    seen = shapes["msm_scan"]
    check(len(seen) == 1 and sum(seen.values()) == 9,
          f"the PLONK prove's nine MSMs do not share one K-scan shape: {dict(seen)}")
    M = zk.ptau[2].shape[0]
    scal = fops.pad_to(ftorch.from_mont(ctx, pol_a.contiguous()), M)
    scan = scan_case(cv, "g1", plonk._dev_key(zk, dev, M)["ptau"], scal, seen,
                     path, errs)
    norm = shapes["digit_mm_norm"]
    check(dict(norm) == STAGE_SHAPES,
          f"the PLONK prove's 20 NTT stage shapes are not the expected ones: {dict(norm)}")
    return scan, norm_cases(dev, gen, norm, path, errs, cv.fr.name)


SPLIT_LOGS = (11, 12, 16, 18, 19, 20, 21, 22, 23)   # 2^k NTTs of the driven paths
SPLIT_HOLD_LOGS = (21, 22, 23)     # sizes whose stage shapes are held against plain
MESH_AXIS = (1024, 4096)           # a rank's block of the 2^24 four-step NTT on four
                                   # ranks: 1024 columns, each a 4096-point axis


def split_stages(k):
    """The log radices of a 2^k NTT's stages under `ntt_mm._split`, in the
    order `_ntt_last` runs them."""
    k1 = ntt_mm._split(k)
    return [k] if k1 == k else split_stages(k - k1) + [k1]


def phase_ntt_split(dev, gen, errs):
    """The NTT's stage split (`ntt_mm._split`): each 2^k NTT of SPLIT_LOGS
    and a rank's axes of the mesh's 2^24 NTT timed (CUDA events), its inverse
    giving the input back limb for limb; K-mm-norm against its plain version
    at every stage shape at SPLIT_HOLD_LOGS (2^22 on both Fr fields) and on
    the mesh's axes, each of at least NORM_TILE_ROWS rows."""
    ctx = ftorch.get_ctx("bn254_fr")
    fp = ctx.fp
    rows, seen = [], collections.Counter()
    cases = [(f"2^{k}", rand_field(fp, 1 << k, dev, gen).reshape(fp.nl, 1, 1 << k), k)
             for k in SPLIT_LOGS]
    cases.append(("mesh 2^24 axes", rand_field(fp, MESH_AXIS[0] * MESH_AXIS[1], dev, gen)
                  .reshape(fp.nl, *MESH_AXIS), 24))
    for what, x, k in cases:
        call = lambda: ntt_mm._ntt_last(ctx, x, False)
        back = ntt_mm._ntt_last(ctx, call().transpose(1, 2).contiguous(), True)
        check(max_abs_err(back.transpose(1, 2), x) == 0,
              f"NTT {what}: the inverse NTT does not give the input back")
        ms = cuda_ms(call, 20 if k <= 16 else 5)
        if k in SPLIT_HOLD_LOGS or k == 24:
            with recorded_shapes() as shapes:
                call()
            seen.update(shapes["digit_mm_norm"])
        stages = split_stages(x.shape[-1].bit_length() - 1)
        rows.append({"ntt": what, "stages": stages, "ms": ms})
        log(f"  NTT {what}: {'+'.join(map(str, stages))} {ms:.3f} ms; inverse gives the input")
    del cases, back
    torch.cuda.empty_cache()
    check(all(sh[0] >= ntt_mm.NORM_TILE_ROWS for sh in seen),
          f"a stage of the split at 2^21-2^23 or the mesh's axes is narrow: {seen}")
    log(f"  stage shapes of the split at 2^21, 2^22, 2^23 and the mesh's axes: "
        f"{shapes_json({'digit_mm_norm': seen})}")
    norms = norm_cases(dev, gen, seen, "ntt split", errs)
    at22 = {sh: n for sh, n in seen.items() if sh[0] * sh[2] == 1 << 22}
    norms += norm_cases(dev, gen, at22, "ntt split", errs, "bls12_381_fr")
    return {"ntts": rows, "norms": norms}


class RoundClock:
    """A logger for a prover or a setup: it announces each round or step with
    `debug`; this synchronises the card there and keeps the host time.  A
    step is named by its message up to the first colon."""

    def __init__(self, first="before round 1"):
        self.first = first
        self.marks = [("start", time.perf_counter())]

    def debug(self, msg):
        torch.cuda.synchronize()
        self.marks.append((msg.split(":")[0], time.perf_counter()))

    def rounds_ms(self, end):
        names = [self.first] + [m[0] for m in self.marks[1:]]
        times = [m[1] for m in self.marks] + [end]
        return {nm: round((t1 - t0) * 1e3, 1)
                for nm, t0, t1 in zip(names, times, times[1:])}


# ------------------------------------------------------------- setup phase

SETUP_POWER = 19   # the .ptau: one power above the 2^18 circuits
CEREMONY_SEED = [0x5EED_0001, 0x5EED_0002, 0x5EED_0003, 0x5EED_0004,
                 0x5EED_0005, 0x5EED_0006, 0x5EED_0007, 0x5EED_0008]


@functools.lru_cache(maxsize=None)
def setup_secrets():
    """The .ptau's secrets: the private keys that one contribution to a blank
    power-19 bn128 accumulator draws from ChaCha(CEREMONY_SEED)
    (keypair.create_ptau_key on the accumulator's first challenge), so phase
    13's `contribute` must give phase 10's sections 2-6."""
    cv = hc.BN254
    key = keypair.create_ptau_key(cv, ptau_fmt.first_challenge_hash(cv, SETUP_POWER),
                                  ChaCha(CEREMONY_SEED))
    return {k: key[k]["prvKey"] for k in ("tau", "alpha", "beta")}


def zkey_sections(data):
    bf = BinFile(data, "zkey")
    return {sid: bf.read_section(sid) for sid in sorted(bf.sections)}


def phase_setup(dev, gen, errs):
    """Groth16 and PLONK setup from a prepared .ptau on the card: the
    power-19 .ptau built from setup_secrets() (through `tobytes`/`read_ptau`),
    K-field held at the build's batch size and at a ragged one, the Groth16
    key of the 200,000-constraint chain with circom's coefficients from it
    against the one from `setup_from_secrets` (sections 1-9 equal; the chain
    with every coefficient 1 timed beside it), a proof with each key
    passing the pairing check and a tampered public rejected.  Launch counts
    set to 0 just before each setup and read just after.  The .ptau is handed
    back (key "ptau") for the FFLONK, ceremony and phase-2 phases, the
    Groth16 key (key "zkey") and the chain with its witness (key "chain")
    for phase 2."""
    cv = hc.BN254
    fr = cv.fr
    sec = setup_secrets()
    t_phase = time.perf_counter()
    steps, launches = {}, {}

    # K-field at the build's batch of 2^21 and at a size that is no multiple
    # of its 256-thread block (the segmented sums' rounds give it such sizes)
    field_cases(dev, gen, errs, (1 << 21, (1 << 18) + 37), "the setup's batches")

    t = time.perf_counter()
    scalars = ptau_scalars(cv, SETUP_POWER, sec["tau"], sec["alpha"], sec["beta"])
    steps["ptau_scalars_host"] = (time.perf_counter() - t) * 1e3
    reset_counts()
    steps["ptau_build"], pt = wall_ms(lambda: build_ptau(cv, SETUP_POWER, scalars, dev))
    launches["ptau_build"] = counts()
    check(launches["ptau_build"]["field_ops"] > 0, "the .ptau build launched no K-field")
    # where the build's time goes: section 2's 2^20 - 1 G1 points alone
    # (the build runs batches of 2^21), once more and once under the profiler
    g1_batch = lambda: groth16_setup._points_from_scalars(cv, scalars[2][0], False, dev)
    steps["ptau_g1_section2"], _ = wall_ms(g1_batch)
    log(f"  section 2's G1 points alone ({len(scalars[2][0])}): "
        f"{steps['ptau_g1_section2']:.0f} ms")
    batch_busy = profile_busy(g1_batch, steps["ptau_g1_section2"])
    del scalars
    t = time.perf_counter()
    data = pt.tobytes()
    back = ptau_fmt.read_ptau(data)
    check(back.power == SETUP_POWER and back.curve.name == cv.name
          and back.contributions == []
          and all(bytes(back.sections[s]) == bytes(pt.sections[s]) for s in pt.sections)
          and sorted(back.sections) == sorted(pt.sections) and back.tobytes() == data,
          "the .ptau does not round-trip through tobytes / read_ptau")
    steps["ptau_roundtrip"] = (time.perf_counter() - t) * 1e3
    log(f"  power-{SETUP_POWER} .ptau: scalars on the host {steps['ptau_scalars_host']:.0f} ms, "
        f"points on the card {steps['ptau_build']:.0f} ms "
        f"({len(data) / 1e6:.0f} MB; launches {launches['ptau_build']}); "
        f"round trip through tobytes / read_ptau in {steps['ptau_roundtrip']:.0f} ms")
    del pt

    # the chain with every coefficient 1: each segmented MSM runs one step
    ones, _ = plonk_circuit(fr)
    reset_counts()
    steps["groth16_setup_from_ptau_ones"], _ = wall_ms(
        lambda: groth16_setup.setup_from_ptau(ones, back, device=dev))
    launches["groth16_setup_ones"] = counts()
    log(f"  Groth16 setup_from_ptau, coefficients all 1: "
        f"{steps['groth16_setup_from_ptau_ones']:.0f} ms; "
        f"launches {launches['groth16_setup_ones']}")
    del ones

    r1cs, wit = circom_chain(fr)
    reset_counts()
    steps["groth16_setup_from_ptau"], zbytes = wall_ms(
        lambda: groth16_setup.setup_from_ptau(r1cs, back, device=dev))
    launches["groth16_setup"] = counts()
    zk = read_groth16_zkey(zbytes)
    check(zk.power == SETUP_POWER - 1, "the Groth16 domain is not one power below the .ptau")
    log(f"  Groth16 setup_from_ptau, circom's coefficients: "
        f"{steps['groth16_setup_from_ptau']:.0f} ms; "
        f"launches {launches['groth16_setup']}")
    check(launches["groth16_setup"]["field_ops"] > 0,
          "the Groth16 setup launched no K-field")
    busy = profile_busy(lambda: groth16_setup.setup_from_ptau(r1cs, back, device=dev),
                        steps["groth16_setup_from_ptau"])
    steps["groth16_setup_from_secrets"], zsec = wall_ms(
        lambda: groth16_setup.write_groth16_zkey(groth16_setup.setup_from_secrets(
            r1cs, sec["tau"], sec["alpha"], sec["beta"], device=dev)))
    a, b = zkey_sections(zbytes), zkey_sections(zsec)
    check(sorted(a) == sorted(b) == list(range(1, 11)), "zkey section lists differ")
    for sid in range(1, 10):
        check(a[sid] == b[sid], f"Groth16 zkey section {sid}: setup_from_ptau differs "
                                "from setup_from_secrets")
    check(b[10] == bytes(68) and a[10][64:] == bytes(4) and a[10][:64] != bytes(64),
          "section 10: expected the csHash from the .ptau and zeros from the secrets")
    log(f"  setup_from_secrets + write_groth16_zkey: {steps['groth16_setup_from_secrets']:.0f} ms; "
        f"sections 1-9 equal to setup_from_ptau's; csHash {a[10][:8].hex()}...")
    del zsec, a, b

    vk = groth16.export_verification_key(zk)
    steps["groth16_prove"], (proof, publics) = wall_ms(
        lambda: groth16.prove(zk, wit, r=0x5151, s=0x7373, device=dev))
    t = time.perf_counter()
    check(groth16.verify(vk, publics, proof), "the Groth16 proof with the new key fails")
    bad = [str(int(publics[0]) + 1)] + publics[1:]
    check(not groth16.verify(vk, bad, proof), "tampered public accepted (Groth16 setup)")
    steps["groth16_verify"] = (time.perf_counter() - t) * 1e3
    log(f"  Groth16 prove with it {steps['groth16_prove']:.0f} ms (first, uploads the key); "
        "pairing check passes, tampered public rejected")
    del zk
    torch.cuda.empty_cache()

    with recorded_shapes() as shapes:
        reset_counts()
        steps["plonk_setup_from_ptau"], pbytes = wall_ms(
            lambda: plonk_setup.setup_from_ptau(r1cs, back, device=dev))
        launches["plonk_setup"] = counts()
    log(f"  PLONK setup_from_ptau: {steps['plonk_setup_from_ptau']:.0f} ms; "
        f"launches {launches['plonk_setup']}")
    check(launches["plonk_setup"]["field_ops"] > 0 and launches["plonk_setup"]["msm_scan"] == 8
          and launches["plonk_setup"]["digit_mm_norm"] > 0,
          "the PLONK setup did not launch K-field, eight K-scans and K-mm-norm")
    pzk = read_plonk_zkey(pbytes)
    check(pzk.power == SETUP_POWER - 1, "the PLONK domain is not one power below the .ptau")
    b_ = list(range(201, 213))
    steps["plonk_prove"], (proof, publics) = wall_ms(
        lambda: plonk.prove(pzk, wit, b=b_, device=dev))
    t = time.perf_counter()
    pvk = plonk.export_verification_key(pzk)
    check(plonk.verify(pvk, publics, proof), "the PLONK proof with the new key fails")
    bad = [str(int(publics[0]) + 1)] + publics[1:]
    check(not plonk.verify(pvk, bad, proof), "tampered public accepted (PLONK setup)")
    steps["plonk_verify"] = (time.perf_counter() - t) * 1e3
    log(f"  PLONK prove with it {steps['plonk_prove']:.0f} ms (first, uploads the key); "
        "pairing check passes, tampered public rejected")
    del pzk, pbytes
    torch.cuda.empty_cache()

    # K-scan at the commitments' shape (2^18 Lagrange bases, not the proves'
    # 2^18 + 6 SRS points); K-mm-norm's stage shapes are the PLONK prove's
    log(f"  PLONK setup shapes: {shapes_json(shapes)}")
    domain = 1 << (SETUP_POWER - 1)
    s_g1 = 2 * cv.fq.n8
    lx, ly, linf = pcodec.g1_lem_from_bytes(
        cv.fq, back.sections[12][(domain - 1) * s_g1:(2 * domain - 1) * s_g1], domain)
    bases = (ftorch.to_tensor(lx, dev), ftorch.to_tensor(ly, dev),
             torch.from_numpy(linf).to(dev))
    scan = scan_case(cv, "g1", bases, rand_field(fr, domain, dev, gen), shapes["msm_scan"],
                     "plonk setup", errs)
    check(set(shapes["digit_mm_norm"]) <= set(STAGE_SHAPES) and not shapes["digit_mm"],
          f"the PLONK setup gave the NTT kernels new shapes: {shapes_json(shapes)}")
    del bases
    total = time.perf_counter() - t_phase
    log(f"  setup phase steps ms: {json.dumps({k: round(v, 1) for k, v in steps.items()})}")
    log(f"  setup phase total {total:.1f} s")
    return {"steps_ms": steps, "launches": launches, "busy_ms": busy,
            "ptau_g1_section2_busy_ms": batch_busy, "total_s": total, "scan": scan,
            "ptau": back, "zkey": zbytes, "chain": (r1cs, wit)}


# ------------------------------------------------------------- FFLONK phase

FFLONK_TAU = 0x5A17_C0DE_93B1_4E27_D6F8_0A35   # the 2^18 FFLONK key's secret
FFLONK_PTAU_CONSTRAINTS = 60_000               # domain 2^16: 589,842 SRS points
FFLONK_PROVES = 3                              # warm proves for the median


def srs_spot_check(cv, zk, tau, idxs):
    """The key's SRS points at `idxs` against [tau^i]G1 by host scalar
    multiplication."""
    fq, p = cv.fq, cv.fr.p
    px, py, pinf = zk.ptau
    for i in idxs:
        x, y = (fq.from_mont(ftorch.np_to_ints(fq, a[:, i:i + 1])[0]) for a in (px, py))
        check(not pinf[i] and (x, y) == hc.g1_mul(cv, cv.g1, pow(tau, i, p)),
              f"FFLONK SRS point {i} differs from [tau^{i}]G1")


def phase_fflonk(dev, gen, errs, ptau):
    """FFLONK on bn128 at domain 2^18: the key from a secret tau on the card,
    `setup_from_ptau` at 2^16 from phase 10's .ptau against
    `setup_from_secrets` with its tau, a counted prove that passes the
    pairing check, warm times, rounds and the busy share; then K-scan and
    K-mm-norm at every shape of the phase."""
    cv = hc.BN254
    fr = cv.fr
    p = fr.p
    t_phase = time.perf_counter()
    steps, launches, shapes = {}, {}, {}
    r1cs, wit = plonk_circuit(fr)
    n = fflonk_setup._domain(r1cs.n_constraints + 1)    # + the public-input row
    n16 = fflonk_setup._domain(FFLONK_PTAU_CONSTRAINTS + 1)
    n_srs = 9 * n + 18

    # the setup's host work on the SRS scalars, alone: tau powers by running
    # products (as setup_from_secrets takes them), then their 16-bit limbs
    t = time.perf_counter()
    taus, x = [], 1
    for _ in range(n_srs):
        taus.append(x)
        x = x * FFLONK_TAU % p
    steps["tau_powers_host"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    ftorch.np_from_ints(fr, taus)
    steps["tau_limbs_host"] = (time.perf_counter() - t) * 1e3
    log(f"  {n_srs} tau powers on the host {steps['tau_powers_host']:.0f} ms, their "
        f"limbs {steps['tau_limbs_host']:.0f} ms")

    clock = RoundClock("start")
    with recorded_shapes() as shapes["setup 2^18"]:
        reset_counts()
        steps["setup_from_secrets"], zbytes = wall_ms(
            lambda: fflonk_setup.setup_from_secrets(r1cs, FFLONK_TAU, logger=clock,
                                                    device=dev))
        launches["setup"] = counts()
    setup_steps = clock.rounds_ms(time.perf_counter())
    log(f"  setup_from_secrets 2^18: {steps['setup_from_secrets']:.0f} ms "
        f"({len(zbytes) / 1e6:.0f} MB); steps ms {json.dumps(setup_steps)}; "
        f"launches {launches['setup']}")
    check(launches["setup"]["field_ops"] > 0 and launches["setup"]["msm_scan"] == 1
          and launches["setup"]["digit_mm_norm"] > 0,
          "the FFLONK setup did not launch K-field, one K-scan (C0) and K-mm-norm")
    # where the SRS step's time goes: its batched double-and-add once more,
    # under the profiler, against the step's unprofiled time
    log("  the SRS points once more under the profiler:")
    srs_busy = profile_busy(
        lambda: groth16_setup._points_from_scalars(cv, taus, False, dev),
        setup_steps["SRS points"])
    del taus
    stash_bytes("fflonk.zkey", zbytes)
    t = time.perf_counter()
    zk = read_fflonk_zkey(zbytes)
    steps["read_fflonk_zkey"] = (time.perf_counter() - t) * 1e3
    check(zk.domain_size == n and zk.ptau[2].shape[0] == n_srs,
          f"FFLONK key: power {zk.power}, SRS {zk.ptau[2].shape[0]} points")
    srs_spot_check(cv, zk, FFLONK_TAU, (0, 1, 2, n, n_srs - 1))
    log(f"  read_fflonk_zkey {steps['read_fflonk_zkey']:.0f} ms; SRS points 0, 1, 2, "
        f"{n} and {n_srs - 1} == [tau^i]G1 on host bigints")
    del zbytes

    # setup_from_ptau at 2^16 from phase 10's .ptau, against setup_from_secrets
    # with that .ptau's tau (its section 2 is [tau^i]G1, section 3 [tau^i]G2)
    r16, _ = plonk_circuit(fr, FFLONK_PTAU_CONSTRAINTS)
    with recorded_shapes() as shapes["setup 2^16"]:
        reset_counts()
        steps["setup_from_ptau_2^16"], zp = wall_ms(
            lambda: fflonk_setup.setup_from_ptau(r16, ptau, device=dev))
        launches["setup_from_ptau_2^16"] = counts()
        steps["setup_from_secrets_2^16"], zs = wall_ms(
            lambda: fflonk_setup.setup_from_secrets(r16, setup_secrets()["tau"], device=dev))
    check(read_fflonk_zkey(zp).domain_size == n16, "the FFLONK .ptau key has another domain")
    check(zp == zs, "FFLONK setup_from_ptau differs from setup_from_secrets")
    log(f"  setup_from_ptau 2^16 from phase 10's power-19 .ptau (held from that phase): "
        f"{steps['setup_from_ptau_2^16']:.0f} ms, launches {launches['setup_from_ptau_2^16']}; "
        f"== setup_from_secrets with its tau ({steps['setup_from_secrets_2^16']:.0f} ms), "
        f"{len(zp)} bytes")
    del zp, zs, r16

    b = list(range(301, 311))
    steps["first_prove"], _ = wall_ms(lambda: fflonk.prove(zk, wit, b=b, device=dev))
    torch.cuda.reset_peak_memory_stats()
    with recorded_shapes() as shapes["prove"]:
        reset_counts()
        prove_ms, (proof, publics) = wall_ms(lambda: fflonk.prove(zk, wit, b=b, device=dev))
        launches["prove"] = counts()
    peak = torch.cuda.max_memory_allocated()
    pl = launches["prove"]
    stash_bytes("fflonk.wtns", write_wtns(fr, wit.values))
    stash_json("fflonk.json", {"b": b, "proof": proof, "publics": publics, "warm_ms": prove_ms})
    log(f"  first prove (uploads the key) {steps['first_prove']:.0f} ms; counted warm prove "
        f"{prove_ms:.1f} ms, peak device memory {peak / 2**30:.2f} GiB; launches {pl}")
    log(f"  prove shapes: {shapes_json(shapes['prove'])}")
    check(pl["field_ops"] > 0 and pl["msm_scan"] == 4 and pl["digit_mm_norm"] > 0
          and pl["digit_mm"] == 0,
          "FFLONK path: expected K-field, 4 K-scan, K-mm-norm and no K-mm launches")
    vk = fflonk.export_verification_key(zk)
    t = time.perf_counter()
    check(fflonk.verify(vk, publics, proof), "the FFLONK 2^18 proof fails the pairing check")
    steps["verify"] = (time.perf_counter() - t) * 1e3
    bad = [str(int(publics[0]) + 1)] + publics[1:]
    check(not fflonk.verify(vk, bad, proof), "tampered public accepted (FFLONK)")
    bad_proof = json.loads(json.dumps(proof))
    bad_proof["evaluations"]["a"] = str(int(bad_proof["evaluations"]["a"]) + 1)
    check(not fflonk.verify(vk, publics, bad_proof), "tampered evaluation accepted (FFLONK)")
    log(f"  the prove's own checks held (grand product 1, W2 remainder 0); pairing check "
        f"passes in {steps['verify']:.0f} ms; tampered public and evaluation rejected")

    ms = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FFLONK_PROVES):
        t, got = wall_ms(lambda: fflonk.prove(zk, wit, b=b, device=dev))
        ms.append(t)
        check(json.dumps(got) == json.dumps([proof, publics]), "warm FFLONK proofs differ")
    warm = {"median_ms": float(np.median(ms)), "min_ms": min(ms), "max_ms": max(ms),
            "all_ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  {FFLONK_PROVES} warm proves: median {warm['median_ms']:.1f} ms, spread "
        f"{warm['min_ms']:.1f} .. {warm['max_ms']:.1f} ms, peak {warm['peak_gib']:.2f} GiB")
    clock = RoundClock()
    fflonk.prove(zk, wit, b=b, device=dev, logger=clock)
    torch.cuda.synchronize()
    rounds = clock.rounds_ms(time.perf_counter())
    log("  rounds ms: " + json.dumps(rounds))
    busy = profile_busy(lambda: fflonk.prove(zk, wit, b=b, device=dev), warm["median_ms"])

    # the kernels at every shape the phase gave them.  K-scan's input shape
    # follows the point count alone: each C0 commitment (one K-scan shape a
    # setup) takes the first 8n SRS points, the prove's commitments all of it
    srs = fflonk._dev_key(zk, dev)["ptau"]
    scans = []
    for path, m in (("setup 2^18", 8 * n), ("setup 2^16", 8 * n16), ("prove", n_srs)):
        seen = shapes[path]["msm_scan"]
        check(len(seen) == 1, f"FFLONK {path}: K-scan shapes {dict(seen)}")
        scans.append(scan_case(cv, "g1", tuple(a[..., :m] for a in srs),
                               rand_field(fr, m, dev, gen), seen, "fflonk " + path, errs))
    norm_shapes = collections.Counter()
    for seen in shapes.values():
        norm_shapes.update(seen["digit_mm_norm"])
        check(not seen["digit_mm"], "the FFLONK phase launched K-mm")
    norms = [mm_case(dev, gen, "digit_mm_norm", sh, k, "fflonk", errs)
             for sh, k in sorted(norm_shapes.items())]
    del srs
    total = time.perf_counter() - t_phase
    log(f"  FFLONK phase steps ms: {json.dumps({k: round(v, 1) for k, v in steps.items()})}")
    log(f"  FFLONK phase total {total:.1f} s")
    return {"steps_ms": steps, "setup_steps_ms": setup_steps, "srs_busy_ms": srs_busy,
            "prove_ms": prove_ms, "peak_gib": peak / 2**30, "warm": warm,
            "rounds_ms": rounds, "busy_ms": busy,
            "launches": launches, "total_s": total, "scans": scans, "norms": norms}


# ------------------------------------------------------------ ceremony phase

RESPONSE_SEED = [0xC0FF_EE01, 0xC0FF_EE02, 0xC0FF_EE03, 0xC0FF_EE04, 5, 6, 7, 8]
BEACON_HASH = bytes.fromhex("5a" * 32)
VERIFY_SEED = 1913
CEREMONY_SMALL_POWER = 10   # convert and export_json: the JSON stays small
CEREMONY_CHAIN_POWER = 14   # phase 13's prepare_phase2, verify and challenge / response
                            # chain run on a contribution of this power (the script's
                            # time limit)
PREPARE_POWER = 8           # prepare_phase2 over the mesh in phase 16: the least power
                            # whose G1 and G2 blocks both reach the sharded group iNTT
                            # ((4 * MESH_RANKS)^2 = 2^8 points)
STAGE_PROFILED = 10         # the group iNTT stage timed alone and profiled


def ceremony_predicted(power):
    """K-field launches that the batched double-and-adds of `contribute` and
    `prepare_phase2` make at `power`, counted from the code: 71 a G1 step
    and 277 a G2 step (jac_dbl + jac_add + select over gops), 254 steps a
    batch.  contribute: one G1 batch (sections 2, 4, 5) and one G2 batch
    (3, 6).  prepare_phase2: stages 1 .. K-1 of each group's largest block
    2^K (K = power + 1 on G1, power on G2), one batch each."""
    g1, g2 = 254 * 71, 254 * 277
    return {"contribute": g1 + g2, "prepare_phase2": power * g1 + (power - 1) * g2}


def field_cases(dev, gen, errs, sizes, what, field="bn254_fq"):
    """K-field add / sub / mont_mul / neg on `field` against the plain
    versions at the given element counts (shapes a path gave the kernel) but
    those held earlier in the run."""
    ctx = ftorch.get_ctx(field)
    done = HELD[("field_ops", field)]
    again = [n for n in sizes if n in done]
    sizes = [n for n in sizes if n not in done]
    for n in sizes:
        done.add(n)
        a, b = rand_field(ctx.fp, n, dev, gen), rand_field(ctx.fp, n, dev, gen).flip(1).contiguous()
        for op, fn in (("add", ftorch.add), ("sub", ftorch.sub), ("mont_mul", ftorch.mont_mul),
                       ("neg", lambda ctx, a, b: ftorch.neg(ctx, a))):
            got = fn(ctx, a, b)
            with ftorch.plain_versions():
                want = fn(ctx, a, b)
            e = max_abs_err(got, want)
            check(e == 0, f"K-field {op} {field} at {n} differs from plain ({e})")
            errs["field_ops"] = max(errs["field_ops"], e)
    log(f"  K-field {field}: add sub mont_mul neg == plain at {list(sizes)} ({what}); "
        f"{len(again)} sizes held earlier in the run")


def held_before(kernel, seen, path, field="bn254_fr"):
    """The shapes of `seen` that no earlier phase held against the plain
    version (logged: those that one did)."""
    done = HELD[(kernel, field)]
    again = sorted(set(seen) & done)
    if again:
        log(f"  {kernel} {field} {again} ({path}): held against plain earlier in this run")
    return sorted(set(seen) - done)


def norm_cases(dev, gen, seen, path, errs, field="bn254_fr"):
    """K-mm-norm on `field` against its plain version at every shape of
    `seen` ({shape: launches}) not held earlier in the run."""
    return [mm_case(dev, gen, "digit_mm_norm", sh, seen[sh], path, errs, field)
            for sh in held_before("digit_mm_norm", seen, path, field)]


def ceremony_scans(cv, seen, pts, gen, errs, path="ceremony verify"):
    """K-scan against its plain version at every shape a path gave it but
    those held earlier in the run: the input is rebuilt from the .ptau's
    points (tiled) and random scalars at the point count C * RL, which gives
    the recorded shape."""
    out = []
    dev = pts["g1"][0].device
    for shape in held_before("msm_scan", seen, path, cv.fq.name):
        nw, C, nin, RL = shape
        group = "g1" if nin == cv.fq.nl + 1 else "g2"
        cw = 16 if nw <= cv.fq.nl else 8
        n = C * RL
        x, y = pts[group]
        tile = lambda a: tuple(tile(c) for c in a) if isinstance(a, tuple) else \
            a.repeat(1, -(-n // a.shape[1]))[:, :n].contiguous()
        scal = rand_field(cv.fr, n, dev, gen)
        if cw == 8:
            scal = torch.stack([scal & 0xFF, (scal >> 8) & 0xFF], dim=1).reshape(-1, n)
        out.append(scan_case(cv, group, (tile(x), tile(y), torch.zeros(n, dtype=torch.bool,
                                                                      device=dev)),
                             scal, seen, path, errs, cw=cw, lanes=RL))
    return out


def stage_busy(cv, pt, g2, dev):
    """One stage (STAGE_PROFILED) of preparePhase2's batched group iNTT on
    every block of one group, alone: wall time, K-field launches and, under
    the profiler, the device's busy share."""
    sids = (3,) if g2 else (2, 4, 5)
    blocks = [b for old in sids for b in ptau_ops._section_blocks(cv, pt, old, g2) if b[1]]
    return blocks_stage_busy(cv, g2, blocks, dev, "preparePhase2")


def blocks_stage_busy(cv, g2, blocks, dev, what):
    """Stage STAGE_PROFILED of the batched group iNTT of `blocks` ([(lem,
    k)]), alone: wall time, K-field launches and the device's busy share."""
    P, offs = ptau_ops._intt_lanes(cv, g2, blocks, dev)
    stage = lambda: ptau_ops._intt_stage(cv, g2, P, offs, STAGE_PROFILED, [], dev)
    reset_counts()
    ms, lanes = wall_ms(stage)
    c = counts()
    busy = profile_busy(stage, ms)
    del P
    torch.cuda.empty_cache()
    group = "G2" if g2 else "G1"
    log(f"  {what} {group} stage {STAGE_PROFILED} alone: {ms:.0f} ms, {lanes} lanes "
        f"multiplied, {c['field_ops']} K-field launches"
        + ("" if busy is None else f", device busy {busy:.0f} ms ({100 * busy / ms:.1f} %)"))
    return {"ms": ms, "lanes": lanes, "field_ops": c["field_ops"], "busy_ms": busy}


def phase_ceremony(dev, gen, errs, ptau):
    """The powers-of-tau ceremony on bn128 at power 19 (SETUP_POWER): one
    `contribute` to a blank accumulator with ChaCha(CEREMONY_SEED) gives
    phase 10's sections 2-6.  One at CEREMONY_CHAIN_POWER with the same seed
    gives their prefixes; `prepare_phase2` of that file the sections 12-15
    that `prepared_equal` holds against phase 10's; `verify` accepts it and
    rejects a copy with two tauG1 points swapped; export_challenge ->
    challenge_contribute -> import_response -> beacon -> verify; a response
    with a flipped point byte is refused; convert and export_json at
    CEREMONY_SMALL_POWER.  Launch counts set to 0 just before
    contribute, prepare_phase2 and verify and read just after; one G1 and one
    G2 stage of the group iNTT timed and profiled alone; K-field, K-scan and
    K-mm-norm against their plain versions at the shapes the phase gave
    them (but those held earlier in the run)."""
    cv = hc.BN254
    power = SETUP_POWER
    sz1 = 2 * cv.fq.n8
    t_phase = time.perf_counter()
    steps, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    pred = ceremony_predicted(power)

    t = time.perf_counter()
    acc = ptau_ops.new_accumulator(cv, power)
    steps["new_accumulator"] = (time.perf_counter() - t) * 1e3
    reset_counts()
    steps["contribute"], (c1, rh1) = wall_ms(lambda: ptau_ops.contribute(
        acc, name="chip_smoke", rng=ChaCha(CEREMONY_SEED), device=dev))
    launches["contribute"] = counts()
    del acc
    key = {k: c1.contributions[-1].key[k]["prvKey"] for k in ("tau", "alpha", "beta")}
    check(key == setup_secrets(), "the contribution's keys are not phase 10's secrets")
    for sid in (2, 3, 4, 5, 6):
        check(bytes(c1.sections[sid]) == bytes(ptau.sections[sid]),
              f"contribute: section {sid} differs from phase 10's .ptau")
    log(f"  contribute at power {power}: {steps['contribute']:.0f} ms, sections 2-6 == phase "
        f"10's .ptau; K-field launches {launches['contribute']['field_ops']} (predicted "
        f"{pred['contribute']} in the two double-and-adds, plus the powers, the affine "
        f"forms and the codecs); response hash {rh1[:8].hex()}...")

    # the rest runs on a contribution of CEREMONY_CHAIN_POWER with the same
    # seed: the same secrets, so its sections 2-6 are phase 10's prefixes (a
    # truncation of c1 would not do: its contribution hashes belong to power
    # 19, and export_challenge refuses it)
    acc = ptau_ops.new_accumulator(cv, CEREMONY_CHAIN_POWER)
    steps["contribute_chain_power"], (cs, _) = wall_ms(lambda: ptau_ops.contribute(
        acc, name="chip_smoke", rng=ChaCha(CEREMONY_SEED), device=dev))
    del acc
    for sid in (2, 3, 4, 5, 6):
        check(bytes(cs.sections[sid]) == bytes(ptau.sections[sid][:len(cs.sections[sid])]),
              f"contribute at power {CEREMONY_CHAIN_POWER}: section {sid} is no prefix of "
              "phase 10's")
    pred_prep = ceremony_predicted(CEREMONY_CHAIN_POWER)
    reset_counts()
    steps["prepare_phase2"], prep = wall_ms(lambda: ptau_ops.prepare_phase2(cs, device=dev))
    launches["prepare_phase2"] = counts()
    eq = prepared_equal(cv, prep, ptau, dev)
    check(all(eq.values()), f"prepare_phase2 at power {CEREMONY_CHAIN_POWER}: sections "
                            f"12-15 differ from phase 10's .ptau: {eq}")
    log(f"  contribute at power {CEREMONY_CHAIN_POWER}: {steps['contribute_chain_power']:.0f} "
        f"ms, sections 2-6 == phase 10's prefixes; its prepare_phase2: "
        f"{steps['prepare_phase2']:.0f} ms, sections 13-15 and 12's blocks up to "
        f"2^{CEREMONY_CHAIN_POWER} == phase 10's prefixes, 12's last block == phase 10's "
        f"by the zero-point identity; K-field launches "
        f"{launches['prepare_phase2']['field_ops']} (predicted {pred_prep['prepare_phase2']} in "
        f"the stages' double-and-adds, plus the butterflies and the affine forms)")

    with recorded_shapes() as v_shapes:
        reset_counts()
        steps["verify"], ok = wall_ms(lambda: ptau_ops.verify(
            prep, rng=np.random.default_rng(VERIFY_SEED), device=dev))
        launches["verify"] = counts()
    check(ok, "verify rejects the prepared .ptau")
    bad = ptau_fmt.read_ptau(prep.tobytes())
    s2 = bytearray(bad.sections[2])
    s2[sz1:2 * sz1], s2[2 * sz1:3 * sz1] = s2[2 * sz1:3 * sz1], s2[sz1:2 * sz1]
    bad.sections[2] = bytes(s2)
    steps["verify_tampered"], ok = wall_ms(lambda: ptau_ops.verify(
        bad, rng=np.random.default_rng(VERIFY_SEED), device=dev))
    check(not ok, "verify accepts a .ptau with two tauG1 points swapped")
    del bad, s2
    log(f"  verify (with the Lagrange check): {steps['verify']:.0f} ms, True; launches "
        f"{launches['verify']}; two tauG1 points swapped: False in "
        f"{steps['verify_tampered']:.0f} ms")

    steps["export_challenge"], ch = wall_ms(lambda: ptau_ops.export_challenge(cs, device=dev))
    steps["challenge_contribute"], resp = wall_ms(lambda: ptau_ops.challenge_contribute(
        cv, ch, rng=ChaCha(RESPONSE_SEED), device=dev))
    steps["import_response"], c2 = wall_ms(lambda: ptau_ops.import_response(
        cs, resp, name="response", device=dev))
    steps["beacon"], (c3, _) = wall_ms(lambda: ptau_ops.beacon(c2, BEACON_HASH, 10, device=dev))
    steps["verify_chain"], ok = wall_ms(lambda: ptau_ops.verify(
        c3, rng=np.random.default_rng(VERIFY_SEED), device=dev))
    check(ok and len(c3.contributions) == 3, "verify rejects contribute -> response -> beacon")
    flipped = bytearray(resp)
    flipped[64 + 2 * cv.fq.n8 + 5] ^= 1
    t = time.perf_counter()
    try:
        c2b = ptau_ops.import_response(cs, bytes(flipped), name="flipped", device=dev)
        refused = "verify False"
        check(not ptau_ops.verify(c2b, rng=np.random.default_rng(VERIFY_SEED), device=dev),
              "a response with a flipped point byte verifies")
    except ValueError as e:
        refused = f"import raised: {e}"
    steps["flipped_response"] = (time.perf_counter() - t) * 1e3
    log(f"  export_challenge {steps['export_challenge']:.0f} ms ({len(ch)} bytes), "
        f"challenge_contribute {steps['challenge_contribute']:.0f} ms, import_response "
        f"{steps['import_response']:.0f} ms, beacon {steps['beacon']:.0f} ms, verify "
        f"{steps['verify_chain']:.0f} ms: True; flipped response byte: {refused}")
    del ch, resp, cs, c2, c3, flipped

    # the truncated file's top tauG1 block holds one more tau point than a
    # preparePhase2 of its power takes, so convert's section 12 is what
    # prepare_phase2 of the truncated file gives, which `prepared_equal`
    # holds against phase 10's sections (that preparePhase2 is not run again,
    # for time)
    small = ptau_ops.truncate(prep, CEREMONY_SMALL_POWER)
    steps["convert_small"], conv = wall_ms(lambda: ptau_ops.convert(small, device=dev))
    eq = prepared_equal(cv, conv, ptau, dev)
    check(all(eq.values()), f"convert at power {CEREMONY_SMALL_POWER}: sections 12-15 differ "
                            f"from phase 10's .ptau: {eq}")
    t = time.perf_counter()
    js = ptau_ops.export_json(conv)
    steps["export_json_small"] = (time.perf_counter() - t) * 1e3
    n12 = 1 << CEREMONY_SMALL_POWER
    check(len(js["tauG1"]) == 2 * n12 - 1 and len(js["lTauG1"]) == CEREMONY_SMALL_POWER + 2
          and js["tauG1"][1] == [str(v) for v in c1.contributions[0].tau_g1] + ["1"],
          "export_json does not hold the file's points")
    log(f"  power {CEREMONY_SMALL_POWER}: convert {steps['convert_small']:.0f} ms (sections 12-15 "
        f"== phase 10's by `prepared_equal`), export_json {steps['export_json_small']:.0f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del small, conv, js
    torch.cuda.empty_cache()

    stages = {"g1": stage_busy(cv, c1, False, dev), "g2": stage_busy(cv, c1, True, dev)}

    # the kernels at the shapes the phase gave them
    field_cases(dev, gen, errs, ((1 << 21) - 1, (1 << 19) + 1), "the ceremony's batches")
    fq = cv.fq
    n1, n2 = min(1 << 16, (2 << prep.power) - 1), min(1 << 15, 1 << prep.power)
    x1, y1, _ = pcodec.g1_lem_from_bytes(fq, bytes(prep.sections[2][:n1 * sz1]), n1)
    x2, y2, _ = pcodec.g2_lem_from_bytes(fq, bytes(prep.sections[3][:n2 * 2 * sz1]), n2)
    put = lambda a: tuple(put(c) for c in a) if isinstance(a, tuple) else ftorch.to_tensor(a, dev)
    t = time.perf_counter()
    scans = ceremony_scans(cv, v_shapes["msm_scan"],
                           {"g1": (put(x1), put(y1)), "g2": (put(x2), put(y2))},
                           gen, errs)
    steps["kscan_vs_plain"] = (time.perf_counter() - t) * 1e3
    check(not v_shapes["digit_mm"], "verify launched K-mm")
    norms = norm_cases(dev, gen, v_shapes["digit_mm_norm"], "ceremony verify", errs)
    total = time.perf_counter() - t_phase
    log(f"  ceremony phase steps ms: {json.dumps({k: round(v, 1) for k, v in steps.items()})}")
    log(f"  ceremony peak device memory {peak:.2f} GiB; phase total {total:.1f} s")
    pred["prepare_phase2"] = pred_prep["prepare_phase2"]
    return {"power": power, "chain_power": CEREMONY_CHAIN_POWER, "steps_ms": steps,
            "launches": launches, "predicted": pred,
            "stages": stages, "peak_gib": peak, "total_s": total, "scans": scans,
            "norms": norms}


# ------------------------------------------------------------ phase 2

PHASE2_SEED = [0x9A5E_0001, 0x9A5E_0002, 0x9A5E_0003, 0x9A5E_0004, 9, 10, 11, 12]
PHASE2_BELLMAN_SEED = [0xBE11_0001, 0xBE11_0002, 0xBE11_0003, 0xBE11_0004, 1, 2, 3, 4]
PHASE2_BEACON = bytes.fromhex("a5" * 32)
PHASE2_BEACON_EXP = 10
PHASE2_VERIFY_SEED = 2718


class Lines:
    """A logger that keeps its error and info lines."""

    def __init__(self):
        self.lines = []

    def error(self, m):
        self.lines.append(m)

    info = warn = error

    def debug(self, m):
        pass


@contextlib.contextmanager
def field_shapes():
    """Count K-field launches by (field, elements) in a block; the calls go
    on to the wrapper unchanged."""
    seen = collections.Counter()
    launch = fcuda.launch

    def rec(op, fp, a, b=None):
        seen[(fp.name, a.numel() // fp.nl)] += 1
        return launch(op, fp, a, b)

    fcuda.launch = rec
    try:
        yield seen
    finally:
        fcuda.launch = launch


def phase2_predicted(domain):
    """K-field launches in phase 2's batched double-and-adds, counted from the
    code: 71 a G1 step (as `ceremony_predicted` counts), 254 steps a batch
    of full-size scalars.  A contribution: one batch (sections 8 and 9
    together, n_l + domain lanes).  An export or an import: stages 1 .. k-1
    of the group iNTT of the 2^k = domain H points, one batch each, and the
    coset key's batch.  A Bellman round: one batch (H and L).  A verify:
    four K-scans (two MSMs for L, two for H)."""
    g1 = 254 * 71
    k = domain.bit_length() - 1
    return {"contribute": g1, "export_mpc_params": k * g1, "import_mpc_params": k * g1,
            "bellman_contribute": g1, "verify_from_init_msm_scan": 4}


def with_section(zkey, sid, payload):
    bf = BinFile(zkey, "zkey")
    sec = bf.section(sid)
    check(len(payload) == sec.size, "a replaced section must keep its size")
    return zkey[:sec.pos] + payload + zkey[sec.pos + sec.size:]


def phase_zkey_mpc(dev, gen, errs, ptau, zbytes, r1cs, wit):
    """Groth16 phase 2 at domain 2^18 on phase 10's key (the
    200,000-constraint chain with circom's coefficients) and .ptau:
    contribute (ChaCha(PHASE2_SEED)), beacon; five points of sections 8 and 9
    against old point x (d1 d2)^-1 on host bigints and the header's delta
    against (d1 d2) G; verify_from_init (accepts; rejects two swapped L
    points and a flipped transcript byte), verify_from_r1cs; export ->
    bellman_contribute -> import, verify of the imported key, a flipped
    csHash byte refused; a Groth16 proof with the final key and with the
    imported one, a tampered public rejected; the Solidity verifier of the
    final key.  Launch counts set to 0 just before contribute,
    verify_from_init, export_mpc_params and import_mpc_params and read just
    after, beside the counts predicted from the code; one stage of the H
    points' group iNTT timed and profiled alone; K-field, K-scan and
    K-mm-norm against their plain versions at the shapes the phase gave
    them."""
    cv = hc.BN254
    fr, fq = cv.fr, cv.fq
    sz = 2 * fq.n8
    t_phase = time.perf_counter()
    steps, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    _, _, meta, vk0 = zkey_mpc._parse(zbytes)
    domain = meta["domain"]
    n_l = meta["n_vars"] - meta["n_public"] - 1
    pred = phase2_predicted(domain)
    verify = lambda z, lg=None: zkey_mpc.verify_from_init(
        zbytes, ptau, z, logger=lg, rng=np.random.default_rng(PHASE2_VERIFY_SEED), device=dev)

    with field_shapes() as fshapes:
        reset_counts()
        steps["contribute"], (z1, h1) = wall_ms(lambda: zkey_mpc.contribute(
            zbytes, name="chip_smoke", rng=ChaCha(PHASE2_SEED), device=dev))
        launches["contribute"] = counts()
        steps["beacon"], (z2, h2) = wall_ms(lambda: zkey_mpc.beacon(
            z1, PHASE2_BEACON, PHASE2_BEACON_EXP, name="beacon", device=dev))
        log(f"  contribute (n_l {n_l} + domain {domain} points): {steps['contribute']:.0f} ms, "
            f"K-field launches {launches['contribute']['field_ops']} (predicted "
            f"{pred['contribute']} in the double-and-add, plus the powers, the affine form "
            f"and the codecs); beacon (2^{PHASE2_BEACON_EXP} SHA-256): {steps['beacon']:.0f} ms; "
            f"hashes {h1[:8].hex()}..., {h2[:8].hex()}...")

        # the new points on host bigints: old x (d1 d2)^-1, delta = (d1 d2) G
        d = (keypair.field_from_rng(fr, ChaCha(PHASE2_SEED)) * keypair.field_from_rng(
            fr, ptau_ops.rng_from_beacon(PHASE2_BEACON, PHASE2_BEACON_EXP))) % fr.p
        d_inv = pow(d, -1, fr.p)
        before, after = zkey_sections(zbytes), zkey_sections(z2)
        for sid, n in ((8, n_l), (9, domain)):
            for i in (0, 1, n // 2, n - 2, n - 1):
                P = pcodec.g1_lem_to_ints(fq, before[sid][i * sz:(i + 1) * sz], 1)[0]
                Q = pcodec.g1_lem_to_ints(fq, after[sid][i * sz:(i + 1) * sz], 1)[0]
                check(Q == (None if P is None else hc.g1_mul(cv, P, d_inv)),
                      f"section {sid} point {i} is not the old one times (d1 d2)^-1")
        _, _, _, vk2 = zkey_mpc._parse(z2)
        check(vk0["delta_1"] == cv.g1 and vk2["delta_1"] == hc.g1_mul(cv, cv.g1, d)
              and vk2["delta_2"] == hc.g2_mul(cv, cv.g2, d),
              "the header's delta is not (d1 d2) G")
        check(all(before[s] == after[s] for s in range(3, 8)), "sections 3-7 changed")
        del before, after
        log("  sections 8 and 9 at five indices == old point x (d1 d2)^-1 on host bigints; "
            "delta_1, delta_2 == (d1 d2) G")

        with recorded_shapes() as vshapes:
            reset_counts()
            lg = Lines()
            steps["verify_from_init"], ok = wall_ms(lambda: verify(z2, lg))
            launches["verify_from_init"] = counts()
        check(ok and not lg.lines, f"verify_from_init rejects the final key: {lg.lines}")
        check(launches["verify_from_init"]["msm_scan"] == pred["verify_from_init_msm_scan"],
              f"verify_from_init launched {launches['verify_from_init']['msm_scan']} K-scans")
        sec8 = bytearray(BinFile(z2, "zkey").read_section(8))
        sec8[:sz], sec8[sz:2 * sz] = sec8[sz:2 * sz], sec8[:sz]
        lg_l = Lines()
        steps["verify_l_swapped"], ok = wall_ms(lambda: verify(
            with_section(z2, 8, bytes(sec8)), lg_l))
        check(not ok and lg_l.lines == ["L section does not match"],
              f"verify with two L points swapped: {ok} {lg_l.lines}")
        mp = zkey_mpc.read_mpc_params(cv, BinFile(z2, "zkey").read_section(10))
        t0 = mp.contributions[-1].transcript
        mp.contributions[-1].transcript = bytes([t0[0] ^ 1]) + t0[1:]
        lg_t = Lines()
        steps["verify_transcript_flipped"], ok = wall_ms(lambda: verify(
            with_section(z2, 10, zkey_mpc.write_mpc_params(cv, mp)), lg_t))
        check(not ok and lg_t.lines == ["INVALID(1): Inconsistent transcript"],
              f"verify with a flipped transcript byte: {ok} {lg_t.lines}")
        del sec8, mp
        log(f"  verify_from_init: {steps['verify_from_init']:.0f} ms, True; launches "
            f"{launches['verify_from_init']} (predicted {pred['verify_from_init_msm_scan']} "
            f"K-scans); two L points swapped: False in {steps['verify_l_swapped']:.0f} ms; "
            f"a transcript byte flipped: False in {steps['verify_transcript_flipped']:.0f} ms")
        steps["verify_from_r1cs"], ok = wall_ms(lambda: zkey_mpc.verify_from_r1cs(
            r1cs, ptau, z2, rng=np.random.default_rng(PHASE2_VERIFY_SEED), device=dev))
        check(ok, "verify_from_r1cs rejects the final key")
        log(f"  verify_from_r1cs (setup_from_ptau + verify): {steps['verify_from_r1cs']:.0f} ms, "
            "True")
        torch.cuda.empty_cache()

        reset_counts()
        steps["export_mpc_params"], mpc = wall_ms(lambda: bellman.export_mpc_params(
            z2, device=dev))
        launches["export_mpc_params"] = counts()
        steps["bellman_contribute"], (resp, bh) = wall_ms(lambda: bellman.bellman_contribute(
            cv, mpc, rng=ChaCha(PHASE2_BELLMAN_SEED), device=dev))
        reset_counts()
        steps["import_mpc_params"], z3 = wall_ms(lambda: bellman.import_mpc_params(
            z2, resp, name="bellman", device=dev))
        launches["import_mpc_params"] = counts()
        check(z3 is not False, "import_mpc_params refuses the Bellman response")
        lg = Lines()
        steps["verify_imported"], ok = wall_ms(lambda: verify(z3, lg))
        check(ok and not lg.lines, f"verify_from_init rejects the imported key: {lg.lines}")
        cs_pos = (sz * 3 + 2 * sz * 3 + 8 + sz * meta["n_vars"] + 4 + sz * (domain - 1)
                  + 4 + sz * meta["n_vars"] + 4 + sz * meta["n_vars"] + 4
                  + 2 * sz * meta["n_vars"])
        check(mpc[cs_pos:cs_pos + 64] == BinFile(z2, "zkey").read_section(10)[:64],
              "the csHash is not where the MPCParams layout puts it")
        bad = bytearray(resp)
        bad[cs_pos] ^= 1
        lg = Lines()
        check(bellman.import_mpc_params(z2, bytes(bad), logger=lg, device=dev) is False
              and lg.lines == ["Hash of the original circuit does not match with the MPC one"],
              f"a response with a flipped csHash byte: {lg.lines}")
        log(f"  export_mpc_params: {steps['export_mpc_params']:.0f} ms ({len(mpc)} bytes), "
            f"K-field launches {launches['export_mpc_params']['field_ops']} (predicted "
            f"{pred['export_mpc_params']}); bellman_contribute "
            f"{steps['bellman_contribute']:.0f} ms; import_mpc_params "
            f"{steps['import_mpc_params']:.0f} ms, K-field launches "
            f"{launches['import_mpc_params']['field_ops']} (predicted "
            f"{pred['import_mpc_params']}); verify of the imported key "
            f"{steps['verify_imported']:.0f} ms: True; a flipped csHash byte: refused")
        del mpc, resp, bad
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()

    bad_pub = lambda pubs: [str(int(pubs[0]) + 1)] + pubs[1:]
    for name, z in (("final", z2), ("imported", z3)):
        zk = read_groth16_zkey(z)
        steps[f"prove_{name}"], (proof, publics) = wall_ms(
            lambda: groth16.prove(zk, wit, r=0x2121, s=0x4343, device=dev))
        gvk = groth16.export_verification_key(zk)
        check(groth16.verify(gvk, publics, proof), f"the proof with the {name} key fails")
        check(not groth16.verify(gvk, bad_pub(publics), proof),
              f"tampered public accepted ({name} key)")
        del zk
        torch.cuda.empty_cache()
    log(f"  Groth16 proves with the final key {steps['prove_final']:.0f} ms and the imported "
        f"key {steps['prove_imported']:.0f} ms: pairing checks pass, tampered publics rejected")

    vk = groth16.export_verification_key(read_groth16_zkey(z2))
    src = solidity.export_verifier(vk)
    consts = dict(re.findall(r"constant (\w+) = (\d+);", src))
    want = {"r": fr.p, "q": fq.p, "alphax": vk["vk_alpha_1"][0], "alphay": vk["vk_alpha_1"][1]}
    for nm, key in (("beta", "vk_beta_2"), ("gamma", "vk_gamma_2"), ("delta", "vk_delta_2")):
        (x1, x2), (y1, y2) = vk[key][0], vk[key][1]
        want.update({nm + "x1": x1, nm + "x2": x2, nm + "y1": y1, nm + "y2": y2})
    for i, ic in enumerate(vk["IC"]):
        want.update({f"IC{i}x": ic[0], f"IC{i}y": ic[1]})
    check(not re.findall(r"\{[a-zA-Z_]+\}", src), "a placeholder is left in the verifier")
    check({k: consts.get(k) for k in want} == {k: str(int(v)) for k, v in want.items()},
          "the verifier's constants differ from the key's")
    log(f"  Solidity verifier of the final key: {len(src)} characters, {len(want)} constants "
        "== the key's, no placeholder")

    # one stage of the H points' group iNTT alone
    stage = blocks_stage_busy(cv, False, [(BinFile(z2, "zkey").read_section(9),
                                           domain.bit_length() - 1)], dev, "phase 2 export")

    # the kernels at the shapes the phase gave them
    top = [n for (fname, n), _ in fshapes.most_common() if fname == "bn254_fq"][:3]
    log(f"  K-field lane counts, most launched first: "
        f"{[(k, v) for k, v in fshapes.most_common(6)]}")
    field_cases(dev, gen, errs, top, "phase 2's batches")
    n1 = min(1 << 16, n_l)
    x1, y1, _ = pcodec.g1_lem_from_bytes(fq, BinFile(z2, "zkey").read_section(8)[:n1 * sz], n1)
    scans = ceremony_scans(cv, vshapes["msm_scan"],
                           {"g1": (ftorch.to_tensor(x1, dev), ftorch.to_tensor(y1, dev))},
                           gen, errs, path="phase 2 verify")
    check(not vshapes["digit_mm"], "verify_from_init launched K-mm")
    norms = norm_cases(dev, gen, vshapes["digit_mm_norm"], "phase 2 verify", errs)
    total = time.perf_counter() - t_phase
    log(f"  phase 2 steps ms: {json.dumps({k: round(v, 1) for k, v in steps.items()})}")
    log(f"  phase 2 peak device memory {peak:.2f} GiB; phase total {total:.1f} s")
    return {"domain": domain, "n_l": n_l, "steps_ms": steps, "launches": launches,
            "predicted": pred, "stage": stage, "peak_gib": peak, "total_s": total,
            "scans": scans, "norms": norms}


# ------------------------------------------------------ phase 15: the CLI

CLI_PY_VM_CONSTRAINTS = 1 << 10   # the Python VM's chain (about 100x slower)
# wtns check's launches counted from the code (tools.wtns_check): to_mont and
# mont_mul on the entries, three segment sums of 4, to_mont and mont_mul
WTNS_CHECK_PREDICTED = {"field_ops": 16, "msm_scan": 0, "digit_mm": 0, "digit_mm_norm": 0}


class LogLines(logging.Handler):
    """Keeps the messages of the CLI's logger."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def timed_parts():
    """Wall ms of the witness calculator's parts while the block runs:
    instantiation, calculation (init and the inputs), read-out (getWitness
    and the shared-memory words of every value), the .wtns bytes."""
    parts = {}
    calc = wvm.WitnessCalculator
    saved = (calc.__init__, calc._set_inputs, calc._read_witness, wvm.wtns_bytes)

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[name] = (time.perf_counter() - t) * 1e3
        return run

    calc.__init__ = timed("instantiate", saved[0])
    calc._set_inputs = timed("calculate", saved[1])
    calc._read_witness = timed("read-out", saved[2])
    wvm.wtns_bytes = timed(".wtns bytes", saved[3])
    try:
        yield parts
    finally:
        calc.__init__, calc._set_inputs, calc._read_witness, wvm.wtns_bytes = saved


def cli_step(log_lines, words):
    """`cli.main(words)` in-process, its launch counts set to 0 just before
    and read just after: (exit code, stdout, log lines, wall ms, counts).
    An exception inside the step ends the script."""
    out = io.StringIO()
    log_lines.lines = []
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(w) for w in words])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return rc, out.getvalue(), list(log_lines.lines), ms, counts()


def phase_cli(dev, gen, errs, ptau, zbytes, r1cs, wit, inprocess_ms):
    """The CLI and witness calculation at domain 2^18: the 200,000-constraint
    chain with circom's coefficients as circom would give it (.wasm, .r1cs,
    .sym, input.json from tests/_wasm_chain.py) and phase 10's .ptau and
    Groth16 key, driven through `python -m snarkjs_tpu_torch` once (a
    subprocess) and then through `cli.main` in-process, each step's launch
    counts set to 0 just before and read just after.  The native VM's
    instantiation, calculation and read-out are timed apart inside the
    `wtns calculate` step; the Python VM runs a chain of 2^10.  Each step's
    wall time stands beside the in-process time of the same call in the
    earlier phases (`inprocess_ms`).  The shapes the steps give K-field,
    K-scan and K-mm-norm are recorded, and each kernel is held against its
    plain version at every one of them."""
    cv = hc.BN254
    fr = cv.fr
    nc = r1cs.n_constraints
    t_phase = time.perf_counter()
    steps, launches = {}, {}
    seen = {k: collections.Counter() for k in ("digit_mm", "digit_mm_norm", "msm_scan")}
    fseen = collections.Counter()
    handler = LogLines()
    logger = logging.getLogger("snarkjs_tpu_torch")
    logger.addHandler(handler)
    t = time.perf_counter()
    wasm_native._lib()
    steps["wasmvm build (g++)"] = (time.perf_counter() - t) * 1e3

    def step(name, words, expect_rc=0):
        with recorded_shapes() as shapes, field_shapes() as fshapes:
            rc, out, lines, ms, c = cli_step(handler, words)
        for k, v in shapes.items():
            seen[k].update(v)
        fseen.update(fshapes)
        check(rc == expect_rc, f"CLI {name}: exit code {rc}, expected {expect_rc}")
        steps[name], launches[name] = ms, c
        log(f"  {name}: {ms:.0f} ms, exit {rc}, launches {c}")
        return out, lines

    try:
        with tempfile.TemporaryDirectory() as d:
            P = lambda fn: os.path.join(d, fn)
            t = time.perf_counter()
            files = wasm_chain.write_chain(d, fr.p, nc)
            ptau.save(P("pot19.ptau"))
            steps["write files"] = (time.perf_counter() - t) * 1e3
            back = read_r1cs(files["chain.r1cs"])
            check((back.n_wires, back.n_pub_in, back.n_constraints)
                  == (r1cs.n_wires, r1cs.n_pub_in, r1cs.n_constraints)
                  and all(np.array_equal(getattr(back, k), getattr(r1cs, k))
                          for k in ("m", "c", "s", "vals")),
                  "the generated .r1cs is not phase 10's chain")
            log(f"  chain files and the power-{SETUP_POWER} .ptau written in "
                f"{steps['write files']:.0f} ms; the .r1cs reads back as phase 10's chain")

            # the entry point as a user runs it, on a machine with no jax
            t = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "snarkjs_tpu_torch", "r1cs", "info",
                                   files["chain.r1cs"]], cwd=HERE, capture_output=True,
                                  text=True, timeout=600)
            steps["python -m snarkjs_tpu_torch r1cs info"] = (time.perf_counter() - t) * 1e3
            check(proc.returncode == 0 and f"# of Constraints: {nc}" in proc.stderr,
                  f"python -m snarkjs_tpu_torch r1cs info: {proc.returncode} {proc.stderr[-500:]}")
            log(f"  python -m snarkjs_tpu_torch r1cs info: exit 0 in "
                f"{steps['python -m snarkjs_tpu_torch r1cs info']:.0f} ms")

            # witness calculation through the CLI, the native VM's parts timed
            # inside that step
            want = write_wtns(fr, wit.values)
            with timed_parts() as parts:
                step("wtns calculate", ["wtns", "calculate", files["chain.wasm"],
                                        files["input.json"], P("witness.wtns")])
            with open(P("witness.wtns"), "rb") as f:
                check(f.read() == want, "CLI wtns calculate: .wtns differs from "
                                        "write_wtns of circom_chain's witness")
            for part, ms in parts.items():
                steps[f"native VM: {part}"] = ms
            rate = nc / parts["calculate"] * 1e3
            log(f"  native VM at {nc} constraints: instantiate {parts['instantiate']:.0f} ms, "
                f"calculate {parts['calculate']:.0f} ms ({rate:.0f} constraints/s), read-out "
                f"{parts['read-out']:.0f} ms ({(nc + 2) * (wasm_chain.N32 + 1)} ctypes calls), "
                f".wtns bytes {parts['.wtns bytes']:.0f} ms; == write_wtns of circom_chain's "
                "witness")
            small = wasm_chain.write_chain(P("small"), fr.p, CLI_PY_VM_CONSTRAINTS)
            for vm in ("python", "native"):
                step(f"wtns calculate 2^10 --vm={vm}",
                     ["wtns", "calculate", small["chain.wasm"], small["input.json"],
                      P(f"small_{vm}.wtns"), f"--vm={vm}"])
            with open(P("small_python.wtns"), "rb") as f, open(P("small_native.wtns"), "rb") as g:
                py_bytes = f.read()
                check(py_bytes == g.read() == write_wtns(
                    fr, circom_chain(fr, CLI_PY_VM_CONSTRAINTS)[1].values),
                    "the Python and native VMs differ at 2^10")
            log("  2^10 chain: Python VM == native VM == circom_chain's witness")

            # wtns check: the good witness, then one flipped value
            _, lines = step("wtns check", ["wtns", "check", files["chain.r1cs"],
                                           P("witness.wtns")])
            check("WITNESS IS CORRECT" in lines, f"wtns check said {lines}")
            check(launches["wtns check"] == dict(launches["wtns check"], **WTNS_CHECK_PREDICTED),
                  f"wtns check launched {launches['wtns check']}, predicted "
                  f"{WTNS_CHECK_PREDICTED}")
            bad = bytearray(want)
            bad[-32 * (nc + 2 - 7)] ^= 1          # wire 7: constraint 5's output
            with open(P("bad.wtns"), "wb") as f:
                f.write(bad)
            _, lines = step("wtns check (flipped)", ["wtns", "check", files["chain.r1cs"],
                                                     P("bad.wtns")], expect_rc=1)
            check(lines == ["Constraint 5 does not match"], f"flipped wtns check said {lines}")
            steps["wtns check in-process"], ok = wall_ms(
                lambda: tools.wtns_check(r1cs, wit, device=dev))
            check(ok, "tools.wtns_check rejects the chain's witness")

            # Groth16: setup (phase 10's key), prove, fullprove, verify, calldata
            step("groth16 setup", ["groth16", "setup", files["chain.r1cs"], P("pot19.ptau"),
                                   P("g16.zkey")])
            with open(P("g16.zkey"), "rb") as f:
                check(f.read() == zbytes, "CLI groth16 setup differs from phase 10's key")
            step("groth16 prove", ["groth16", "prove", P("g16.zkey"), P("witness.wtns"),
                                   P("proof.json"), P("public.json")])
            step("groth16 fullprove", ["groth16", "fullprove", files["input.json"],
                                       files["chain.wasm"], P("g16.zkey"), P("proof2.json"),
                                       P("public2.json")])
            step("zkey export verificationkey", ["zkey", "export", "verificationkey",
                                                 P("g16.zkey"), P("vk.json")])
            verify_both(step, "groth16", P, "vk.json", ("proof.json", "proof2.json"))
            out, _ = step("zkey export soliditycalldata", ["zkey", "export",
                                                           "soliditycalldata",
                                                           P("public.json"), P("proof.json")])
            check(out.startswith("[") and out.count("0x") == 9,
                  f"soliditycalldata printed {out[:200]!r}")

            # PLONK at 2^18 from the same .ptau
            step("plonk setup", ["plonk", "setup", files["chain.r1cs"], P("pot19.ptau"),
                                 P("plonk.zkey")])
            step("plonk fullprove", ["plonk", "fullprove", files["input.json"],
                                     files["chain.wasm"], P("plonk.zkey"),
                                     P("plonk_proof.json"), P("plonk_public.json")])
            step("zkey export verificationkey (plonk)", ["zkey", "export", "verificationkey",
                                                         P("plonk.zkey"), P("plonk_vk.json")])
            verify_both(step, "plonk", P, "plonk_vk.json", ("plonk_proof.json",))

            # FFLONK at 2^16 (9n + 18 points: the largest domain the .ptau holds)
            ff = wasm_chain.write_chain(P("ff"), fr.p, FFLONK_PTAU_CONSTRAINTS)
            step("fflonk setup", ["fflonk", "setup", ff["chain.r1cs"], P("pot19.ptau"),
                                  P("fflonk.zkey")])
            step("fflonk fullprove", ["fflonk", "fullprove", ff["input.json"],
                                      ff["chain.wasm"], P("fflonk.zkey"),
                                      P("fflonk_proof.json"), P("fflonk_public.json")])
            step("zkey export verificationkey (fflonk)", ["zkey", "export", "verificationkey",
                                                          P("fflonk.zkey"), P("fflonk_vk.json")])
            verify_both(step, "fflonk", P, "fflonk_vk.json", ("fflonk_proof.json",))
    finally:
        logger.removeHandler(handler)
    for name in ("groth16 setup", "groth16 prove", "plonk setup", "fflonk setup"):
        log(f"  {name}: CLI {steps[name]:.0f} ms against {inprocess_ms[name]:.0f} ms in-process "
            "(earlier phase)")
    log(f"  wtns check: CLI {steps['wtns check']:.0f} ms against "
        f"{steps['wtns check in-process']:.0f} ms in-process")
    for kname in ("field_ops", "msm_scan", "digit_mm_norm"):
        check(sum(c[kname] for c in launches.values()) > 0,
              f"the CLI steps launched no {kname}")

    # the kernels at every shape the CLI steps gave them
    t = time.perf_counter()
    log(f"  CLI shapes: {shapes_json(seen)}; K-field: {len(fseen)} (field, elements) "
        f"sizes, {sum(fseen.values())} launches")
    check(sum(fseen.values()) == sum(c["field_ops"] for c in launches.values()),
          "the recorded K-field launches are not the counted ones")
    for fname in sorted({f for f, _ in fseen}):
        field_cases(dev, gen, errs, sorted(n for f, n in fseen if f == fname),
                    "every size the CLI steps gave it", fname)
    fq, sz1 = cv.fq, 2 * cv.fq.n8
    n1, n2 = 1 << 16, 1 << 15
    x1, y1, _ = pcodec.g1_lem_from_bytes(fq, bytes(ptau.sections[2][:n1 * sz1]), n1)
    x2, y2, _ = pcodec.g2_lem_from_bytes(fq, bytes(ptau.sections[3][:n2 * 2 * sz1]), n2)
    put = lambda a: tuple(put(c) for c in a) if isinstance(a, tuple) else ftorch.to_tensor(a, dev)
    scans = ceremony_scans(cv, seen["msm_scan"], {"g1": (put(x1), put(y1)),
                                                  "g2": (put(x2), put(y2))},
                           gen, errs, path="cli")
    check(set(seen["msm_scan"]) <= HELD[("msm_scan", cv.fq.name)],
          f"a K-scan shape of the CLI steps was not compared: {sorted(seen['msm_scan'])}")
    check(not seen["digit_mm"], "a CLI step launched K-mm")
    norms = norm_cases(dev, gen, seen["digit_mm_norm"], "cli", errs)
    check(set(seen["digit_mm_norm"]) <= HELD[("digit_mm_norm", cv.fr.name)],
          "a K-mm-norm shape of the CLI steps was not compared")
    steps["kernels vs plain at the CLI shapes"] = (time.perf_counter() - t) * 1e3
    total = time.perf_counter() - t_phase
    log(f"  CLI phase steps ms: {json.dumps({k: round(v, 1) for k, v in steps.items()})}")
    log(f"  CLI phase total {total:.1f} s")
    return {"steps_ms": steps, "launches": launches, "inprocess_ms": inprocess_ms,
            "native_vm_constraints_per_s": rate,
            "predicted": {"wtns check": WTNS_CHECK_PREDICTED},
            "field_sizes": len(fseen), "total_s": total, "scans": scans, "norms": norms}


# ------------------------------------------------------------ phase 16: mesh

MESH_RANKS = 4                # Gloo ranks that share the one card
MESH_NTT_LOGS = (24, 20)      # sharded NTT sizes (2^24: both axes through K-mm-norm)
MESH_MSM_POINTS = 1 << 12     # msm_sharded and the legacy Pippenger
MESH_WARM = 1                 # warm proves the NCCL rank times after the counted one
MESH = {"mesh": None}         # this rank's mesh (mesh_step waits for every rank)
MESH_JOIN_S = 900.0


def mesh_rec():
    return {"steps": {}, "shapes": {k: collections.Counter()
                                    for k in ("digit_mm", "digit_mm_norm", "msm_scan")},
            "field_sizes": collections.Counter(), "equal": {}, "digest": {}, "ms": {}}


def mesh_step(rec, name, fn):
    """fn() on this rank, timed on the host clock between two card
    synchronisations once every rank has reached it, with its launches
    counted (set to 0 just before, read just after) and the shapes it gave
    K-scan, K-mm(-norm) and K-field."""
    from snarkjs_tpu_torch.parallel import distributed as pdist

    torch.cuda.synchronize()
    pdist.barrier(MESH["mesh"])
    with recorded_shapes() as shapes, field_shapes() as fshapes:
        reset_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        c = counts()
    rec["steps"][name] = {"ms": ms, "launches": {k: v for k, v in c.items()
                                                 if k != "field_by_op"}}
    for k, v in shapes.items():
        rec["shapes"][k].update(v)
    rec["field_sizes"].update(fshapes)
    return out


def limb_digest(t):
    """A checksum of a limb tensor, summed on the card limb by limb."""
    w = torch.arange(t.shape[-1], device=t.device, dtype=torch.int64) % 1009 + 1
    return sum(int((t[i].to(torch.int64) * w).sum()) * (i + 1) for i in range(t.shape[0]))


def mesh_prove(rec, mesh, dev, what, mod, read_key, extra, first=True, warm=0):
    """A prove over the mesh from the stashed key, witness and blinders: the
    first one (it uploads this rank's block of the key's points) unless
    `first` is False (the counted one then uploads), one counted, `warm`
    timed; the counted proof against the stored one."""
    from snarkjs_tpu_torch.formats.wtns import read_wtns

    ref = json.load(open(stash_path(f"{what}.json")))
    t = time.perf_counter()
    zk = read_key(stash_path(f"{what}.zkey"))
    wit = read_wtns(stash_path(f"{what}.wtns"))
    rec["ms"][f"{what} read key + witness"] = (time.perf_counter() - t) * 1e3
    kw = extra(ref)
    if first:
        rec["ms"][f"{what} first prove"] = wall_ms(
            lambda: mod.prove(zk, wit, device=dev, mesh=mesh, **kw))[0]
    proof, publics = mesh_step(rec, what, lambda: mod.prove(zk, wit, device=dev, mesh=mesh,
                                                           **kw))
    rec["ms"][f"{what} warm"] = [wall_ms(lambda: mod.prove(zk, wit, device=dev, mesh=mesh,
                                                           **kw))[0]
                                 for _ in range(warm)]
    rec["equal"][what] = json.dumps([proof, publics]) == json.dumps([ref["proof"],
                                                                      ref["publics"]])
    rec["ms"][f"{what} single-card warm (earlier phase)"] = ref["warm_ms"]
    return zk


def mesh_nccl_rank(rank, stash_dir):
    """Phase 16, one rank over NCCL: the 2^20 Groth16 prove over a mesh of
    one, against phase 5's proof and its single-card time."""
    from snarkjs_tpu_torch.parallel import distributed as pdist

    STASH["dir"] = stash_dir
    MESH["mesh"] = pdist.prover_mesh()
    mesh = MESH["mesh"]
    rec = mesh_rec()
    rec["mesh"] = type(mesh).__name__
    mesh_prove(rec, mesh, pdist.device(), "groth16", groth16, read_groth16_zkey,
               lambda ref: {"r": ref["r"], "s": ref["s"]}, warm=MESH_WARM)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return rec


def lagrange_block_want(cv, lem_lagrange, lem_tau, p, dev):
    """Block p + 1 of a prepared power-p section 12 from the power-P file's
    (P > p): the power-p file puts a zero point in place of tau^(N - 1) G1
    (N = 2^(p + 1)), so its block is L_j - (w^j / N) tau^(N - 1) G1, with L
    the power-P file's block (the Lagrange basis of all N points).  On the
    card: one batched scalar multiplication of N lanes, one add."""
    fq, fr = cv.fq, cv.fr
    f = ptau_ops._f(cv, False, dev)
    N = 1 << (p + 1)
    k = N.bit_length() - 1
    L = ptau_ops._lem_points(cv, lem_lagrange, N, False, dev)
    tx, ty, tinf = ptau_ops._lem_points(cv, bytes(memoryview(lem_tau)[(N - 1) * 64:N * 64]),
                                        1, False, dev)
    s = ptau_ops._powers(fr, pow(N, fr.p - 2, fr.p), fr.w[k], N, dev)
    cx, cy, cinf = jac.scalar_mul_affine(f, tx.expand(-1, N).contiguous(),
                                         ty.expand(-1, N).contiguous(), tinf.expand(N), s)
    P = jac.jac_add(f, jac.from_affine(f, *L),
                    jac.jac_neg(f, jac.from_affine(f, cx, cy, cinf)))
    return ptau_ops._lem_bytes(cv, False, *jac.to_affine_batch(f, P, f.batch_inv))


def prepared_equal(cv, prep, ptau, dev):
    """Sections 12-15 of `prep` (prepare_phase2 at a power p below phase
    10's) against phase 10's prepared file, built from the secrets' scalars:
    13-15, and 12's blocks up to 2^p, are its prefixes; 12's last block is
    `lagrange_block_want`."""
    sz = 2 * cv.fq.n8
    p = prep.power
    head = (2 * (1 << p) - 1) * sz
    eq = {sid: bytes(prep.sections[sid]) == bytes(ptau.sections[sid][:len(prep.sections[sid])])
          for sid in (13, 14, 15)}
    eq[12] = bytes(prep.sections[12][:head]) == bytes(ptau.sections[12][:head])
    last = bytes(ptau.sections[12][head:head + (2 << p) * sz])
    eq["12 last block"] = (bytes(prep.sections[12][head:])
                           == lagrange_block_want(cv, last, ptau.sections[2], p, dev))
    return eq


@contextlib.contextmanager
def sharded_blocks():
    """Counts, by group, the blocks that go through the sharded four-step
    group iNTT (the column blocks of `sharded.group_intt_blocks`) while the
    body runs."""
    from snarkjs_tpu_torch.parallel import sharded

    n = collections.Counter(g1=0, g2=0)
    inner = sharded.group_intt_blocks

    def counted(mesh, cv, g2, cols, small, device):
        n["g2" if g2 else "g1"] += len(cols)
        return inner(mesh, cv, g2, cols, small, device)

    sharded.group_intt_blocks = counted
    try:
        yield n
    finally:
        sharded.group_intt_blocks = inner


def sharded_blocks_want(power, ndev):
    """The blocks of prepare_phase2 at `power` over `ndev` ranks that reach
    the sharded group iNTT (2^k >= (4 * ndev)^2 points): tauG1's blocks
    k = 0 .. power + 1, alphaTauG1's and betaTauG1's k = 0 .. power on G1,
    tauG2's k = 0 .. power on G2."""
    lo = ((4 * ndev) ** 2).bit_length() - 1
    top = lambda kmax: max(0, kmax - lo + 1)
    return {"g1": top(power + 1) + 2 * top(power), "g2": top(power)}


def mesh_gloo_rank(rank, stash_dir):
    """Phase 16, one of MESH_RANKS Gloo ranks on the one card: every step of
    the multi-device path, each counted and its shapes recorded."""
    from snarkjs_tpu_torch.curves.gops import FqOps
    from snarkjs_tpu_torch.parallel import distributed as pdist
    from snarkjs_tpu_torch.parallel import sharded

    STASH["dir"] = stash_dir
    MESH["mesh"] = pdist.prover_mesh()
    mesh = MESH["mesh"]
    dev = pdist.device()
    rec = mesh_rec()
    rec["mesh"] = type(mesh).__name__
    cv = hc.BN254

    # the four-step NTT, against the unsharded one on rank 0
    ctx = ftorch.get_ctx("bn254_fr")
    for logn in MESH_NTT_LOGS:
        g = torch.Generator(device=dev)
        g.manual_seed(1600 + logn)
        x = rand_field(ctx.fp, 1 << logn, dev, g)
        y = mesh_step(rec, f"ntt_sharded 2^{logn}", lambda: sharded.ntt_sharded(mesh, ctx, x))
        z = mesh_step(rec, f"intt_sharded 2^{logn}",
                      lambda: sharded.ntt_sharded(mesh, ctx, y, inverse=True))
        rec["digest"][f"ntt 2^{logn}"] = (limb_digest(y), limb_digest(z))
        if rank == 0:
            rec["ms"][f"ntt_mm.ntt 2^{logn} (unsharded, rank 0)"], want = wall_ms(
                lambda: ntt_mm.ntt(ctx, x))
            ok = torch.equal(y, want)
            del want
            rec["ms"][f"ntt_mm.intt 2^{logn} (unsharded, rank 0)"], want = wall_ms(
                lambda: ntt_mm.intt(ctx, y))
            rec["equal"][f"ntt 2^{logn}"] = ok and torch.equal(z, want) and torch.equal(z, x)
            del want
        del x, y, z
        torch.cuda.empty_cache()

    # the three provers from the stashed keys, with their blinders
    mesh_prove(rec, mesh, dev, "groth16", groth16, read_groth16_zkey,
               lambda ref: {"r": ref["r"], "s": ref["s"]}, first=False)
    torch.cuda.empty_cache()
    mesh_prove(rec, mesh, dev, "plonk", plonk, read_plonk_zkey, lambda ref: {"b": ref["b"]},
               first=False)
    torch.cuda.empty_cache()
    mesh_prove(rec, mesh, dev, "fflonk", fflonk, read_fflonk_zkey, lambda ref: {"b": ref["b"]},
               first=False)
    torch.cuda.empty_cache()

    # the ceremony: contribute at power 19, prepare_phase2 at PREPARE_POWER
    t = time.perf_counter()
    ptau = ptau_fmt.read_ptau(stash_path("pot19.ptau"))
    acc = ptau_ops.new_accumulator(cv, SETUP_POWER)
    rec["ms"]["read .ptau + new_accumulator"] = (time.perf_counter() - t) * 1e3
    c1, _ = mesh_step(rec, "contribute", lambda: ptau_ops.contribute(
        acc, name="chip_smoke", rng=ChaCha(CEREMONY_SEED), device=dev, mesh=mesh))
    rec["equal"]["contribute"] = all(bytes(c1.sections[sid]) == bytes(ptau.sections[sid])
                                     for sid in range(2, 7))
    del c1, acc
    small = ptau_ops.truncate(ptau, PREPARE_POWER)
    with sharded_blocks() as rec["sharded_blocks"]:
        prep = mesh_step(rec, f"prepare_phase2 power {PREPARE_POWER}",
                         lambda: ptau_ops.prepare_phase2(small, device=dev, mesh=mesh))
    rec["digest"]["prepare_phase2"] = hashlib.sha256(
        b"".join(bytes(prep.sections[sid]) for sid in (12, 13, 14, 15))).hexdigest()
    if rank == 0:          # the others by the digest
        rec["equal"][f"prepare_phase2 power {PREPARE_POWER}"] = prepared_equal(cv, prep, ptau,
                                                                              dev)
    del prep, small

    # msm_sharded and the legacy Pippenger against GpuMSM.run
    n = MESH_MSM_POINTS
    x, y, inf = ptau_ops._lem_points(cv, bytes(memoryview(ptau.sections[2])[:n * 2 * cv.fq.n8]),
                                     n, False, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1612)
    scal = rand_field(cv.fr, n, dev, g)
    fq = cv.fq
    mctx = msm_mod.MSMContext(ftorch.get_ctx(fq.name), fq, 1)
    want = msm_mod.host_jac_to_affine(fq, mctx.run(x, y, inf, scal), 1)
    ws = mesh_step(rec, f"msm_sharded 2^{n.bit_length() - 1}", lambda: sharded.msm_sharded(
        mesh, FqOps(ftorch.get_ctx(fq.name), dev), x, y, inf, scal, c=8, nbits=256, R=64))
    legacy = mesh_step(rec, f"legacy MSMContext.run 2^{n.bit_length() - 1}",
                       lambda: mctx.run(x, y, inf, scal, legacy=True))
    rec["equal"]["msm_sharded"] = msm_mod.host_jac_to_affine(fq, mctx._finish(ws, 8, 256),
                                                             1) == want
    rec["equal"]["legacy"] = msm_mod.host_jac_to_affine(fq, legacy, 1) == want
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return rec


def phase_mesh(dev, gen, errs, ptau):
    """Phase 16: the multi-device path on the one card.  One rank over NCCL
    (the 2^20 Groth16 prove), then MESH_RANKS Gloo ranks all on cuda:0 in
    one spawn (NTTs, the three provers, contribute, prepare_phase2, the
    sharded and legacy MSMs); every result against its single-card
    counterpart; every shape the ranks gave K-scan, K-mm-norm and K-field
    held against the plain version (those held in earlier phases are not
    held again); the CLI's --devices."""
    from snarkjs_tpu_torch.parallel import distributed as pdist

    cv = hc.BN254
    t_phase = time.perf_counter()
    out = {"ms": {}}
    t = time.perf_counter()
    ptau.save(stash_path("pot19.ptau"))
    out["ms"]["write .ptau"] = (time.perf_counter() - t) * 1e3
    torch.cuda.empty_cache()

    t = time.perf_counter()
    (one,) = pdist.spawn(mesh_nccl_rank, 1, args=(STASH["dir"],), devices=["cuda:0"],
                         backend="nccl", timeout=MESH_JOIN_S)
    out["ms"]["one NCCL rank (spawn to join)"] = (time.perf_counter() - t) * 1e3
    check(one["equal"]["groth16"], "the one-rank NCCL Groth16 proof differs from phase 5's")
    log(f"  one rank over NCCL ({one['mesh']}): Groth16 2^20 == phase 5's proof; first "
        f"{one['ms']['groth16 first prove']:.0f} ms, counted "
        f"{one['steps']['groth16']['ms']:.1f} ms, warm {[round(v, 1) for v in one['ms']['groth16 warm']]} "
        f"ms against {one['ms']['groth16 single-card warm (earlier phase)']:.1f} ms unsharded; "
        f"launches {one['steps']['groth16']['launches']}")

    t = time.perf_counter()
    ranks = pdist.spawn(mesh_gloo_rank, MESH_RANKS, args=(STASH["dir"],),
                        devices=["cuda:0"] * MESH_RANKS, backend="gloo", timeout=MESH_JOIN_S)
    out["ms"][f"{MESH_RANKS} Gloo ranks (spawn to join)"] = (time.perf_counter() - t) * 1e3
    r0 = ranks[0]
    log(f"  {MESH_RANKS} Gloo ranks on cuda:0: mesh {r0['mesh']}")
    for k, v in r0["equal"].items():
        ok = all(v.values()) if isinstance(v, dict) else v
        check(ok, f"mesh step {k}: {v}")
    for k in ("ntt 2^24", "ntt 2^20", "prepare_phase2"):
        check(len({json.dumps(r["digest"].get(k)) for r in ranks}) == 1,
              f"the ranks' {k} results differ")
    want = sharded_blocks_want(PREPARE_POWER, MESH_RANKS)
    got = [dict(r["sharded_blocks"]) for r in ranks]
    check(all(g == want for g in got) and want["g1"] and want["g2"],
          f"prepare_phase2 over the mesh sent {got} blocks through the sharded group iNTT, "
          f"not {want} on every rank")
    log(f"  prepare_phase2 power {PREPARE_POWER}: blocks through the sharded group iNTT on "
        f"every rank {want}")
    for r in ranks[1:]:
        check(all((all(v.values()) if isinstance(v, dict) else v)
                  for v in r["equal"].values()), "a rank's result differs")
    for name in r0["steps"]:
        log(f"  {name}: " + ", ".join(f"rank {j} {r['steps'][name]['ms']:.0f} ms"
                                      for j, r in enumerate(ranks))
            + f"; launches rank 0 {r0['steps'][name]['launches']}")
    log(f"  times (rank 0): {json.dumps({k: (round(v, 1) if isinstance(v, float) else v) for k, v in r0['ms'].items()})}")
    log(f"  peak device memory GiB: NCCL rank {one['peak_gib']:.2f}; Gloo ranks "
        f"{[round(r['peak_gib'], 2) for r in ranks]}")
    log("  every step == its single-card counterpart on every rank")
    grp = ranks[0]["steps"]["groth16"]["launches"]
    check(grp["msm_scan"] == 5, f"a rank of the Groth16 mesh prove launched {grp['msm_scan']} K-scans")

    # the shapes every rank gave the kernels, each held against plain
    t = time.perf_counter()
    seen = {k: collections.Counter() for k in ("digit_mm", "digit_mm_norm", "msm_scan")}
    fseen = collections.Counter()
    for r in [one] + ranks:
        for k in seen:
            seen[k].update(r["shapes"][k])
        fseen.update(r["field_sizes"])
    log(f"  mesh shapes: {shapes_json(seen)}; K-field: {len(fseen)} sizes")
    cw16 = all(sh[0] == cv.fq.nl for r in ranks for sh in r["shapes"]["msm_scan"])
    check(cw16 and all(r["shapes"]["msm_scan"] for r in ranks),
          "a Gloo rank ran K-scan at another window than cw = 16 (nw = 16), or not at all")
    for fname in sorted({f for f, _ in fseen}):
        field_cases(dev, gen, errs, sorted(n for f, n in fseen if f == fname),
                    "every size the mesh ranks gave it", fname)
    fq, sz1 = cv.fq, 2 * cv.fq.n8
    x1, y1, _ = pcodec.g1_lem_from_bytes(fq, bytes(ptau.sections[2][:(1 << 16) * sz1]), 1 << 16)
    x2, y2, _ = pcodec.g2_lem_from_bytes(fq, bytes(ptau.sections[3][:(1 << 15) * 2 * sz1]),
                                         1 << 15)
    put = lambda a: tuple(put(c) for c in a) if isinstance(a, tuple) else ftorch.to_tensor(a, dev)
    scans = ceremony_scans(cv, seen["msm_scan"], {"g1": (put(x1), put(y1)),
                                                  "g2": (put(x2), put(y2))},
                           gen, errs, path="mesh")
    norms = norm_cases(dev, gen, seen["digit_mm_norm"], "mesh", errs)
    check(not seen["digit_mm"], "a mesh step launched K-mm")
    check(set(seen["msm_scan"]) <= HELD[("msm_scan", cv.fq.name)]
          and set(seen["digit_mm_norm"]) <= HELD[("digit_mm_norm", cv.fr.name)],
          "a shape of the mesh ranks was not held against plain")
    out["ms"]["kernels vs plain at the mesh shapes"] = (time.perf_counter() - t) * 1e3

    # the CLI: --devices 2 refused before any rank starts; --devices 1 proves
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        args = ["groth16", "prove", os.path.join(FIXTURES, "tiny_bn128.zkey"),
                os.path.join(FIXTURES, "tiny_bn128.wtns"), os.path.join(d, "proof.json"),
                os.path.join(d, "public.json")]
        try:
            cli._prove("groth16", *args[2:], devices="2")
            check(False, "--devices 2 on one card did not raise")
        except ValueError as e:
            check(str(e) == "--devices 2: only 1 devices visible", f"--devices 2 raised {e!r}")
        check(not os.path.exists(os.path.join(d, "proof.json")), "--devices 2 wrote a proof")
        rc = cli.main(args + ["--devices=1"])
        with open(os.path.join(d, "proof.json")) as f:
            proof = json.load(f)
        with open(os.path.join(d, "public.json")) as f:
            publics = json.load(f)
        vk = groth16.export_verification_key(read_groth16_zkey(args[2]))
        check(rc == 0 and groth16.verify(vk, publics, proof),
              "the CLI's --devices 1 proof does not verify")
    out["ms"]["CLI --devices"] = (time.perf_counter() - t) * 1e3
    log("  CLI: groth16 prove --devices 2 raised 'only 1 devices visible' before starting a "
        "rank; --devices 1 proved and its proof verifies")
    total = time.perf_counter() - t_phase
    log(f"  mesh phase ms: {json.dumps({k: round(v, 1) for k, v in out['ms'].items()})}")
    log(f"  mesh phase total {total:.1f} s")
    launches = {"nccl 1 rank": {s: [one["steps"][s]["launches"]] for s in one["steps"]},
                f"gloo {MESH_RANKS} ranks": {s: [r["steps"][s]["launches"] for r in ranks]
                                             for s in r0["steps"]}}
    return {"ms": out["ms"], "total_s": total, "launches": launches,
            "nccl": {k: one[k] for k in ("mesh", "ms", "steps", "peak_gib")},
            "gloo": [{k: r[k] for k in ("mesh", "ms", "steps", "peak_gib", "equal")}
                     for r in ranks],
            "scans": scans, "norms": norms, "field_sizes": len(fseen)}


def verify_both(step, proto, P, vk, proofs):
    """`<proto> verify` accepts each proof ("OK!") and rejects it with the
    first public signal plus one (exit 1, "INVALID proof")."""
    for proof in proofs:
        public = proof.replace("proof", "public")
        out, _ = step(f"{proto} verify {proof}", [proto, "verify", P(vk), P(public), P(proof)])
        check(out.strip() == "OK!", f"{proto} verify printed {out!r}")
        with open(P(public)) as f:
            pubs = json.load(f)
        with open(P("tampered.json"), "w") as f:
            json.dump([str(int(pubs[0]) + 1)] + pubs[1:], f)
        out, _ = step(f"{proto} verify {proof} (tampered public)",
                      [proto, "verify", P(vk), P("tampered.json"), P(proof)], expect_rc=1)
        check(out.strip() == "INVALID proof", f"{proto} verify (tampered) printed {out!r}")


# ------------------------------------------- the MSM keywords and bls12-381

WARM_BLS = 3        # warm proves for a bls12-381 median


def phase_plonk_cw8(dev, gen, errs, pk):
    """Phase 17: phase 7's bn128 PLONK key proved once more with msm_c=4,
    msm_cw=8, counted: the proof byte-equal to phase 7's, then K-scan held
    against its plain version at the cw = 8 shapes it gave."""
    cv = hc.BN254
    zk, wit, b = pk["zk"], pk["wit"], pk["b"]
    with recorded_shapes() as shapes:
        reset_counts()
        ms, got = wall_ms(lambda: plonk.prove(zk, wit, b=b, device=dev, msm_c=4, msm_cw=8))
        launches = counts()
    log(f"  bn128 PLONK 2^18 with msm_c=4, msm_cw=8: {ms:.1f} ms; launches {launches}")
    log(f"  shapes: {shapes_json(shapes)}")
    check(json.dumps(list(got)) == json.dumps(pk["proof"]),
          "the PLONK proof with msm_c=4, msm_cw=8 differs from phase 7's")
    seen = shapes["msm_scan"]
    check(launches["msm_scan"] == 9 and launches["digit_mm_norm"] == 20
          and launches["digit_mm"] == 0 and set(sh[0] for sh in seen) == {32},
          "PLONK with msm_cw=8: expected 9 K-scan launches over 32 windows, 20 K-mm-norm, "
          "no K-mm")
    log("  proof == phase 7's, byte for byte")
    x, y, _ = plonk._dev_key(zk, dev, zk.ptau[2].shape[0])["ptau"]
    scans = ceremony_scans(cv, seen, {"g1": (x, y)}, gen, errs, path="plonk cw=8")
    return {"ms": ms, "launches": launches, "scans": scans}


def phase_bls_fixtures(dev, gen, errs):
    """Phase 18: the stored bls12-381 fixtures on the card.  The PLONK proof
    of tiny_plonk_bls12381 equal to the stored JAX proof; Groth16
    setup_from_ptau of the 3-constraint chain from tiny_p4_bls12381.ptau
    byte-equal to tiny3_bls12381_from_ptau.zkey, a proof with it equal to
    the CPU prove's and passing the pairing check, a tampered public
    rejected; the bls12381_p3 ceremony chain (tests/_torch_ceremony.py)
    equal to the stored JAX run.  Counted; then K-field, K-scan and K-mm-norm
    held against their plain versions at every shape the phase gave them."""
    from tests import _torch_ceremony as tc

    cv = hc.BLS12_381
    fr = cv.fr
    steps = {}
    with recorded_shapes() as shapes, field_shapes() as fseen:
        reset_counts()
        steps["plonk_fixture"], _ = wall_ms(lambda: phase_plonk_fixture(
            dev, "tiny_plonk_bls12381"))
        r1cs, wit = plonk_circuit(fr, 3)
        with open(os.path.join(FIXTURES, "tiny_p4_bls12381.ptau"), "rb") as f:
            pt = ptau_fmt.read_ptau(f.read())
        with open(os.path.join(FIXTURES, "tiny3_bls12381_from_ptau.zkey"), "rb") as f:
            want = f.read()
        steps["groth16_setup_from_ptau"], zbytes = wall_ms(
            lambda: groth16_setup.setup_from_ptau(r1cs, pt, device=dev))
        check(zbytes == want, "bls12-381 setup_from_ptau differs from the stored JAX key")
        zk = read_groth16_zkey(zbytes)
        steps["groth16_prove"], (proof, publics) = wall_ms(
            lambda: groth16.prove(zk, wit, r=0x3131, s=0x4242, device=dev))
        cpu = groth16.prove(read_groth16_zkey(zbytes), wit, r=0x3131, s=0x4242, device="cpu")
        check(json.dumps([proof, publics]) == json.dumps(list(cpu)),
              "the bls12-381 Groth16 proof on the card differs from the CPU prove's")
        vk = groth16.export_verification_key(zk)
        check(groth16.verify(vk, publics, proof), "the bls12-381 Groth16 proof fails")
        bad = [str(int(publics[0]) + 1)] + publics[1:]
        check(not groth16.verify(vk, bad, proof), "tampered public accepted (bls12-381)")
        log(f"  bls12-381 setup_from_ptau == tiny3_bls12381_from_ptau.zkey; its proof == the "
            "CPU prove's, passes the pairing check, tampered public rejected")
        curve, power = tc.CASES["bls12381_p3"]
        steps["ceremony_chain"], (got, _) = wall_ms(lambda: tc.run_chain(
            ptau_ops, ptau_fmt, ChaCha, getattr(hc, curve), power, {"device": dev}))
        launches = counts()
    stored = tc.stored()["bls12381_p3"]
    check(got == {k: stored[k] for k in got},
          "the bls12381_p3 ceremony chain differs from the stored JAX run: " + json.dumps(
              {k: [got[k], stored.get(k)] for k in got if got[k] != stored.get(k)})[:2000])
    log(f"  bls12381_p3 ceremony chain (new, contribute, challenge / response, beacon, "
        f"prepare, verify, truncate, convert, json) == the stored JAX run; steps ms "
        f"{json.dumps({k: round(v, 1) for k, v in steps.items()})}")
    log(f"  launches {launches}; shapes: {shapes_json(shapes)}")
    check(launches["field_ops"] > 0 and launches["msm_scan"] > 0 and launches["digit_mm"] == 0,
          "the bls12-381 fixtures did not launch K-field and K-scan (or launched K-mm)")
    held = kernel_holds(dev, gen, errs, cv, shapes, fseen, "bls12-381 fixtures",
                        pt=pt)
    return dict(held, steps_ms=steps, launches=launches)


def fields_held(dev, gen, errs, fseen, path):
    """K-field at every (field, elements) of `fseen` against its plain
    version (but those held earlier)."""
    for fname in sorted({f for f, _ in fseen}):
        field_cases(dev, gen, errs, sorted(n for f, n in fseen if f == fname), path, fname)


def kernel_holds(dev, gen, errs, cv, shapes, fseen, path, pt=None):
    """K-field at every (field, elements) of `fseen`, K-scan (points from the
    .ptau `pt`, random scalars) and K-mm-norm on `cv`'s Fr at every shape of
    `shapes`, each against its plain version (but those held earlier)."""
    fields_held(dev, gen, errs, fseen, path)
    scans = []
    if pt is not None and shapes["msm_scan"]:
        n1, n2 = (1 << pt.power) - 1, 1 << pt.power
        sz1 = 2 * cv.fq.n8
        x1, y1, _ = pcodec.g1_lem_from_bytes(cv.fq, bytes(pt.sections[2][:n1 * sz1]), n1)
        x2, y2, _ = pcodec.g2_lem_from_bytes(cv.fq, bytes(pt.sections[3][:n2 * 2 * sz1]), n2)
        put = lambda a: tuple(put(c) for c in a) if isinstance(a, tuple) \
            else ftorch.to_tensor(a, dev)
        scans = ceremony_scans(cv, shapes["msm_scan"], {"g1": (put(x1), put(y1)),
                                                        "g2": (put(x2), put(y2))},
                               gen, errs, path=path)
    norms = norm_cases(dev, gen, shapes["digit_mm_norm"], path, errs, cv.fr.name)
    return {"scans": scans, "norms": norms, "field_sizes": len(fseen)}


def warm_median(prove, what):
    """WARM_BLS warm proves: median, spread and peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    ts = [wall_ms(prove)[0] for _ in range(WARM_BLS)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"median_ms": float(np.median(ts)), "min_ms": min(ts), "max_ms": max(ts),
           "peak_gib": peak}
    log(f"  {what}: {WARM_BLS} warm proves, median {out['median_ms']:.1f} ms, spread "
        f"{min(ts):.1f} .. {max(ts):.1f} ms, peak device memory {peak:.2f} GiB")
    return out


def phase_bls_groth16(dev, gen, errs, tables, bn_launches):
    """Phase 19: phase 5's 2^20 Groth16 prove and its checks on bls12-381,
    then K-field's times on bls12-381 Fr and Fq at (NL, 2^20), and each
    kernel against its plain version at every shape the counted prove gave
    it."""
    cv = hc.BLS12_381
    t_phase = time.perf_counter()
    zkey, wit, prove_ms, launches, shapes, fseen = phase_full_prove(dev, tables, cv)
    log(f"  K-field launches {launches['field_ops']} (bn128's counted prove: "
        f"{bn_launches['field_ops']}); by op {launches['field_by_op']}")
    check(launches["msm_scan"] == 5, "bls12-381 Groth16: expected 5 K-scan launches")
    times = {name: field_times(dev, gen, name)
             for name in ("bls12_381_fr", "bls12_381_fq")}
    ctx = ftorch.get_ctx(cv.fr.name)
    a_pts, _, b2_pts, _, h_pts = groth16._dev_points(zkey, dev)
    w = ftorch.to_tensor(wit.values, dev)
    p_odd = groth16.qap(ctx, zkey.domain_size, *qap_inputs(zkey, wit, dev))
    seen = shapes["msm_scan"]
    path = "bls12-381 groth16"
    scans = [scan_case(cv, group, pts, scal, seen, path, errs)
             for group, pts, scal in (("g1", a_pts, w), ("g1", h_pts, p_odd),
                                      ("g2", b2_pts, w))]
    check({tuple(e["shape"]) for e in scans} == set(seen),
          f"a K-scan shape of the bls12-381 Groth16 prove was not compared: {sorted(seen)}")
    del p_odd, w, a_pts, b2_pts, h_pts
    check(dict(shapes["digit_mm_norm"]) == {BIG: 12},
          f"the bls12-381 Groth16 prove's K-mm-norm shapes are not 12 x 1024^3: "
          f"{shapes['digit_mm_norm']}")
    held = kernel_holds(dev, gen, errs, cv, shapes, fseen, path)
    total = time.perf_counter() - t_phase
    log(f"  bls12-381 Groth16 phase total {total:.1f} s")
    return dict(held, scans=scans, ms=prove_ms, launches=launches, field_times=times,
                total_s=total)


def phase_bls_plonk(dev, gen, errs, tables, bn_launches):
    """Phase 20: phase 7's 2^18 PLONK prove and its checks on bls12-381, its
    warm time, then each kernel against its plain version at every shape
    the counted prove gave it."""
    cv = hc.BLS12_381
    t_phase = time.perf_counter()
    pk = phase_plonk_prove(dev, tables, cv)
    log(f"  K-field launches {pk['launches']['field_ops']} (bn128's counted prove: "
        f"{bn_launches['field_ops']}); by op {pk['launches']['field_by_op']}")
    warm = warm_median(lambda: plonk.prove(pk["zk"], pk["wit"], b=pk["b"], device=dev),
                       "bls12-381 PLONK 2^18")
    path = "bls12-381 plonk"
    scan, norms = phase_plonk_shapes(dev, gen, pk["zk"], pk.pop("pol_a"), pk["shapes"], errs,
                                     cv, path)
    fields_held(dev, gen, errs, pk["fields"], path)
    total = time.perf_counter() - t_phase
    log(f"  bls12-381 PLONK phase total {total:.1f} s")
    return {"scans": [scan], "norms": norms, "field_sizes": len(pk["fields"]), "ms": pk["ms"],
            "warm": warm, "counted_peak_gib": pk["peak_gib"], "launches": pk["launches"],
            "total_s": total}


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
    STASH["dir"] = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        return run()
    finally:
        shutil.rmtree(STASH["dir"], ignore_errors=True)


def run():
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
    rregs = {name: msm_gpu.reduce_attributes(*k) for k, name in SCAN_INSTANCES.items()}
    log(f"  K-reduce registers and local memory: {json.dumps(rregs)}")

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
    zkey, wit, prove_ms, launches, shapes, _ = phase_full_prove(dev, tables)
    log("[Groth16 main-path shapes and times]")
    entries = phase_main_shapes_and_times(dev, gen, zkey, wit, errs, shapes)
    del zkey, wit
    torch.cuda.empty_cache()
    log(f"[2^18 PLONK prove] ({time.perf_counter() - t0:.1f} s so far)")
    pk = phase_plonk_prove(dev, tables)
    plonk_ms, pl, pshapes = pk["ms"], pk["launches"], pk["shapes"]
    log("[PLONK main-path shapes and times]")
    pscan, pnorms = phase_plonk_shapes(dev, gen, pk["zk"], pk.pop("pol_a"), pshapes, errs)
    torch.cuda.empty_cache()
    log(f"[K-mm, held only] ({time.perf_counter() - t0:.1f} s so far)")
    mms = [mm_case(dev, gen, "digit_mm", (512, 512, 512), 0, "held only", errs)]
    log(f"[NTT stage split] ({time.perf_counter() - t0:.1f} s so far)")
    split = phase_ntt_split(dev, gen, errs)
    log(f"[Groth16 and PLONK setup from a .ptau] ({time.perf_counter() - t0:.1f} s so far)")
    setup = phase_setup(dev, gen, errs)
    sl = setup["launches"]
    entries["msm_scan"].append(setup.pop("scan"))
    ptau = setup.pop("ptau")
    g16_zkey, (chain_r1cs, chain_wit) = setup.pop("zkey"), setup.pop("chain")
    torch.cuda.empty_cache()
    log(f"[FFLONK at domain 2^18] ({time.perf_counter() - t0:.1f} s so far)")
    ff = phase_fflonk(dev, gen, errs, ptau)
    fl = ff["launches"]
    torch.cuda.empty_cache()
    log(f"[the powers-of-tau ceremony at power {SETUP_POWER}] "
        f"({time.perf_counter() - t0:.1f} s so far)")
    cer = phase_ceremony(dev, gen, errs, ptau)
    cl = cer["launches"]
    torch.cuda.empty_cache()
    log(f"[Groth16 phase 2 at domain 2^18] ({time.perf_counter() - t0:.1f} s so far)")
    mpc = phase_zkey_mpc(dev, gen, errs, ptau, g16_zkey, chain_r1cs, chain_wit)
    ml = mpc["launches"]
    torch.cuda.empty_cache()
    log(f"[the CLI and witness calculation at domain 2^18] "
        f"({time.perf_counter() - t0:.1f} s so far)")
    inprocess = {"groth16 setup": setup["steps_ms"]["groth16_setup_from_ptau"],
                 "groth16 prove": setup["steps_ms"]["groth16_prove"],
                 "plonk setup": setup["steps_ms"]["plonk_setup_from_ptau"],
                 "fflonk setup": ff["steps_ms"]["setup_from_ptau_2^16"]}
    clip = phase_cli(dev, gen, errs, ptau, g16_zkey, chain_r1cs, chain_wit, inprocess)
    del g16_zkey, chain_r1cs, chain_wit
    cli_l = clip["launches"]
    torch.cuda.empty_cache()
    log(f"[the multi-device path on one card] ({time.perf_counter() - t0:.1f} s so far)")
    mesh = phase_mesh(dev, gen, errs, ptau)
    del ptau
    log(f"[PLONK 2^18 with msm_c=4, msm_cw=8] ({time.perf_counter() - t0:.1f} s so far)")
    cw8 = phase_plonk_cw8(dev, gen, errs, pk)
    del pk
    torch.cuda.empty_cache()
    log(f"[bls12-381: the stored fixtures and the ceremony chain] "
        f"({time.perf_counter() - t0:.1f} s so far)")
    blsf = phase_bls_fixtures(dev, gen, errs)
    log(f"[bls12-381: the 2^20 Groth16 prove] ({time.perf_counter() - t0:.1f} s so far)")
    bls_tables = point_tables(hc.BLS12_381)
    blsg = phase_bls_groth16(dev, gen, errs, bls_tables, launches)
    torch.cuda.empty_cache()
    log(f"[bls12-381: the 2^18 PLONK prove] ({time.perf_counter() - t0:.1f} s so far)")
    blsp = phase_bls_plonk(dev, gen, errs, bls_tables, pl)
    torch.cuda.empty_cache()
    bls = {"fixtures": blsf, "groth16": blsg, "plonk": blsp}

    # `launches` is a kernel's count on a driven path: the PLONK prove's (0
    # for K-mm, which no route launches: held only); `launches_fflonk` the
    # FFLONK prove's, `launches_fflonk_setup` its setups', `launches_ceremony`
    # phase 13's (contribute, prepare_phase2, verify), `launches_phase2` phase
    # 14's (contribute, verify_from_init, export and import of the MPC
    # params), `launches_cli` phase 15's CLI steps, `launches_plonk_cw8` phase
    # 17's prove, `launches_bls12_381` phases 18-20's (the fixtures, the
    # Groth16 and the PLONK prove).  `ms`, `plain_ms` and
    # `bound_ms` belong to `shape`, the shape that path gave the kernel most
    # often.  `shapes` lists every shape the paths gave the kernel (K-field
    # has too many), each with its own launches, error, times and bound.
    mm_big = dict(entries["digit_mm"], path="held only", shape=list(BIG), launches=0,
                  max_abs_err=errs["digit_mm"])
    norm_big = dict(entries["digit_mm_norm"], path="plonk", shape=list(BIG),
                    launches=pshapes["digit_mm_norm"][BIG],
                    max_abs_err=errs["digit_mm_norm"])
    scans = ([pscan] + entries["msm_scan"] + ff["scans"] + cer["scans"] + mpc["scans"]
             + clip["scans"] + mesh["scans"] + cw8["scans"]
             + [e for ph in bls.values() for e in ph["scans"]])
    # K-reduce on each K-scan entry's output (an entry listed twice gives one)
    reduces = [r for r in (e.pop("reduce", None) for e in scans) if r]
    rows = [
        ("field_ops", "snarkjs_tpu_torch/csrc/field_ops.cu",
         "snarkjs_tpu/fields/fpal.py:449",
         dict(entries["field_ops"], shape=[16, 1 << 20]), []),
        ("msm_scan", "snarkjs_tpu_torch/csrc/msm_scan.cu",
         "snarkjs_tpu/curves/msm_tpu.py:213", pscan, scans),
        ("msm_reduce", "snarkjs_tpu_torch/csrc/msm_reduce.cu",
         "snarkjs_tpu/curves/msm_tpu.py:531", reduces[0], reduces),
        ("digit_mm", "snarkjs_tpu_torch/csrc/digit_mm.cu",
         "snarkjs_tpu/ntt/ntt_mxu.py:320", mm_big, [mm_big] + mms),
        ("digit_mm_norm", "snarkjs_tpu_torch/csrc/digit_mm_norm.cu",
         "snarkjs_tpu/ntt/ntt_mxu.py:457", norm_big,
         [norm_big] + pnorms + split["norms"] + ff["norms"] + cer["norms"] + mpc["norms"]
         + clip["norms"] + mesh["norms"] + [e for ph in bls.values() for e in ph["norms"]]),
    ]
    kernels = []
    for kname, src, replaces, first, every in rows:
        k = dict({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                  "library_ms": None}, **first)
        k.update(launches=pl[kname], max_abs_err=errs[kname],
                 launches_groth16=launches[kname], launches_plonk=pl[kname],
                 launches_setup=sum(c[kname] for c in sl.values()),
                 launches_setup_by_step={step: c[kname] for step, c in sl.items()},
                 launches_fflonk=fl["prove"][kname],
                 launches_fflonk_setup={step: c[kname] for step, c in fl.items()
                                        if step != "prove"},
                 launches_ceremony={step: c[kname] for step, c in cl.items()},
                 launches_phase2={step: c[kname] for step, c in ml.items()},
                 launches_cli={step: c[kname] for step, c in cli_l.items()},
                 launches_mesh={world: {step: [c[kname] for c in per_rank]
                                        for step, per_rank in steps.items()}
                                for world, steps in mesh["launches"].items()},
                 launches_plonk_cw8=cw8["launches"][kname],
                 launches_bls12_381={ph: v["launches"][kname] for ph, v in bls.items()},
                 shapes=every)
        check(k["launches"] > 0 or kname == "digit_mm",
              f"{kname} was launched on no driven path")
        check(kname == "digit_mm" or any(
            sum(v) for steps in k["launches_mesh"].values() for v in steps.values()),
            f"{kname} was launched on no step of the mesh path")
        kernels.append(k)
    # every MSM runs K-scan, then K-reduce: on every path, step and rank
    per = reduces[0]["launches"] // pscan["launches"]
    times = lambda v, f: ({key: times(x, f) for key, x in v.items()} if isinstance(v, dict)
                          else [times(x, f) for x in v] if isinstance(v, list) else v * f)
    for key in kernels[1]:
        if key.startswith("launches"):
            check(kernels[2][key] == times(kernels[1][key], per),
                  f"K-reduce's {key} is not {per} x K-scan's")
    kernels[0]["launches_by_op"] = pl["field_by_op"]
    kernels[0]["launches_by_op_groth16"] = launches["field_by_op"]
    kernels[0]["launches_by_op_fflonk"] = fl["prove"]["field_by_op"]
    kernels[0]["launches_by_op_ceremony"] = {step: c["field_by_op"] for step, c in cl.items()}
    kernels[0]["launches_by_op_phase2"] = {step: c["field_by_op"] for step, c in ml.items()}
    kernels[0]["launches_by_op_cli"] = {step: c["field_by_op"] for step, c in cli_l.items()}
    kernels[0]["launches_by_op_bls12_381"] = {ph: v["launches"]["field_by_op"]
                                              for ph, v in bls.items()}
    kernels[0]["bls12_381"] = blsg["field_times"]
    log(f"prove_2^20_warm_ms: {prove_ms}")
    log(f"plonk_prove_2^18_warm_ms: {plonk_ms}")
    log(f"NTT split: {json.dumps({k: v for k, v in split.items() if k != 'norms'})}")
    log(f"setup phase: {json.dumps(setup)}")
    log(f"fflonk phase: {json.dumps({k: v for k, v in ff.items() if k not in ('scans', 'norms')})}")
    log(f"ceremony phase: {json.dumps({k: v for k, v in cer.items() if k not in ('scans', 'norms')})}")
    log(f"phase 2: {json.dumps({k: v for k, v in mpc.items() if k not in ('scans', 'norms')})}")
    log(f"CLI phase: {json.dumps({k: v for k, v in clip.items() if k not in ('scans', 'norms')})}")
    log(f"mesh phase: {json.dumps({k: v for k, v in mesh.items() if k not in ('scans', 'norms')})}")
    log(f"PLONK msm_cw=8: {json.dumps({k: v for k, v in cw8.items() if k != 'scans'})}")
    for ph, res in bls.items():
        log(f"bls12-381 {ph}: " + json.dumps(
            {k: v for k, v in res.items() if k not in ("scans", "norms", "field_times")}))
    kernels[1]["registers"] = regs
    kernels[2]["registers"] = rregs
    log(f"K-scan registers, local memory and spills: {json.dumps(kernels[1]['registers'])}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
