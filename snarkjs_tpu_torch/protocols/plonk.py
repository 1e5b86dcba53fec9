"""PLONK prover and verifier (port of snarkjs_tpu/protocols/plonk.py;
reference src/plonk_prove.js / src/plonk_verify.js, eprint 2019/953).

Prover (5 rounds, reference :222-888), whole-array on the card by default:
  - additions + wire gathers: indexed gathers + Montgomery multiply (K-field)
  - grand product Z: elementwise num/den, batch inverse, log-depth prefix
    product scan (`ftorch.assoc_scan`)
  - quotient T: elementwise passes over the 4n domain (K-field) with the MulZ
    blinding-correction tables (reference src/mul_z.js) as tiled constants
  - iNTTs of n, NTTs and iNTTs of 4n: the digit-matmul NTT (K-mm-norm) from
    2^12 up
  - divZh: block cumsum; opening quotients Wxi/Wxiw: synthetic division as an
    affine-composition scan (poly/fops.py)
  - nine commitments: the suffix-scan MSM (K-scan) over the zkey's SRS, which
    is uploaded once per key and device.

The verifier is O(1) host work: Fiat-Shamir challenge recomputation
(Keccak256 transcript, reference src/Keccak256Transcript.js byte layout:
G1 commitments as big-endian uncompressed x||y, scalars as big-endian Fr),
Lagrange evaluations, the r0/D/F/E combination, and one pairing equation.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from .. import device as devmod
from .. import trace
from ..curves import host_curve as hc
from ..curves import msm as msm_mod
from ..fields import ftorch
from ..formats import wtns as wtns_fmt
from ..formats import zkey as zkey_fmt
from .groth16 import draw_once
from ..ntt import ntt as nttmod
from ..poly import fops
from ..utils.keccak import keccak256


class Transcript:
    """Keccak256 Fiat-Shamir transcript (reference src/Keccak256Transcript.js)."""

    def __init__(self, cv):
        self.cv = cv
        self.data = []

    def reset(self):
        self.data = []

    def add_poly(self, P):
        self.data.append(("g1", P))

    def add_scalar(self, s):
        self.data.append(("fr", s % self.cv.fr.p))

    def challenge(self) -> int:
        if not self.data:
            raise ValueError("no data to generate a transcript")
        fq, fr = self.cv.fq, self.cv.fr
        buf = b""
        for kind, v in self.data:
            if kind == "g1":
                if v is None:
                    buf += b"\0" * (2 * fq.n8)
                else:
                    buf += int(v[0]).to_bytes(fq.n8, "big")
                    buf += int(v[1]).to_bytes(fq.n8, "big")
            else:
                buf += int(v).to_bytes(fr.n8, "big")
        return int.from_bytes(keccak256(buf), "big") % fr.p


def _g1_from_obj(o):
    x, y, z = int(o[0]), int(o[1]), int(o[2])
    if z == 0:
        return None
    if z != 1:
        # projective: normalize (snarkjs always emits z=1 in JSON)
        raise ValueError("non-affine G1 object")
    return (x, y)


def _g2_from_obj(o):
    z = (int(o[2][0]), int(o[2][1]))
    if z == (0, 0):
        return None
    return ((int(o[0][0]), int(o[0][1])), (int(o[1][0]), int(o[1][1])))


def compute_challenges(cv, vk, publics, proof_pts, proof_evals):
    """Rounds 2-5 challenges (reference src/plonk_verify.js:208-273)."""
    fr = cv.fr
    t = Transcript(cv)
    for key in ("Qm", "Ql", "Qr", "Qo", "Qc", "S1", "S2", "S3"):
        t.add_poly(vk[key])
    for w in publics:
        t.add_scalar(w)
    t.add_poly(proof_pts["A"])
    t.add_poly(proof_pts["B"])
    t.add_poly(proof_pts["C"])
    ch = {}
    ch["beta"] = t.challenge()

    t.reset()
    t.add_scalar(ch["beta"])
    ch["gamma"] = t.challenge()

    t.reset()
    t.add_scalar(ch["beta"])
    t.add_scalar(ch["gamma"])
    t.add_poly(proof_pts["Z"])
    ch["alpha"] = t.challenge()

    t.reset()
    t.add_scalar(ch["alpha"])
    t.add_poly(proof_pts["T1"])
    t.add_poly(proof_pts["T2"])
    t.add_poly(proof_pts["T3"])
    ch["xi"] = t.challenge()

    t.reset()
    t.add_scalar(ch["xi"])
    for k in ("eval_a", "eval_b", "eval_c", "eval_s1", "eval_s2", "eval_zw"):
        t.add_scalar(proof_evals[k])
    v = [None] * 6
    v[1] = t.challenge()
    for i in range(2, 6):
        v[i] = v[i - 1] * v[1] % fr.p
    ch["v"] = v

    t.reset()
    t.add_poly(proof_pts["Wxi"])
    t.add_poly(proof_pts["Wxiw"])
    ch["u"] = t.challenge()
    return ch


def verify(vk_obj: dict, publics, proof_obj: dict, logger=None) -> bool:
    cv = hc.get_curve(vk_obj["curve"])
    fr = cv.fr
    p = fr.p

    publics = [int(x) for x in publics]
    if len(publics) != vk_obj["nPublic"]:
        return False
    if any(not (0 <= x < p) for x in publics):
        return False

    try:
        pts = {k: _g1_from_obj(proof_obj[k])
               for k in ("A", "B", "C", "Z", "T1", "T2", "T3", "Wxi", "Wxiw")}
        evals = {k: int(proof_obj[k]) for k in
                 ("eval_a", "eval_b", "eval_c", "eval_zw", "eval_s1", "eval_s2")}
        vk = {k: _g1_from_obj(vk_obj[k])
              for k in ("Qm", "Ql", "Qr", "Qo", "Qc", "S1", "S2", "S3")}
        vk["X_2"] = _g2_from_obj(vk_obj["X_2"])
        k1 = int(vk_obj["k1"])
        k2 = int(vk_obj["k2"])
        power = int(vk_obj["power"])
    except (KeyError, ValueError):
        return False

    for P in pts.values():
        if not hc.g1_is_on_curve(cv, P):
            return False
    if any(not (0 <= e < p) for e in evals.values()):
        return False

    ch = compute_challenges(cv, vk, publics, pts, evals)
    beta, gamma, alpha, xi, u, v = (ch["beta"], ch["gamma"], ch["alpha"],
                                    ch["xi"], ch["u"], ch["v"])

    # Lagrange evaluations L_1..L_max(1,nPublic) at xi
    n = 1 << power
    xin = pow(xi, n, p)
    zh = (xin - 1) % p
    w = 1
    L = [None]
    root = fr.w[power]
    for _ in range(max(1, len(publics))):
        L.append(w * zh % p * pow(n * (xi - w) % p, p - 2, p) % p)
        w = w * root % p

    pi = 0
    for i, x in enumerate(publics):
        pi = (pi - x * L[i + 1]) % p

    # r0
    e3a = (evals["eval_a"] + beta * evals["eval_s1"] + gamma) % p
    e3b = (evals["eval_b"] + beta * evals["eval_s2"] + gamma) % p
    e3c = (evals["eval_c"] + gamma) % p
    e3 = e3a * e3b % p * e3c % p * evals["eval_zw"] % p * alpha % p
    r0 = (pi - L[1] * alpha % p * alpha - e3) % p

    # D
    g1m, g1a, g1s = (lambda P, k: hc.g1_mul(cv, P, k)), \
                    (lambda P, Q: hc.g1_add(cv, P, Q)), \
                    (lambda P, Q: hc.g1_add(cv, P, hc.g1_neg(cv, Q)))
    d1 = g1m(vk["Qm"], evals["eval_a"] * evals["eval_b"] % p)
    d1 = g1a(d1, g1m(vk["Ql"], evals["eval_a"]))
    d1 = g1a(d1, g1m(vk["Qr"], evals["eval_b"]))
    d1 = g1a(d1, g1m(vk["Qo"], evals["eval_c"]))
    d1 = g1a(d1, vk["Qc"])

    betaxi = beta * xi % p
    d2a = ((evals["eval_a"] + betaxi + gamma)
           * (evals["eval_b"] + betaxi * k1 + gamma)
           * (evals["eval_c"] + betaxi * k2 + gamma)) % p * alpha % p
    d2b = L[1] * alpha % p * alpha % p
    d2 = g1m(pts["Z"], (d2a + d2b + u) % p)

    d3a = (evals["eval_a"] + beta * evals["eval_s1"] + gamma) % p
    d3b = (evals["eval_b"] + beta * evals["eval_s2"] + gamma) % p
    d3c = alpha * beta % p * evals["eval_zw"] % p
    d3 = g1m(vk["S3"], d3a * d3b % p * d3c % p)

    d4 = g1a(pts["T1"], g1a(g1m(pts["T2"], xin), g1m(pts["T3"], xin * xin % p)))
    d4 = g1m(d4, zh)

    D = g1s(g1s(g1a(d1, d2), d3), d4)

    F = g1a(D, g1m(pts["A"], v[1]))
    F = g1a(F, g1m(pts["B"], v[2]))
    F = g1a(F, g1m(pts["C"], v[3]))
    F = g1a(F, g1m(vk["S1"], v[4]))
    F = g1a(F, g1m(vk["S2"], v[5]))

    e = ((-r0) % p + v[1] * evals["eval_a"] + v[2] * evals["eval_b"]
         + v[3] * evals["eval_c"] + v[4] * evals["eval_s1"]
         + v[5] * evals["eval_s2"] + u * evals["eval_zw"]) % p
    E = g1m(cv.g1, e)

    A1 = g1a(pts["Wxi"], g1m(pts["Wxiw"], u))
    B1 = g1m(pts["Wxi"], xi)
    s = u * xi % p * fr.w[power] % p
    B1 = g1a(B1, g1m(pts["Wxiw"], s))
    B1 = g1a(B1, F)
    B1 = g1s(B1, E)

    return hc.pairing_eq(cv, [
        (hc.g1_neg(cv, A1), vk["X_2"]),
        (B1, cv.g2),
    ])


# =====================================================================
# Prover
# =====================================================================

def _g1_obj(P):
    if P is None:
        return ["0", "1", "0"]
    return [str(P[0]), str(P[1]), "1"]


def export_verification_key(zk: zkey_fmt.PlonkZkey) -> dict:
    return {
        "protocol": "plonk",
        "curve": zk.curve.name,
        "nPublic": zk.n_public,
        "power": zk.power,
        "k1": str(zk.k1),
        "k2": str(zk.k2),
        "Qm": _g1_obj(zk.qm), "Ql": _g1_obj(zk.ql), "Qr": _g1_obj(zk.qr),
        "Qo": _g1_obj(zk.qo), "Qc": _g1_obj(zk.qc),
        "S1": _g1_obj(zk.s1), "S2": _g1_obj(zk.s2), "S3": _g1_obj(zk.s3),
        "X_2": [[str(zk.x_2[0][0]), str(zk.x_2[0][1])],
                [str(zk.x_2[1][0]), str(zk.x_2[1][1])],
                ["1", "0"]],
        "w": str(zk.curve.fr.w[zk.power]),
    }


def _mulz_tables(fp):
    """Z1/Z2/Z3 correction constants (reference src/mul_z.js:21-47), plain."""
    p = fp.p
    w4 = fp.w[2]  # 4th root of unity
    z1 = [0, (-1 + w4) % p, -2 % p, (-1 - w4) % p]
    z2 = [0, (-2 * w4) % p, 4 % p, (2 * w4) % p]
    z3 = [0, (2 + 2 * w4) % p, -8 % p, (2 - 2 * w4) % p]
    return z1, z2, z3


def _dev_key(zk: zkey_fmt.PlonkZkey, dev, M: int, mesh=None) -> dict:
    """The key's polynomial sections, wire maps and the first M SRS points as
    tensors on `dev`, uploaded once per key and device; with `mesh` only
    this rank's block of the M points."""
    from .groth16 import _shard_key, point_block

    cache = zk.__dict__.setdefault("_dev_key", {})
    key = (str(dev), M, _shard_key(mesh))
    if key not in cache:
        up = lambda a: ftorch.to_tensor(a, dev)
        idx = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)
        ptx, pty, ptinf = zk.ptau
        d = {"ptau": point_block((ptx, pty, np.asarray(ptinf, dtype=bool)), M, mesh, dev),
             "lagrange": up(zk.lagrange),
             "a_map": idx(zk.a_map), "b_map": idx(zk.b_map), "c_map": idx(zk.c_map),
             "add_a": idx(zk.additions["a"]), "add_b": idx(zk.additions["b"]),
             "add_af": up(zk.additions["af"]), "add_bf": up(zk.additions["bf"])}
        for name in ("qm", "ql", "qr", "qo", "qc", "sigma1", "sigma2", "sigma3"):
            coefs, evals = getattr(zk, name + "_p4")
            d[name] = (up(coefs), up(evals))
        cache[key] = d
    return cache[key]


def prove(zk: zkey_fmt.PlonkZkey, witness: wtns_fmt.Witness, b=None,
          logger=None, device=None, mesh=None, msm_c: int = 8, msm_cw: int = 16):
    """Generate a PLONK proof: (proof JSON object, public signals).

    b: optional list of 12 blinding ints, b[1..11] used (tests); drawn with
    `secrets` when not given.  device: None means the card ("cuda"); raises
    without one.  mesh: a `parallel.distributed.prover_mesh`: the nine
    commitment MSMs run with the SRS points sharded over its ranks; b is
    drawn on rank 0, so every rank returns the same proof.  msm_c, msm_cw:
    the commitments' `MSMContext.run` c and cw (c is read by the legacy
    Pippenger only, so it does not change the proof)."""
    proof, publics, _ = _prove_rounds(zk, witness, b, logger, device, mesh,
                                      msm_c=msm_c, msm_cw=msm_cw)
    return proof, publics


def _prove_rounds(zk, witness, b, logger, device, mesh=None, msm_c: int = 8,
                  msm_cw: int = 16):
    """The five rounds of `prove`.  Returns (proof, publics, polys): polys
    holds the device tensors (Montgomery coefficients) of the blinded
    polynomials A, B, C, Z, the quotient parts T1, T2, T3 and the opening
    quotients Wxi, Wxiw, for checks of a proof against its polynomials.

    The root span `plonk.prove` of `trace` (recorded under the torch
    profiler): `plonk.witness`, then each round's polynomial work
    (`plonk.wires`, `plonk.perm`, `plonk.quotient`, `plonk.evals`,
    `plonk.open`) and after it the round's commitments, one `msm` span each
    (their children in `curves/msm_gpu.py`), and `prove.logger` at each
    logger line: "Round N: ..." before a round, "Multiexp X" before the
    commitment X."""
    dev = devmod.resolve(device)
    if witness.q != zk.curve.fr.p:
        raise ValueError("witness curve does not match proving key")
    if witness.n != zk.n_vars - zk.n_additions:
        raise ValueError("invalid witness length")

    def log(msg):
        if logger:
            with trace.span("prove.logger"):
                logger.debug(msg)

    with trace.root("plonk.prove", curve=zk.curve.name, domain=zk.domain_size):
        return _rounds(zk, witness, b, log, dev, mesh, msm_c, msm_cw)


def _rounds(zk, witness, b, log, dev, mesh, msm_c, msm_cw):
    cv = zk.curve
    fr = cv.fr
    p = fr.p
    ctx = ftorch.get_ctx(fr.name)
    n = zk.domain_size
    nl = fr.nl
    zeros = lambda k: torch.zeros((nl, k), dtype=ftorch.DTYPE, device=dev)
    mul = lambda a, bb: ftorch.mont_mul(ctx, a, bb)
    add = lambda a, bb: ftorch.add(ctx, a, bb)
    sub = lambda a, bb: ftorch.sub(ctx, a, bb)
    sc = lambda v: fops.scalar_arr(ctx, v, dev)

    # --- witness incl. additions (reference calculateAdditions :174-204) ---
    with trace.span("plonk.witness"):
        if b is None:
            b = draw_once(mesh, lambda: [secrets.randbelow(p) for _ in range(12)])  # b[1..11]
        bm = [None] + [sc(x) for x in b[1:12]]
        M = min(n + 6, zk.ptau[2].shape[0])
        key = _dev_key(zk, dev, M, mesh)
        wit = ftorch.to_tensor(witness.values, dev)
        wit[:, 0] = 0  # first element forced to zero (:96)
        if zk.n_additions:
            # an addition may reference an earlier one: a sequential loop
            buf = torch.cat([wit, zeros(zk.n_additions + 1)], dim=1)
            ia, ib = key["add_a"].tolist(), key["add_b"].tolist()
            af, bfac = key["add_af"], key["add_bf"]
            nw = witness.n
            for k in range(zk.n_additions):
                buf[:, nw + k] = add(mul(af[:, k], buf[:, ia[k]]),
                                     mul(bfac[:, k], buf[:, ib[k]]))
            full_wit = buf[:, :zk.n_vars]
        else:
            full_wit = wit
        publics = ftorch.np_to_ints(fr, full_wit[:, 1:zk.n_public + 1])

    fqctx = ftorch.get_ctx(cv.fq.name)
    g1m = msm_mod.MSMContext(fqctx, cv.fq, extension=1)
    dptx, dpty, dptinf = key["ptau"]

    def commit(name, coefs):
        # every commitment is padded to one length M (the longest, T3's n+6)
        log(f"Multiexp {name}")
        m = coefs.shape[1]
        with trace.span("msm", name=name, points=m):
            if m > M:
                raise ValueError(f"commitment degree {m} exceeds SRS length {M}")
            scal = fops.pad_to(ftorch.from_mont(ctx, coefs), M)
            res = g1m.run(dptx, dpty, dptinf, scal, c=msm_c, cw=msm_cw, mesh=mesh)
            return msm_mod.host_jac_to_affine(cv.fq, res, 1)

    def blind(pol, bs):
        # blindCoefficients: adds bs[i] at X^(n+i) and subtracts it at X^i
        # (reference polynomial.js:67-91)
        ext = torch.cat([pol, zeros(len(bs))], dim=1)
        for i, bb in enumerate(bs):
            ext[:, n + i] = add(ext[:, n + i], bb[:, 0])
            ext[:, i] = sub(ext[:, i], bb[:, 0])
        return ext

    # --- round 1: wire polynomials -------------------------------------
    log("Round 1: wire polynomials + commitments")
    with trace.span("plonk.wires"):
        def gather_wires(amap):
            # map arrays are nConstraints long; pad to the domain with zeros
            vals = torch.cat([full_wit[:, amap], zeros(n - amap.shape[0])], dim=1)
            return ftorch.to_mont(ctx, vals)

        buffA = gather_wires(key["a_map"])
        buffB = gather_wires(key["b_map"])
        buffC = gather_wires(key["c_map"])

        polA = nttmod.intt(ctx, buffA)
        polB = nttmod.intt(ctx, buffB)
        polC = nttmod.intt(ctx, buffC)
        evalA = nttmod.extend_evaluations(ctx, polA, 4)
        evalB = nttmod.extend_evaluations(ctx, polB, 4)
        evalC = nttmod.extend_evaluations(ctx, polC, 4)

        polA_b = blind(polA, (bm[2], bm[1]))
        polB_b = blind(polB, (bm[4], bm[3]))
        polC_b = blind(polC, (bm[6], bm[5]))

    commitA = commit("A", polA_b)
    commitB = commit("B", polB_b)
    commitC = commit("C", polC_b)

    # --- round 2: permutation grand product ----------------------------
    log("Round 2: permutation grand product Z")
    with trace.span("plonk.perm"):
        vk_pts = {"Qm": zk.qm, "Ql": zk.ql, "Qr": zk.qr, "Qo": zk.qo, "Qc": zk.qc,
                  "S1": zk.s1, "S2": zk.s2, "S3": zk.s3}
        t = Transcript(cv)
        for name in ("Qm", "Ql", "Qr", "Qo", "Qc", "S1", "S2", "S3"):
            t.add_poly(vk_pts[name])
        for w in publics:
            t.add_scalar(w)
        t.add_poly(commitA)
        t.add_poly(commitB)
        t.add_poly(commitC)
        beta = t.challenge()
        t.reset()
        t.add_scalar(beta)
        gamma = t.challenge()

        sig1c, sig1e = key["sigma1"]
        sig2c, sig2e = key["sigma2"]
        sig3c, sig3e = key["sigma3"]

        beta_m = sc(beta)
        gamma_m = sc(gamma)
        k1_m = sc(zk.k1)
        k2_m = sc(zk.k2)
        wpow = fops.powers_of(ctx, sc(fr.w[zk.power]), n)

        betaw = mul(beta_m, wpow)
        num = add(add(buffA, betaw), gamma_m)
        num = mul(num, add(add(buffB, mul(k1_m, betaw)), gamma_m))
        num = mul(num, add(add(buffC, mul(k2_m, betaw)), gamma_m))

        den = add(add(buffA, mul(sig1e[:, ::4], beta_m)), gamma_m)
        den = mul(den, add(add(buffB, mul(sig2e[:, ::4], beta_m)), gamma_m))
        den = mul(den, add(add(buffC, mul(sig3e[:, ::4], beta_m)), gamma_m))

        ratio = mul(num, ftorch.batch_inverse(ctx, den, axis=1))
        zprod = ftorch.assoc_scan(mul, ratio)
        buffZ = torch.cat([ctx.one((1,), dev), zprod[:, :-1]], dim=1)
        # copy-constraint check: full product must be 1 (reference :434-436)
        if ftorch.np_to_ints(fr, ftorch.from_mont(ctx, zprod[:, -1:].contiguous()))[0] != 1:
            raise RuntimeError("Copy constraints do not match")

        polZ = nttmod.intt(ctx, buffZ)
        evalZ = nttmod.extend_evaluations(ctx, polZ, 4)
        polZ_b = blind(polZ, (bm[9], bm[8], bm[7]))

    commitZ = commit("Z", polZ_b)

    # --- round 3: quotient ---------------------------------------------
    log("Round 3: quotient T1/T2/T3")
    with trace.span("plonk.quotient"):
        t.reset()
        t.add_scalar(beta)
        t.add_scalar(gamma)
        t.add_poly(commitZ)
        alpha = t.challenge()
        alpha_m = sc(alpha)
        alpha2_m = sc(alpha * alpha % p)

        qle = key["ql"][1]
        qre = key["qr"][1]
        qme = key["qm"][1]
        qoe = key["qo"][1]
        qce = key["qc"][1]

        n4 = 4 * n
        w4pow = fops.powers_of(ctx, sc(fr.w[zk.power + 2]), n4)
        zw4 = torch.roll(evalZ, -4, dims=1)

        # Lagrange evaluation blocks: zk.lagrange is nPublic x (n + 4n)
        lag_all = key["lagrange"]
        lag4 = [lag_all[:, i * 5 * n + n:(i + 1) * 5 * n] for i in range(zk.n_public)]
        lag1_4n = (lag4[0] if zk.n_public > 0
                   else nttmod.extend_evaluations(ctx, nttmod.intt(ctx, torch.cat(
                       [ctx.one((1,), dev), zeros(n - 1)], dim=1)), 4))

        ap = add(bm[2], mul(bm[1], w4pow))
        bp = add(bm[4], mul(bm[3], w4pow))
        cp = add(bm[6], mul(bm[5], w4pow))
        w2 = mul(w4pow, w4pow)
        zp = add(add(mul(bm[7], w2), mul(bm[8], w4pow)), bm[9])
        wW = mul(w4pow, sc(fr.w[zk.power]))
        wW2 = mul(wW, wW)
        zWp = add(add(mul(bm[7], wW2), mul(bm[8], wW)), bm[9])

        z1t, z2t, z3t = _mulz_tables(fr)
        tile = lambda tab: ftorch.to_tensor(ftorch.np_from_ints(
            fr, [fr.to_mont(x) for x in tab]), dev).repeat(1, n)
        Z1 = tile(z1t)
        Z2 = tile(z2t)
        Z3 = tile(z3t)

        def mulz2(a, bb, apx, bpx):
            a_b = mul(a, bb)
            a0 = add(mul(a, bpx), mul(apx, bb))
            a1 = mul(apx, bpx)
            rz = add(a0, mul(Z1, a1))
            return a_b, rz

        def mulz4(a, bb, c, d, apx, bpx, cpx, dpx):
            a_b = mul(a, bb)
            a_bp = mul(a, bpx)
            ap_b = mul(apx, bb)
            ap_bp = mul(apx, bpx)
            c_d = mul(c, d)
            c_dp = mul(c, dpx)
            cp_d = mul(cpx, d)
            cp_dp = mul(cpx, dpx)
            r = mul(a_b, c_d)
            a0 = add(add(mul(ap_b, c_d), mul(a_bp, c_d)),
                     add(mul(a_b, cp_d), mul(a_b, c_dp)))
            a1 = add(add(add(mul(ap_bp, c_d), mul(ap_b, cp_d)),
                         add(mul(ap_b, c_dp), mul(a_bp, cp_d))),
                     add(mul(a_bp, c_dp), mul(a_b, cp_dp)))
            a2 = add(add(mul(a_bp, cp_dp), mul(ap_b, cp_dp)),
                     add(mul(ap_bp, c_dp), mul(ap_bp, cp_d)))
            a3 = mul(ap_bp, cp_dp)
            rz = add(add(a0, mul(Z1, a1)), add(mul(Z2, a2), mul(Z3, a3)))
            return r, rz

        # PI evaluations over 4n
        pi4 = None
        for j in range(zk.n_public):
            term = mul(lag4[j], buffA[:, j:j + 1])
            pi4 = ftorch.neg(ctx, term) if pi4 is None else sub(pi4, term)
        if pi4 is None:
            pi4 = zeros(n4)

        e1, e1z = mulz2(evalA, evalB, ap, bp)
        e1 = mul(e1, qme)
        e1z = mul(e1z, qme)
        e1 = add(e1, mul(evalA, qle))
        e1z = add(e1z, mul(ap, qle))
        e1 = add(e1, mul(evalB, qre))
        e1z = add(e1z, mul(bp, qre))
        e1 = add(e1, mul(evalC, qoe))
        e1z = add(e1z, mul(cp, qoe))
        e1 = add(e1, pi4)
        e1 = add(e1, qce)

        betaw4 = mul(beta_m, w4pow)
        e2a = add(add(evalA, betaw4), gamma_m)
        e2b = add(add(evalB, mul(betaw4, k1_m)), gamma_m)
        e2c = add(add(evalC, mul(betaw4, k2_m)), gamma_m)
        e2, e2z = mulz4(e2a, e2b, e2c, evalZ, ap, bp, cp, zp)
        e2 = mul(e2, alpha_m)
        e2z = mul(e2z, alpha_m)

        e3a = add(add(evalA, mul(beta_m, sig1e)), gamma_m)
        e3b = add(add(evalB, mul(beta_m, sig2e)), gamma_m)
        e3c = add(add(evalC, mul(beta_m, sig3e)), gamma_m)
        e3, e3z = mulz4(e3a, e3b, e3c, zw4, ap, bp, cp, zWp)
        e3 = mul(e3, alpha_m)
        e3z = mul(e3z, alpha_m)

        e4 = mul(mul(sub(evalZ, ctx.one((1,), dev)), lag1_4n), alpha2_m)
        e4z = mul(mul(zp, lag1_4n), alpha2_m)

        tEv = add(sub(add(e1, e2), e3), e4)
        tzEv = add(sub(add(e1z, e2z), e3z), e4z)

        polT = nttmod.intt(ctx, tEv)
        polT = fops.div_zh(ctx, polT, n)
        polTz = nttmod.intt(ctx, tzEv)
        polT = add(polT, polTz)

        # split T into T1 (n+1), T2 (n+1), T3 (n+6) with the b10/b11 tweaks
        T1 = fops.pad_to(polT[:, :n], n + 1)
        T1[:, n] = bm[10][:, 0]
        T2 = fops.pad_to(polT[:, n:2 * n], n + 1)
        T2[:, 0] = sub(T2[:, 0], bm[10][:, 0])
        T2[:, n] = bm[11][:, 0]
        T3 = fops.pad_to(polT[:, 2 * n:], n + 6)
        T3[:, 0] = sub(T3[:, 0], bm[11][:, 0])

    commitT1 = commit("T1", T1)
    commitT2 = commit("T2", T2)
    commitT3 = commit("T3", T3)

    # --- round 4: evaluations ------------------------------------------
    log("Round 4: evaluations")
    with trace.span("plonk.evals"):
        t.reset()
        t.add_scalar(alpha)
        t.add_poly(commitT1)
        t.add_poly(commitT2)
        t.add_poly(commitT3)
        xi = t.challenge()
        xiw = xi * fr.w[zk.power] % p

        eval_a = fops.poly_eval(ctx, polA_b, xi)
        eval_b = fops.poly_eval(ctx, polB_b, xi)
        eval_c = fops.poly_eval(ctx, polC_b, xi)
        eval_s1 = fops.poly_eval(ctx, sig1c, xi)
        eval_s2 = fops.poly_eval(ctx, sig2c, xi)
        eval_zw = fops.poly_eval(ctx, polZ_b, xiw)

    # --- round 5: linearisation + openings ------------------------------
    log("Round 5: linearisation + openings")
    with trace.span("plonk.open"):
        t.reset()
        t.add_scalar(xi)
        for e in (eval_a, eval_b, eval_c, eval_s1, eval_s2, eval_zw):
            t.add_scalar(e)
        v1 = t.challenge()
        v = [None, v1]
        for i in range(2, 6):
            v.append(v[i - 1] * v1 % p)

        xin = pow(xi, n, p)
        zh = (xin - 1) % p
        eval_l1 = (xin - 1) * pow(n * (xi - 1) % p, p - 2, p) % p

        L = [None]
        wv = 1
        for i in range(1, max(1, zk.n_public) + 1):
            L.append(wv * zh % p * pow(n * (xi - wv) % p, p - 2, p) % p)
            wv = wv * fr.w[zk.power] % p
        eval_pi = 0
        for i, x in enumerate(publics):
            eval_pi = (eval_pi - x * L[i + 1]) % p

        coef_ab = eval_a * eval_b % p
        betaxi = beta * xi % p
        e2v = ((eval_a + betaxi + gamma) * (eval_b + betaxi * zk.k1 + gamma)
               * (eval_c + betaxi * zk.k2 + gamma)) % p * alpha % p
        e3v = ((eval_a + beta * eval_s1 + gamma)
               * (eval_b + beta * eval_s2 + gamma)) % p * eval_zw % p * alpha % p
        e4v = eval_l1 * alpha % p * alpha % p

        lenR = n + 6
        R = fops.add_many(ctx, [
            (key["qm"][0], sc(coef_ab)),
            (key["ql"][0], sc(eval_a)),
            (key["qr"][0], sc(eval_b)),
            (key["qo"][0], sc(eval_c)),
            (key["qc"][0], None),
            (polZ_b, sc((e2v + e4v) % p)),
        ], lenR)
        R = sub(R, mul(fops.pad_to(sig3c, lenR), sc(e3v * beta % p)))
        tmp = fops.add_many(ctx, [
            (T3, sc(xin * xin % p)),
            (T2, sc(xin)),
            (T1, None),
        ], lenR)
        R = sub(R, mul(tmp, sc(zh)))
        r0 = (eval_pi - e3v * (eval_c + gamma) - e4v) % p
        R[:, 0] = add(R[:, 0], sc(r0)[:, 0])

        Wxi = fops.add_many(ctx, [
            (R, None),
            (polA_b, sc(v[1])),
            (polB_b, sc(v[2])),
            (polC_b, sc(v[3])),
            (fops.pad_to(sig1c, lenR), sc(v[4])),
            (fops.pad_to(sig2c, lenR), sc(v[5])),
        ], lenR)
        sub_const = (v[1] * eval_a + v[2] * eval_b + v[3] * eval_c
                     + v[4] * eval_s1 + v[5] * eval_s2) % p
        Wxi[:, 0] = sub(Wxi[:, 0], sc(sub_const)[:, 0])
        Wxi_q, rem = fops.div_by_x_minus(ctx, Wxi, sc(xi))
        if ftorch.np_to_ints(fr, rem)[0] != 0:
            raise RuntimeError("Wxi polynomial is not divisible")

        Wxiw = fops.pad_to(polZ_b, n + 3).clone()
        Wxiw[:, 0] = sub(Wxiw[:, 0], sc(eval_zw)[:, 0])
        Wxiw_q, rem2 = fops.div_by_x_minus(ctx, Wxiw, sc(xiw))
        if ftorch.np_to_ints(fr, rem2)[0] != 0:
            raise RuntimeError("Wxiw polynomial is not divisible")

    commitWxi = commit("Wxi", Wxi_q)
    commitWxiw = commit("Wxiw", Wxiw_q)
    polys = dict(A=polA_b, B=polB_b, C=polC_b, Z=polZ_b, T1=T1, T2=T2, T3=T3,
                 Wxi=Wxi_q, Wxiw=Wxiw_q)

    proof = {
        "A": _g1_obj(commitA), "B": _g1_obj(commitB), "C": _g1_obj(commitC),
        "Z": _g1_obj(commitZ),
        "T1": _g1_obj(commitT1), "T2": _g1_obj(commitT2),
        "T3": _g1_obj(commitT3),
        "Wxi": _g1_obj(commitWxi), "Wxiw": _g1_obj(commitWxiw),
        "eval_a": str(eval_a), "eval_b": str(eval_b), "eval_c": str(eval_c),
        "eval_zw": str(eval_zw), "eval_s1": str(eval_s1),
        "eval_s2": str(eval_s2),
        "protocol": "plonk", "curve": cv.name,
    }
    return proof, [str(x) for x in publics], polys


def prove_files(zkey_path: str, wtns_path: str, **kw):
    zk = zkey_fmt.read_plonk_zkey(zkey_path)
    witness = wtns_fmt.read_wtns(wtns_path)
    return prove(zk, witness, **kw)


def export_solidity_calldata(proof: dict, publics) -> str:
    """reference src/plonk_exportsoliditycalldata.js:35-65."""
    def p256(n):
        return '"0x' + format(int(n), "064x") + '"'

    parts = []
    for key in ("A", "B", "C", "Z", "T1", "T2", "T3", "Wxi", "Wxiw"):
        parts += [p256(proof[key][0]), p256(proof[key][1])]
    for key in ("eval_a", "eval_b", "eval_c", "eval_s1", "eval_s2",
                "eval_zw"):
        parts.append(p256(proof[key]))
    inputs = ",".join(p256(x) for x in publics)
    return "[" + ",".join(parts) + "]" + f"[{inputs}]"
