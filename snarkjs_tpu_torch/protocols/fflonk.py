"""FFLONK prover and verifier (port of snarkjs_tpu/protocols/fflonk.py;
reference src/fflonk_prove.js / src/fflonk_verify.js, eprint 2021/1167).

Prover (5 rounds, reference fflonk_prove.js:319-1180), whole-array on the
card by default:
  round1  wire gathers + T0 over the 4n grid (K-field), iNTTs of n and 4n
          and `extend_evaluations` (K-mm-norm from 2^12) -> C1 = combine(A,
          B, C, T0) with degree stride 4 -> one MSM (K-scan)
  round2  grand product Z (batch inverse + log-depth prefix product), T1 on
          the 2n grid, T2 on the 4n grid -> C2 = combine(Z, T1, T2) stride 3
          -> one MSM
  round3  15 openings at xi / xi*w (`fops.poly_eval`)
  round4  R0/R1/R2 small Lagrange interpolations (host bigints) and
          F = (C0-R0)/(X^8-xi) + alpha (C1-R1)/(X^4-xi)
            + alpha^2 (C2-R2)/((X^3-xi)(X^3-xiw)), the zerofier divisions as
          per-residue affine scans -> one MSM (W1)
  round5  L = sum preL_i (Ci - ri(y)) - ZT(y) F, scaled by ZTS2(y)^-1,
          divided by (X-y) -> one MSM (W2)
plus the batched-inverse helper proof element "inv"
(fflonk_prove.js:1182-1285).  Every commitment is padded to the whole SRS
(9n + 18 points), which is uploaded once per key and device.

The verifier is O(1) host work and one pairing equation
(fflonk_verify.js:28-137).
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from .. import device as devmod
from ..curves import host_curve as hc
from ..curves import msm as msm_mod
from ..fields import ftorch
from ..formats import wtns as wtns_fmt
from ..formats import zkey as zkey_fmt
from .groth16 import draw_once
from ..ntt import ntt as nttmod
from ..poly import fops
from .fflonk_setup import combine_polys
from .plonk import Transcript, _g1_from_obj, _g1_obj, _g2_from_obj


def _poly_eval_host(fp, coefs_plain, x: int) -> int:
    acc = 0
    for c in reversed(coefs_plain):
        acc = (acc * x + c) % fp.p
    return acc


def export_verification_key(zk: zkey_fmt.FflonkZkey) -> dict:
    """reference src/zkey_export_verificationkey.js:127-148."""
    fr = zk.curve.fr
    return {
        "protocol": "fflonk",
        "curve": zk.curve.name,
        "nPublic": zk.n_public,
        "power": zk.power,
        "k1": str(zk.k1),
        "k2": str(zk.k2),
        "w": str(fr.w[zk.power]),
        "w3": str(zk.w3),
        "w4": str(zk.w4),
        "w8": str(zk.w8),
        "wr": str(zk.wr),
        "X_2": [[str(zk.x_2[0][0]), str(zk.x_2[0][1])],
                [str(zk.x_2[1][0]), str(zk.x_2[1][1])],
                ["1", "0"]],
        "C0": _g1_obj(zk.c0),
    }


# ---------------------------------------------------------------------------
# the challenge roots (prove round 3 == verify step 4)

def _derive_roots(fr, vk_roots, xi_seed: int):
    """(roots dict, xi) from xiSeed (fflonk_prove.js:843-900)."""
    p = fr.p
    w3, w4, w8, wr = vk_roots
    h0 = pow(xi_seed, 3, p)
    h0w8 = [h0 * pow(w8, i, p) % p for i in range(8)]
    h1 = h0 * h0 % p
    h1w4 = [h1 * pow(w4, i, p) % p for i in range(4)]
    h2 = h1 * xi_seed % p * xi_seed % p
    h2w3 = [h2 * pow(w3, i, p) % p for i in range(3)]
    h3 = h2 * wr % p
    h3w3 = [h3 * pow(w3, i, p) % p for i in range(3)]
    xi = pow(h2, 3, p)
    return {"h0w8": h0w8, "h1w4": h1w4, "h2w3": h2w3, "h3w3": h3w3}, xi


def _compute_li_si(fp, roots, x, xi):
    """computeLagrangeLiSi (fflonk_verify.js:558-574)."""
    p = fp.p
    ln = len(roots)
    num = (pow(x, ln, p) - xi) % p
    den1 = ln * pow(roots[0], ln - 2, p) % p
    out = []
    for i in range(ln):
        den2 = roots[(ln - 1) * i % ln]
        den3 = (x - roots[i]) % p
        out.append(num * pow(den1 * den2 % p * den3 % p, p - 2, p) % p)
    return out


def _compute_li_s2(fp, r0, r1, x, xi0, xi1):
    """computeLagrangeLiS2 (fflonk_verify.js:576-608)."""
    p = fp.p
    ln = len(r0)
    num = (pow(x, 2 * ln, p) - (xi0 + xi1) * pow(x, ln, p) + xi0 * xi1) % p
    out = []
    for rts, d in ((r0, xi0 - xi1), (r1, xi1 - xi0)):
        den1 = ln * rts[0] % p * (d % p) % p
        for i in range(ln):
            den = den1 * rts[(ln - 1) * i % ln] % p * ((x - rts[i]) % p) % p
            out.append(num * pow(den, p - 2, p) % p)
    return out


def _prod_y_minus(y, roots, p):
    out = 1
    for r in roots:
        out = out * ((y - r) % p) % p
    return out


# ---------------------------------------------------------------------------
# verifier

_EVAL_KEYS = ("ql", "qr", "qm", "qo", "qc", "s1", "s2", "s3",
              "a", "b", "c", "z", "zw", "t1w", "t2w")


def verify(vk_obj: dict, publics, proof_obj: dict, logger=None) -> bool:
    """reference src/fflonk_verify.js:28-137 (12-step check, one pairing)."""
    cv = hc.get_curve(vk_obj["curve"])
    fr = cv.fr
    p = fr.p

    publics = [int(x) for x in publics]
    if len(publics) != vk_obj["nPublic"]:
        return False
    if any(not (0 <= x < p) for x in publics):
        return False

    try:
        pts = {k: _g1_from_obj(proof_obj["polynomials"][k])
               for k in ("C1", "C2", "W1", "W2")}
        ev = {k: int(proof_obj["evaluations"][k]) for k in _EVAL_KEYS}
        c0 = _g1_from_obj(vk_obj["C0"])
        x_2 = _g2_from_obj(vk_obj["X_2"])
        k1, k2 = int(vk_obj["k1"]), int(vk_obj["k2"])
        power = int(vk_obj["power"])
        vk_roots = (int(vk_obj["w3"]), int(vk_obj["w4"]),
                    int(vk_obj["w8"]), int(vk_obj["wr"]))
    except (KeyError, ValueError):
        return False

    for P in list(pts.values()) + [c0]:
        if not hc.g1_is_on_curve(cv, P):
            return False
    if any(not (0 <= e < p) for e in ev.values()):
        return False

    n = 1 << power
    t = Transcript(cv)
    t.add_poly(c0)
    for w in publics:
        t.add_scalar(w)
    t.add_poly(pts["C1"])
    beta = t.challenge()
    t.reset()
    t.add_scalar(beta)
    gamma = t.challenge()
    t.reset()
    t.add_scalar(gamma)
    t.add_poly(pts["C2"])
    xi_seed = t.challenge()
    roots, xi = _derive_roots(fr, vk_roots, xi_seed)
    xiw = xi * fr.w[power] % p
    xin = pow(xi, n, p)

    t.reset()
    t.add_scalar(xi_seed)
    for k in _EVAL_KEYS:
        t.add_scalar(ev[k])
    alpha = t.challenge()
    t.reset()
    t.add_scalar(alpha)
    t.add_poly(pts["W1"])
    y = t.challenge()

    zh = (xin - 1) % p
    if zh == 0:
        return False
    invzh = pow(zh, p - 2, p)

    # Lagrange evaluations L_1..max(1, nPublic)
    L = [None]
    w = 1
    for _ in range(max(1, len(publics))):
        L.append(w * zh % p * pow(n * (xi - w) % p, p - 2, p) % p)
        w = w * fr.w[power] % p

    pi = 0
    for i, x in enumerate(publics):
        pi = (pi - x * L[i + 1]) % p

    # r0(y)
    li0 = _compute_li_si(fr, roots["h0w8"], y, xi)
    r0 = 0
    evs0 = [ev["ql"], ev["qr"], ev["qo"], ev["qm"], ev["qc"],
            ev["s1"], ev["s2"], ev["s3"]]
    for i in range(8):
        h = roots["h0w8"][i]
        c0v, hp = 0, 1
        for e in evs0:
            c0v = (c0v + e * hp) % p
            hp = hp * h % p
        r0 = (r0 + c0v * li0[i]) % p

    # r1(y)
    li1 = _compute_li_si(fr, roots["h1w4"], y, xi)
    t0v = (ev["ql"] * ev["a"] + ev["qr"] * ev["b"]
           + ev["qm"] * ev["a"] % p * ev["b"] + ev["qo"] * ev["c"]
           + ev["qc"] + pi) % p * invzh % p
    r1 = 0
    for i in range(4):
        h = roots["h1w4"][i]
        c1v = (ev["a"] + h * ev["b"] + h * h % p * ev["c"]
               + pow(h, 3, p) * t0v) % p
        r1 = (r1 + c1v * li1[i]) % p

    # r2(y)
    lis2 = _compute_li_s2(fr, roots["h2w3"], roots["h3w3"], y, xi, xiw)
    t1v = (ev["z"] - 1) * L[1] % p * invzh % p
    betaxi = beta * xi % p
    t21 = ((ev["a"] + betaxi + gamma) * (ev["b"] + betaxi * k1 + gamma)
           % p * ((ev["c"] + betaxi * k2 + gamma) * ev["z"] % p)) % p
    t22 = ((ev["a"] + beta * ev["s1"] + gamma)
           * (ev["b"] + beta * ev["s2"] + gamma)
           % p * ((ev["c"] + beta * ev["s3"] + gamma) * ev["zw"] % p)) % p
    t2v = (t21 - t22) % p * invzh % p
    r2 = 0
    for i in range(3):
        h = roots["h2w3"][i]
        c2v = (ev["z"] + h * t1v + h * h % p * t2v) % p
        r2 = (r2 + c2v * lis2[i]) % p
    for i in range(3):
        h = roots["h3w3"][i]
        c2v = (ev["zw"] + h * ev["t1w"] + h * h % p * ev["t2w"]) % p
        r2 = (r2 + c2v * lis2[i + 3]) % p

    # F, E, J and the pairing
    mul_h0 = _prod_y_minus(y, roots["h0w8"], p)
    mul_h1 = _prod_y_minus(y, roots["h1w4"], p)
    mul_h2 = _prod_y_minus(y, roots["h2w3"] + roots["h3w3"], p)
    quo1 = alpha * mul_h0 % p * pow(mul_h1, p - 2, p) % p
    quo2 = alpha * alpha % p * mul_h0 % p * pow(mul_h2, p - 2, p) % p

    F = hc.g1_add(cv, c0, hc.g1_add(cv, hc.g1_mul(cv, pts["C1"], quo1),
                                    hc.g1_mul(cv, pts["C2"], quo2)))
    E = hc.g1_mul(cv, cv.g1, (r0 + r1 * quo1 + r2 * quo2) % p)
    J = hc.g1_mul(cv, pts["W1"], mul_h0)

    A1 = hc.g1_mul(cv, pts["W2"], y)
    A1 = hc.g1_add(cv, hc.g1_add(
        cv, hc.g1_add(cv, F, hc.g1_neg(cv, E)), hc.g1_neg(cv, J)), A1)

    return hc.pairing_eq(cv, [
        (hc.g1_neg(cv, A1), cv.g2),
        (pts["W2"], x_2),
    ])


# ---------------------------------------------------------------------------
# prover

def _dev_key(zk: zkey_fmt.FflonkZkey, dev, mesh=None) -> dict:
    """The key's polynomial sections, wire maps, additions, C0 coefficients
    and whole SRS as tensors on `dev`, uploaded once per key and device;
    with `mesh` only this rank's block of the SRS."""
    from .groth16 import _shard_key, point_block

    cache = zk.__dict__.setdefault("_dev_key", {})
    key = (str(dev), _shard_key(mesh))
    if key not in cache:
        up = lambda a: ftorch.to_tensor(a, dev)
        idx = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)
        ptx, pty, ptinf = zk.ptau
        ptinf = np.asarray(ptinf, dtype=bool)
        d = {"ptau": point_block((ptx, pty, ptinf), ptinf.shape[0], mesh, dev),
             "n_srs": ptinf.shape[0],
             "lagrange": up(zk.lagrange), "c0": up(zk.c0_coefs),
             "a_map": idx(zk.a_map), "b_map": idx(zk.b_map), "c_map": idx(zk.c_map),
             "add_a": idx(zk.additions["a"]), "add_b": idx(zk.additions["b"]),
             "add_af": up(zk.additions["af"]), "add_bf": up(zk.additions["bf"])}
        for name in ("ql", "qr", "qm", "qo", "qc", "sigma1", "sigma2", "sigma3"):
            coefs, evals = getattr(zk, name + "_p4")
            d[name] = (up(coefs), up(evals))
        cache[key] = d
    return cache[key]


def prove(zk: zkey_fmt.FflonkZkey, witness: wtns_fmt.Witness, b=None,
          logger=None, device=None, msm_c: int = 8, msm_cw: int = 16, mesh=None):
    """Generate an FFLONK proof: (proof JSON object, public signals).

    b: optional list of 10 blinding ints, b[1..9] used (tests); drawn with
    `secrets` when not given.  device: None means the card ("cuda"); raises
    without one.  msm_cw: the commitments' window width (16 on the card for
    large inputs; `MSMContext.run` takes 8 below 2^14 points and off it).
    msm_c: `MSMContext.run`'s c, read by the legacy Pippenger only, so it
    does not change the proof.
    mesh: a `parallel.distributed.prover_mesh`: the four commitment MSMs
    run with the SRS sharded over its ranks; b is drawn on rank 0, so every
    rank returns the same proof."""
    dev = devmod.resolve(device)
    cv = zk.curve
    fr = cv.fr
    p = fr.p
    ctx = ftorch.get_ctx(fr.name)
    n = zk.domain_size
    nl = fr.nl
    log = logger.debug if logger else (lambda msg: None)

    if witness.q != p:
        raise ValueError("Curve of the witness does not match the curve of "
                         "the proving key")
    if witness.n != zk.n_vars - zk.n_additions:
        raise ValueError("Invalid witness length")

    if b is None:
        b = draw_once(mesh, lambda: [secrets.randbelow(p) for _ in range(10)])  # b[1..9]
    sc = lambda v: fops.scalar_arr(ctx, v, dev)
    bm = [None] + [sc(x) for x in b[1:10]]
    zeros = lambda k: torch.zeros((nl, k), dtype=ftorch.DTYPE, device=dev)
    mul = lambda a, bb: ftorch.mont_mul(ctx, a, bb)
    add = lambda a, bb: ftorch.add(ctx, a, bb)
    sub = lambda a, bb: ftorch.sub(ctx, a, bb)
    one = ctx.one((1,), dev)
    key = _dev_key(zk, dev, mesh)

    # --- witness incl. additions (fflonk_prove.js:261-293) ----------------
    wit = ftorch.to_tensor(witness.values, dev)
    wit[:, 0] = 0
    if zk.n_additions:
        # an addition may read an earlier one's output: a sequential loop
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

    # --- round 1 -----------------------------------------------------------
    log("Round 1: wires + T0 -> C1")

    def gather_wires(amap, b_lo, b_hi):
        # map arrays are nConstraints long; pad to the domain with zeros; the
        # blinding rows n-2, n-1 hold plain b values (fflonk_prove.js:376-381)
        vals = torch.cat([full_wit[:, amap], zeros(n - amap.shape[0])], dim=1)
        vals[:, n - 2:] = ftorch.to_tensor(ftorch.np_from_ints(fr, [b_lo, b_hi]), dev)
        return ftorch.to_mont(ctx, vals)

    buffA = gather_wires(key["a_map"], b[1], b[2])
    buffB = gather_wires(key["b_map"], b[3], b[4])
    buffC = gather_wires(key["c_map"], b[5], b[6])

    polA = nttmod.intt(ctx, buffA)
    polB = nttmod.intt(ctx, buffB)
    polC = nttmod.intt(ctx, buffC)
    evalA = nttmod.extend_evaluations(ctx, polA, 4)
    evalB = nttmod.extend_evaluations(ctx, polB, 4)
    evalC = nttmod.extend_evaluations(ctx, polC, 4)

    qle, qre, qme = key["ql"][1], key["qr"][1], key["qm"][1]
    qoe, qce = key["qo"][1], key["qc"][1]

    lag4 = [key["lagrange"][:, j * 5 * n + n:(j + 1) * 5 * n]
            for j in range(max(1, zk.n_public))]

    pi4 = None
    for j in range(zk.n_public):
        term = mul(lag4[j], buffA[:, j:j + 1])
        pi4 = ftorch.neg(ctx, term) if pi4 is None else sub(pi4, term)
    if pi4 is None:
        pi4 = zeros(4 * n)

    t0 = add(add(mul(evalA, qle), mul(evalB, qre)),
             add(mul(mul(evalA, evalB), qme), mul(evalC, qoe)))
    t0 = add(t0, add(qce, pi4))
    polT0 = fops.div_by_zerofier(ctx, nttmod.intt(ctx, t0), n, 1)[:, :2 * n]

    # C1 = combine(A, B, C, T0) stride 4 (each padded to 2n: 8n coefficients)
    polC1 = combine_polys(ctx, [fops.pad_to(polA, 2 * n), fops.pad_to(polB, 2 * n),
                                fops.pad_to(polC, 2 * n), polT0], 4)

    g1m = msm_mod.MSMContext(ftorch.get_ctx(cv.fq.name), cv.fq, extension=1)
    dptx, dpty, dptinf = key["ptau"]
    M = key["n_srs"]

    def commit(coefs):
        # every commitment is padded to the whole SRS: one MSM shape for all
        m = coefs.shape[1]
        if m > M:
            raise ValueError(f"commitment degree {m} exceeds SRS length {M}")
        scal = fops.pad_to(ftorch.from_mont(ctx, coefs), M)
        res = g1m.run(dptx, dpty, dptinf, scal, c=msm_c, cw=msm_cw, mesh=mesh)
        return msm_mod.host_jac_to_affine(cv.fq, res, 1)

    commitC1 = commit(polC1)

    # --- round 2 -----------------------------------------------------------
    log("Round 2: Z + T1/T2 -> C2")
    t = Transcript(cv)
    t.add_poly(zk.c0)
    for w in publics:
        t.add_scalar(w)
    t.add_poly(commitC1)
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
    buffZ = torch.cat([one, zprod[:, :-1]], dim=1)
    # copy-constraint check: the full product must be 1
    if ftorch.np_to_ints(fr, ftorch.from_mont(ctx, zprod[:, -1:].contiguous()))[0] != 1:
        raise RuntimeError("Copy constraints does not match")

    polZ = nttmod.intt(ctx, buffZ)
    evalZ = nttmod.extend_evaluations(ctx, polZ, 4)
    # blindCoefficients([b9, b8, b7])
    polZ_b = torch.cat([polZ, zeros(3)], dim=1)
    for i, bb in enumerate((bm[9], bm[8], bm[7])):
        polZ_b[:, n + i] = add(polZ_b[:, n + i], bb[:, 0])
        polZ_b[:, i] = sub(polZ_b[:, i], bb[:, 0])

    # T1 on the 2n grid (fflonk_prove.js:652-718)
    w2pow = fops.powers_of(ctx, sc(fr.w[zk.power + 1]), 2 * n)
    w2sq = mul(w2pow, w2pow)
    zp2 = add(add(mul(bm[7], w2sq), mul(bm[8], w2pow)), bm[9])
    lag1 = lag4[0]
    z2 = evalZ[:, ::2]
    t1 = mul(sub(z2, one), lag1[:, ::2])
    t1z = mul(zp2, lag1[:, ::2])
    polT1 = fops.div_by_zerofier(ctx, nttmod.intt(ctx, t1), n, 1)
    polT1 = add(fops.pad_to(polT1, 2 * n), nttmod.intt(ctx, t1z))[:, :n + 2]

    # T2 on the 4n grid (fflonk_prove.js:720-816)
    w4pow = fops.powers_of(ctx, sc(fr.w[zk.power + 2]), 4 * n)
    w4sq = mul(w4pow, w4pow)
    zp4 = add(add(mul(bm[7], w4sq), mul(bm[8], w4pow)), bm[9])
    wW = mul(w4pow, sc(fr.w[zk.power]))
    wW2 = mul(wW, wW)
    zWp4 = add(add(mul(bm[7], wW2), mul(bm[8], wW)), bm[9])
    zW4 = torch.roll(evalZ, -4, dims=1)

    betaX = mul(beta_m, w4pow)
    e11 = add(add(evalA, betaX), gamma_m)
    e12 = add(add(evalB, mul(betaX, k1_m)), gamma_m)
    e13 = add(add(evalC, mul(betaX, k2_m)), gamma_m)
    e1base = mul(mul(e11, e12), e13)
    e21 = add(add(evalA, mul(beta_m, sig1e)), gamma_m)
    e22 = add(add(evalB, mul(beta_m, sig2e)), gamma_m)
    e23 = add(add(evalC, mul(beta_m, sig3e)), gamma_m)
    e2base = mul(mul(e21, e22), e23)
    t2 = sub(mul(e1base, evalZ), mul(e2base, zW4))
    t2z = sub(mul(e1base, zp4), mul(e2base, zWp4))
    polT2 = fops.div_by_zerofier(ctx, nttmod.intt(ctx, t2), n, 1)
    polT2 = add(polT2, nttmod.intt(ctx, t2z))[:, :3 * n]

    polC2 = combine_polys(ctx, [fops.pad_to(polZ_b, 3 * n),
                                fops.pad_to(polT1, 3 * n), polT2], 3)
    commitC2 = commit(polC2)

    # --- round 3: openings -------------------------------------------------
    log("Round 3: openings")
    t.reset()
    t.add_scalar(gamma)
    t.add_poly(commitC2)
    xi_seed = t.challenge()
    roots, xi = _derive_roots(fr, (zk.w3, zk.w4, zk.w8, zk.wr), xi_seed)
    xiw = xi * fr.w[zk.power] % p

    at_xi = {"ql": key["ql"][0], "qr": key["qr"][0], "qm": key["qm"][0],
             "qo": key["qo"][0], "qc": key["qc"][0], "s1": sig1c, "s2": sig2c,
             "s3": sig3c, "a": polA, "b": polB, "c": polC, "z": polZ_b}
    ev = {k: fops.poly_eval(ctx, pol, xi) for k, pol in at_xi.items()}
    ev["zw"] = fops.poly_eval(ctx, polZ_b, xiw)
    ev["t1w"] = fops.poly_eval(ctx, polT1, xiw)
    ev["t2w"] = fops.poly_eval(ctx, polT2, xiw)

    # --- round 4: F = sum (Ci - Ri) / zerofiers -----------------------------
    log("Round 4: F -> W1")
    t.reset()
    t.add_scalar(xi_seed)
    for k in _EVAL_KEYS:
        t.add_scalar(ev[k])
    alpha = t.challenge()

    polC0 = key["c0"]

    def interp_r(poly, rts):
        ys = [fops.poly_eval(ctx, poly, r) for r in rts]
        return fops.lagrange_interp_host(fr, rts, ys)

    r0_coefs = interp_r(polC0, roots["h0w8"])
    r1_coefs = interp_r(polC1, roots["h1w4"])
    r2_coefs = interp_r(polC2, roots["h2w3"] + roots["h3w3"])

    L = 9 * n

    def sub_coefs(poly, coefs_plain, length):
        out = fops.pad_to(poly, length).clone()
        k = len(coefs_plain)
        arr = ftorch.to_tensor(ftorch.np_from_ints(
            fr, [fr.to_mont(c) for c in coefs_plain]), dev)
        out[:, :k] = sub(out[:, :k].contiguous(), arr)
        return out

    f0 = fops.div_by_zerofier(ctx, sub_coefs(polC0, r0_coefs, L), 8, xi)
    f1 = fops.div_by_zerofier(ctx, sub_coefs(polC1, r1_coefs, L), 4, xi)
    f1 = mul(f1, sc(alpha))
    f2 = fops.div_by_zerofier(ctx, sub_coefs(polC2, r2_coefs, L), 3, xi)
    f2 = fops.div_by_zerofier(ctx, f2, 3, xiw)
    f2 = mul(f2, sc(alpha * alpha % p))
    polF = add(add(f0, f1), f2)
    commitW1 = commit(polF)

    # --- round 5: L / (ZTS2(y) (X - y)) -------------------------------------
    log("Round 5: L -> W2")
    t.reset()
    t.add_scalar(alpha)
    t.add_poly(commitW1)
    y = t.challenge()

    r0y = _poly_eval_host(fr, r0_coefs, y)
    r1y = _poly_eval_host(fr, r1_coefs, y)
    r2y = _poly_eval_host(fr, r2_coefs, y)

    mul_h0 = _prod_y_minus(y, roots["h0w8"], p)
    mul_h1 = _prod_y_minus(y, roots["h1w4"], p)
    mul_h2 = _prod_y_minus(y, roots["h2w3"] + roots["h3w3"], p)
    toinv = {"denH1": mul_h1, "denH2": mul_h2}

    pre0 = mul_h1 * mul_h2 % p
    pre1 = alpha * mul_h0 % p * mul_h2 % p
    pre2 = alpha * alpha % p * mul_h0 % p * mul_h1 % p

    def shift_scale(poly, ry, pre, length):
        out = fops.pad_to(poly, length).clone()
        out[:, 0] = sub(out[:, 0], sc(ry)[:, 0])
        return mul(out, sc(pre))

    polL = add(add(shift_scale(polC0, r0y, pre0, L),
                   shift_scale(polC1, r1y, pre1, L)),
               shift_scale(polC2, r2y, pre2, L))

    zt_coefs = fops.zerofier_host(
        fr, roots["h0w8"] + roots["h1w4"] + roots["h2w3"] + roots["h3w3"])
    zty = _poly_eval_host(fr, zt_coefs, y)
    polL = sub(polL, mul(fops.pad_to(polF, L), sc(zty)))

    zts2_coefs = fops.zerofier_host(fr, roots["h1w4"] + roots["h2w3"] + roots["h3w3"])
    zts2y = _poly_eval_host(fr, zts2_coefs, y)
    polL = mul(polL, sc(pow(zts2y, p - 2, p)))

    polW2, rem = fops.div_by_x_minus(ctx, polL, sc(y))
    if ftorch.np_to_ints(fr, rem)[0] != 0:
        raise RuntimeError("Degree of L(X)/(ZTS2(y)(X-y)) remainder is not 0")
    commitW2 = commit(polW2)

    # --- "inv", the batched-inverse proof element ---------------------------
    toinv["zh"] = (pow(xi, n, p) - 1) % p
    for nm, rts in (("LiS0", roots["h0w8"]), ("LiS1", roots["h1w4"])):
        ln = len(rts)
        den1 = ln * pow(rts[0], ln - 2, p) % p
        for i in range(ln):
            toinv[f"{nm}_{i + 1}"] = (den1 * rts[(ln - 1) * i % ln]
                                      % p * ((y - rts[i]) % p) % p)
    for off, rts, d in ((1, roots["h2w3"], xi - xiw), (4, roots["h3w3"], xiw - xi)):
        den1 = 3 * rts[0] % p * (d % p) % p
        for i in range(3):
            toinv[f"LiS2_{i + off}"] = (den1 * rts[2 * i % 3]
                                        % p * ((y - rts[i]) % p) % p)
    w = 1
    for i in range(max(1, zk.n_public)):
        toinv[f"Li_{i + 1}"] = n * ((xi - w) % p) % p
        w = w * fr.w[zk.power] % p
    acc = 1
    for v in toinv.values():
        acc = acc * v % p
    inv = pow(acc, p - 2, p)

    proof = {
        "polynomials": {
            "C1": _g1_obj(commitC1), "C2": _g1_obj(commitC2),
            "W1": _g1_obj(commitW1), "W2": _g1_obj(commitW2),
        },
        "evaluations": {**{k: str(ev[k]) for k in _EVAL_KEYS}, "inv": str(inv)},
        "protocol": "fflonk",
        "curve": cv.name,
    }
    return proof, [str(x) for x in publics]


def prove_files(zkey_path: str, wtns_path: str, **kw):
    zk = zkey_fmt.read_fflonk_zkey(zkey_path)
    witness = wtns_fmt.read_wtns(wtns_path)
    return prove(zk, witness, **kw)


def export_solidity_calldata(proof: dict, publics) -> str:
    """reference src/fflonk_export_calldata.js:36-61."""
    def p256(n):
        return format(int(n), "064x")

    pols = proof["polynomials"]
    evs = proof["evaluations"]
    vals = []
    for key in ("C1", "C2", "W1", "W2"):
        vals += [p256(pols[key][0]), p256(pols[key][1])]
    for key in _EVAL_KEYS + ("inv",):
        vals.append(p256(evs[key]))
    proof_hex = "0x" + "".join(vals)
    pub_hex = "[" + ",".join('"0x' + p256(x) + '"' for x in publics) + "]"
    if len(publics):
        return f'["{proof_hex}"],{pub_hex}'
    return f'["{proof_hex}"]'
