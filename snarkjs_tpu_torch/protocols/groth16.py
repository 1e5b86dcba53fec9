"""Groth16 prover / verifier (port of snarkjs_tpu/protocols/groth16.py;
reference src/groth16_prove.js, src/groth16_verify.js).

Prover pipeline, on the card by default:

  1. buildABC: gather the witness per coefficient, Montgomery-multiply
     (K-field), sum per constraint with an exact int64 `index_add_` over
     limbs, one wide reduction back to [0, p).
  2. QAP: intt -> coset shift -> ntt for each of A, B, C (K-mm at 2^12 and
     up, K-field below); P_odd = A_odd*B_odd - C_odd in plain form.
  3. Five MSMs (A, B1, B2, C, H) on the suffix-scan engine (K-scan + K-field).
  4. Blinding with r, s and the affine conversions on host bigints.
"""

from __future__ import annotations

import secrets

import torch

from .. import device as devmod
from ..curves import host_curve as hc
from ..curves import msm as msm_mod
from ..fields import ftorch
from ..formats import wtns as wtns_fmt
from ..formats import zkey as zkey_fmt
from ..ntt import ntt as nttmod


def reduce_wide(ctx, limbs, carry):
    """(carry * R + limbs) mod p for limbs < R, carry < 2^16."""
    lo_mod = ftorch.from_mont(ctx, ftorch.to_mont(ctx, limbs))
    carry_elem = torch.zeros_like(limbs)
    carry_elem[0] = carry.to(limbs.dtype)
    hi_mod = ftorch.to_mont(ctx, carry_elem)  # carry * R mod p
    return ftorch.add(ctx, hi_mod, lo_mod)


def _segment_field_sum(ctx, values, ids, num_segments):
    """Sum field elements by segment id (== num_segments drops the entry).

    Limb-wise int64 sums are exact; one wide reduction maps back to [0, p)."""
    sums = torch.zeros((num_segments + 1, ctx.nl), dtype=torch.int64,
                       device=values.device)
    sums.index_add_(0, ids, values.T.to(torch.int64))
    limbs, carry = ftorch._carry_prop(sums[:num_segments].T)
    return reduce_wide(ctx, limbs.to(ftorch.DTYPE), carry)


def qap(ctx, domain_size, coef_val, coef_m, coef_c, coef_s, witness):
    """buildABC + the six QAP NTTs -> plain-form P_odd (NL, domain)."""
    fp = ctx.fp
    k = domain_size.bit_length() - 1
    inc = fp.w[k + 1] if k < fp.s else fp.shift
    prod = ftorch.mont_mul(ctx, coef_val, witness[:, coef_s])
    drop = torch.full_like(coef_c, domain_size)
    A_T = _segment_field_sum(ctx, prod, torch.where(coef_m == 0, coef_c, drop),
                             domain_size)
    B_T = _segment_field_sum(ctx, prod, torch.where(coef_m == 1, coef_c, drop),
                             domain_size)
    C_T = ftorch.mont_mul(ctx, A_T, B_T)

    def odd_evals(X):
        coeffs = nttmod.intt(ctx, X)
        return nttmod.ntt(ctx, nttmod.apply_powers(ctx, coeffs, 1, inc))

    Ao, Bo, Co = odd_evals(A_T), odd_evals(B_T), odd_evals(C_T)
    P = ftorch.sub(ctx, ftorch.mont_mul(ctx, Ao, Bo), Co)
    return ftorch.from_mont(ctx, P)


def _dev_points(zkey, dev):
    """The zkey's MSM bases as device tensors, uploaded once per device."""
    cache = zkey.__dict__.setdefault("_dev_points", {})
    key = str(dev)
    if key not in cache:
        def put(t):
            if isinstance(t, tuple):
                return tuple(put(x) for x in t)
            if t.dtype == bool:
                return torch.from_numpy(t.copy()).to(dev)
            return ftorch.to_tensor(t, dev)

        cache[key] = put((zkey.a_points, zkey.b1_points, zkey.b2_points,
                          zkey.c_points, zkey.h_points))
    return cache[key]


def prove(zkey: zkey_fmt.Groth16Zkey, witness: wtns_fmt.Witness,
          r: int | None = None, s: int | None = None, msm_cw: int = 16,
          device=None, out: dict | None = None, logger=None):
    """Groth16 proof and public signals (reference src/groth16_prove.js:28-144).

    device: None means the card ("cuda"); raises without one.  r, s: the
    blinding scalars, drawn with `secrets` when not given.  out: if a dict,
    receives the device P_odd and the five MSM results (host jacobian).
    logger: gets a `debug` line before the QAP and before each MSM."""
    dev = devmod.resolve(device)
    log = logger.debug if logger else (lambda msg: None)
    cv = zkey.curve
    fr, fq = cv.fr, cv.fq
    if witness.q != fr.p:
        raise ValueError("witness curve does not match proving key")
    if witness.n != zkey.n_vars:
        raise ValueError(
            f"invalid witness length. Circuit: {zkey.n_vars}, witness: {witness.n}")

    ctx = ftorch.get_ctx(fr.name)
    co = zkey.coeffs
    idx = lambda a: torch.from_numpy(a.astype("int64")).to(dev)
    wit = ftorch.to_tensor(witness.values, dev)
    log("QAP: buildABC + 6 NTTs")
    p_odd = qap(ctx, zkey.domain_size, ftorch.to_tensor(co["val"], dev),
                idx(co["m"]), idx(co["c"]), idx(co["s"]), wit)

    fqctx = ftorch.get_ctx(fq.name)
    g1m = msm_mod.MSMContext(fqctx, fq, extension=1)
    g2m = msm_mod.MSMContext(fqctx, fq, extension=2)
    a_pts, b1_pts, b2_pts, c_pts, h_pts = _dev_points(zkey, dev)
    log("Multiexp A")
    pi_a = g1m.run(*a_pts, wit, cw=msm_cw)
    log("Multiexp B1")
    pi_b1 = g1m.run(*b1_pts, wit, cw=msm_cw)
    log("Multiexp B2")
    pi_b = g2m.run(*b2_pts, wit, cw=msm_cw)
    log("Multiexp C")
    pi_c = g1m.run(*c_pts, wit[:, zkey.n_public + 1:], cw=msm_cw)
    log("Multiexp H")
    res_h = g1m.run(*h_pts, p_odd, cw=msm_cw)
    if out is not None:
        out.update(p_odd=p_odd, A=pi_a, B1=pi_b1, B2=pi_b, C=pi_c, H=res_h)

    A = msm_mod.host_jac_to_affine(fq, pi_a, 1)
    B1 = msm_mod.host_jac_to_affine(fq, pi_b1, 1)
    B2 = msm_mod.host_jac_to_affine(fq, pi_b, 2)
    C = msm_mod.host_jac_to_affine(fq, pi_c, 1)
    H = msm_mod.host_jac_to_affine(fq, res_h, 1)
    if r is None:
        r = secrets.randbelow(fr.p)
    if s is None:
        s = secrets.randbelow(fr.p)
    proof = blind(zkey, A, B1, B2, C, H, r, s)
    publics = ftorch.np_to_ints(fr, witness.values[:, 1:zkey.n_public + 1])
    return proof, [str(x) for x in publics]


def blind(zkey, A, B1, B2, C, H, r: int, s: int) -> dict:
    """Proof JSON from the affine MSM results and the blinding r, s."""
    cv = zkey.curve
    A = hc.g1_add(cv, A, zkey.vk_alpha_1)
    A = hc.g1_add(cv, A, hc.g1_mul(cv, zkey.vk_delta_1, r))
    B2 = hc.g2_add(cv, B2, zkey.vk_beta_2)
    B2 = hc.g2_add(cv, B2, hc.g2_mul(cv, zkey.vk_delta_2, s))
    B1 = hc.g1_add(cv, B1, zkey.vk_beta_1)
    B1 = hc.g1_add(cv, B1, hc.g1_mul(cv, zkey.vk_delta_1, s))
    C = hc.g1_add(cv, C, H)
    C = hc.g1_add(cv, C, hc.g1_mul(cv, A, s))
    C = hc.g1_add(cv, C, hc.g1_mul(cv, B1, r))
    C = hc.g1_add(cv, C, hc.g1_mul(cv, zkey.vk_delta_1, (-r * s) % cv.fr.p))
    return {"pi_a": _g1_obj(A), "pi_b": _g2_obj(B2), "pi_c": _g1_obj(C),
            "protocol": "groth16", "curve": cv.name}


def prove_files(zkey_path: str, wtns_path: str, **kw):
    zkey = zkey_fmt.read_groth16_zkey(zkey_path)
    witness = wtns_fmt.read_wtns(wtns_path)
    return prove(zkey, witness, **kw)


def _g1_obj(P):
    if P is None:
        return ["0", "1", "0"]
    return [str(P[0]), str(P[1]), "1"]


def _g2_obj(P):
    if P is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [[str(P[0][0]), str(P[0][1])],
            [str(P[1][0]), str(P[1][1])],
            ["1", "0"]]


def _g1_from_obj(o):
    x, y, z = (int(v) for v in o)
    if z == 0:
        return None
    assert z == 1
    return (x, y)


def _g2_from_obj(o):
    z = (int(o[2][0]), int(o[2][1]))
    if z == (0, 0):
        return None
    assert z == (1, 0)
    return ((int(o[0][0]), int(o[0][1])), (int(o[1][0]), int(o[1][1])))


def _gt_obj(f12):
    """Fp12 -> [2][3][2] decimal-string nesting (Gt.toObject layout,
    reference src/zkey_export_verificationkey.js:59-72)."""
    return [[[str(c) for c in f2] for f2 in f6] for f6 in f12]


def export_verification_key(zkey: zkey_fmt.Groth16Zkey) -> dict:
    """vkey JSON object (reference src/zkey_export_verificationkey.js:28-77).

    vk_alphabeta_12 = e(alpha_1, beta_2) as a Gt element, computed with the
    reduced optimal-ate pairing (curves/host_curve.py) — the same canonical
    value ffjavascript's engine produces, so the exported Fp12 coordinates
    are byte-identical to the reference's
    (src/zkey_export_verificationkey.js:59).
    """
    return {
        "protocol": "groth16",
        "curve": zkey.curve.name,
        "nPublic": zkey.n_public,
        "vk_alpha_1": _g1_obj(zkey.vk_alpha_1),
        "vk_beta_2": _g2_obj(zkey.vk_beta_2),
        "vk_gamma_2": _g2_obj(zkey.vk_gamma_2),
        "vk_delta_2": _g2_obj(zkey.vk_delta_2),
        "vk_alphabeta_12": _gt_obj(
            hc.pairing(zkey.curve, zkey.vk_alpha_1, zkey.vk_beta_2)),
        "IC": [_g1_obj(p) for p in zkey.ic],
    }


def verify(vk: dict, publics, proof: dict, logger=None) -> bool:
    """Pairing-equation verification (reference src/groth16_verify.js:26-87)."""
    cv = hc.get_curve(vk["curve"])
    publics = [int(x) for x in publics]
    if len(publics) != vk["nPublic"]:
        return False
    if any(not (0 <= x < cv.fr.p) for x in publics):
        return False

    try:
        pi_a = _g1_from_obj(proof["pi_a"])
        pi_b = _g2_from_obj(proof["pi_b"])
        pi_c = _g1_from_obj(proof["pi_c"])
        ic = [_g1_from_obj(p) for p in vk["IC"]]
        vk_alpha_1 = _g1_from_obj(vk["vk_alpha_1"])
        vk_beta_2 = _g2_from_obj(vk["vk_beta_2"])
        vk_gamma_2 = _g2_from_obj(vk["vk_gamma_2"])
        vk_delta_2 = _g2_from_obj(vk["vk_delta_2"])
    except (AssertionError, ValueError, KeyError):
        return False

    for P in (pi_a, pi_c):
        if not hc.g1_is_on_curve(cv, P):
            return False
    if not hc.g2_is_on_curve(cv, pi_b):
        return False

    cpub = ic[0]
    for w, P in zip(publics, ic[1:]):
        cpub = hc.g1_add(cv, cpub, hc.g1_mul(cv, P, w))

    return hc.pairing_eq(cv, [
        (hc.g1_neg(cv, pi_a), pi_b),
        (cpub, vk_gamma_2),
        (pi_c, vk_delta_2),
        (vk_alpha_1, vk_beta_2),
    ])



def export_solidity_calldata(proof: dict, publics) -> str:
    """Hex calldata string (reference src/groth16_exportsoliditycalldata.js)."""
    def p256(n):
        return "0x" + format(int(n), "064x")

    a = proof["pi_a"]
    b = proof["pi_b"]
    c = proof["pi_c"]
    parts = [
        f"[{p256(a[0])}, {p256(a[1])}]",
        f"[[{p256(b[0][1])}, {p256(b[0][0])}],[{p256(b[1][1])}, {p256(b[1][0])}]]",
        f"[{p256(c[0])}, {p256(c[1])}]",
        "[" + ",".join(p256(x) for x in publics) + "]",
    ]
    return ",".join(parts)
