"""Host-side (Python bigint) elliptic curve arithmetic and pairings.

This is the reference/oracle path: slow, simple, exact.  The card MSM in
`curves/msm_gpu.py` is tested against it, and the O(1)
verification pairings run here (the reference similarly keeps verification a
single multi-pairing, src/groth16_verify.js:72-78).

Pairing: Tate pairing f_{r,P}(Q)^((p^12-1)/r) with Q untwisted into E(Fp12).
Any fixed non-degenerate bilinear pairing satisfies the verifier equations
(they only assert multiplicative relations), so the Tate variant is
interchangeable with ffjavascript's optimal ate for proof verification.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from ..fields.params import (BN254_FQ, BN254_FR, BLS12_381_FQ, BLS12_381_FR,
                             FieldParams)
from . import tower as tw


@dataclass(frozen=True)
class CurveParams:
    name: str
    fq: FieldParams
    fr: FieldParams
    b: int                      # G1: y^2 = x^3 + b
    b2: tuple                   # G2 twist: y^2 = x^3 + b2 (Fp2 element)
    xi: tuple                   # sextic twist constant (Fp2)
    twist_type: str             # "D" (divisive, bn254) or "M" (multiplicative, bls)
    g1: tuple                   # generator (x, y)
    g2: tuple                   # generator ((xa,xb),(ya,yb))
    # BLS/BN curve parameter x (optimal-ate loop constant; sign significant)
    x_param: int = 0


BN254 = CurveParams(
    name="bn128",   # snarkjs calls it bn128 (reference src/curves.js:49-52)
    fq=BN254_FQ,
    fr=BN254_FR,
    b=3,
    b2=tw.f2_mul((3, 0), tw.f2_inv((9, 1), BN254_FQ.p), BN254_FQ.p),
    xi=(9, 1),
    twist_type="D",
    g1=(1, 2),
    g2=(
        (10857046999023057135944570762232829481370756359578518086990519993285655852781,
         11559732032986387107991004021392285783925812861821192530917403151452391805634),
        (8495653923123431417604973247489272438418190587263600148770280649306958101930,
         4082367875863433681332203403145435568316851327593401208105741076214120093531),
    ),
    x_param=4965661367192848881,
)

BLS12_381 = CurveParams(
    name="bls12381",
    fq=BLS12_381_FQ,
    fr=BLS12_381_FR,
    b=4,
    b2=(4, 4),
    xi=(1, 1),
    twist_type="M",
    g1=(
        0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
        0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    ),
    g2=(
        (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
         0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
        (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
         0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
    ),
    x_param=-0xD201000000010000,
)


@lru_cache(maxsize=None)
def get_curve(name: str) -> CurveParams:
    n = name.lower().replace("-", "").replace("_", "")
    if n in ("bn128", "bn254", "altbn128"):
        return BN254
    if n in ("bls12381",):
        return BLS12_381
    raise ValueError(f"unknown curve {name}")


def curve_from_q(q: int) -> CurveParams:
    if q == BN254_FQ.p:
        return BN254
    if q == BLS12_381_FQ.p:
        return BLS12_381
    raise ValueError("unknown curve prime")


# ---------------- G1 affine (None = point at infinity) ----------------

def g1_is_on_curve(cv: CurveParams, P) -> bool:
    if P is None:
        return True
    x, y = P
    p = cv.fq.p
    return (y * y - x * x * x - cv.b) % p == 0


def g1_neg(cv, P):
    if P is None:
        return None
    return (P[0], (-P[1]) % cv.fq.p)


def g1_add(cv, P, Q):
    p = cv.fq.p
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1) * tw.inv_mod(2 * y1, p) % p
    else:
        lam = (y2 - y1) * tw.inv_mod(x2 - x1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def g1_mul(cv, P, k: int):
    k %= cv.fr.p
    R = None
    while k > 0:
        if k & 1:
            R = g1_add(cv, R, P)
        P = g1_add(cv, P, P)
        k >>= 1
    return R


# ---------------- G2 affine over Fp2 ----------------

def g2_is_on_curve(cv: CurveParams, P) -> bool:
    if P is None:
        return True
    x, y = P
    p = cv.fq.p
    lhs = tw.f2_sqr(y, p)
    rhs = tw.f2_add(tw.f2_mul(tw.f2_sqr(x, p), x, p), cv.b2, p)
    return lhs == rhs


def g2_neg(cv, P):
    if P is None:
        return None
    return (P[0], tw.f2_neg(P[1], cv.fq.p))


def g2_add(cv, P, Q):
    p = cv.fq.p
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if tw.f2_add(y1, y2, p) == tw.F2_ZERO:
            return None
        num = tw.f2_scalar(tw.f2_sqr(x1, p), 3, p)
        den = tw.f2_scalar(y1, 2, p)
    else:
        num = tw.f2_sub(y2, y1, p)
        den = tw.f2_sub(x2, x1, p)
    lam = tw.f2_mul(num, tw.f2_inv(den, p), p)
    x3 = tw.f2_sub(tw.f2_sub(tw.f2_sqr(lam, p), x1, p), x2, p)
    y3 = tw.f2_sub(tw.f2_mul(lam, tw.f2_sub(x1, x3, p), p), y1, p)
    return (x3, y3)


def g2_mul(cv, P, k: int):
    return g2_mul_any(cv, P, k % cv.fr.p)


def g2_mul_any(cv, P, k: int):
    """Scalar mul WITHOUT reduction mod r (cofactor clearing needs k > r)."""
    R = None
    while k > 0:
        if k & 1:
            R = g2_add(cv, R, P)
        P = g2_add(cv, P, P)
        k >>= 1
    return R


# ---------------- Pairing ----------------
#
# Orientation: Miller loop runs over the G2 point (arithmetic on the sextic
# twist in Fp2), line functions are evaluated at the G1 point P.  Untwisting
# D-type:  (x', y') -> (x' w^2, y' w^3);  M-type: (x' w^-2, y' w^-3) with
# w^6 = xi.  With this orientation all vertical lines evaluate into the even
# subalgebra Fp6 (components at w^0/w^2/w^4 only), which the final
# exponentiation (p^6-1 factor) annihilates — standard denominator
# elimination.
#
# The pairing is the REDUCED OPTIMAL ATE — the same canonical value
# ffjavascript computes (reference engine for src/groth16_verify.js:72-78
# and the Gt export src/zkey_export_verificationkey.js:59), so exported
# vk_alphabeta_12 coordinates are byte-identical:
#   BN family:  f = f_{6x+2,Q}(P) * l_{T,piQ}(P) * l_{T+piQ,-pi^2 Q}(P)
#   BLS family: f = conj(f_{|x|,Q}(P))          (x < 0; conj == inverse
#               after the final exponentiation, f^(p^12-1) = 1)
# then f^((p^12-1)/r).  The ~65-bit ate loop is also ~4x faster than the
# full-order Tate loop this replaced.


def _line_as_f12(cv, c0_fp, c1, c3, c5):
    """Assemble a sparse line value into the (Fp6, Fp6) representation.

    w-basis coefficients: c0 (Fp, at w^0), c1/c3/c5 (Fp2, at w^1/w^3/w^5).
    Representation maps w^(2i) -> first Fp6 coeff i, w^(2i+1) -> second.
    """
    return (((c0_fp % cv.fq.p, 0), tw.F2_ZERO, tw.F2_ZERO), (c1, c3, c5))


def _line_steps(cv: CurveParams, P):
    """Doubling/addition step closures for Miller loops: each returns the
    sparse line value l(P) (verticals dropped) and the new running point."""
    p, xi = cv.fq.p, cv.xi
    xP, yP = P

    def dbl_step(T):
        x1, y1 = T
        lam = tw.f2_mul(tw.f2_scalar(tw.f2_sqr(x1, p), 3, p),
                        tw.f2_inv(tw.f2_scalar(y1, 2, p), p), p)
        return _step(T, T, lam)

    def add_step(T, S):
        x1, y1 = T
        x2, y2 = S
        if x1 == x2 and tw.f2_add(y1, y2, p) == tw.F2_ZERO:
            return None, None  # vertical — dropped
        lam = tw.f2_mul(tw.f2_sub(y2, y1, p),
                        tw.f2_inv(tw.f2_sub(x2, x1, p), p), p)
        return _step(T, S, lam)

    def _step(T, S, lam):
        x1, y1 = T
        x2, y2 = S
        x3 = tw.f2_sub(tw.f2_sub(tw.f2_sqr(lam, p), x1, p), x2, p)
        y3 = tw.f2_sub(tw.f2_mul(lam, tw.f2_sub(x1, x3, p), p), y1, p)
        lx_minus_y = tw.f2_sub(tw.f2_mul(lam, x1, p), y1, p)
        if cv.twist_type == "D":
            # l(P) = yP - lam*xP*w + (lam*x1 - y1)*w^3
            l = _line_as_f12(cv, yP,
                             tw.f2_scalar(lam, (-xP) % p, p),
                             lx_minus_y,
                             tw.F2_ZERO)
        else:
            # l(P)*xi = xi*yP + (lam*x1 - y1)*w^3 - lam*xP*w^5
            l = _line_as_f12(cv, 0,
                             tw.F2_ZERO,
                             lx_minus_y,
                             tw.f2_scalar(lam, (-xP) % p, p))
            l = (tw.f6_add(l[0], ((xi[0] * yP % p, xi[1] * yP % p),
                                  tw.F2_ZERO, tw.F2_ZERO), p), l[1])
        return l, (x3, y3)

    return dbl_step, add_step


def _miller_loop_g2(cv: CurveParams, P, Q, loop: int):
    """(f_{loop, Q'}(P), [loop]Q') with verticals dropped.  P g1-affine,
    Q g2-affine (twist coordinates)."""
    p, xi = cv.fq.p, cv.xi
    dbl_step, add_step = _line_steps(cv, P)
    f = tw.f12_one()
    T = Q
    for b in bin(loop)[3:]:
        f = tw.f12_sqr(f, p, xi)
        l, T = dbl_step(T)
        f = tw.f12_mul(f, l, p, xi)
        if b == "1":
            l, T = add_step(T, Q)
            if T is None:
                break
            f = tw.f12_mul(f, l, p, xi)
    return f, T


def _frob_twist(cv: CurveParams, Q):
    """psi^-1 . pi . psi on twist-affine G2 points (D-type untwist
    (x,y) -> (x w^2, y w^3)):  (conj(x)*xi^((p-1)/3), conj(y)*xi^((p-1)/2))."""
    p = cv.fq.p
    g = _frob_gammas(cv.name)       # g[i-1] = xi^(i*(p-1)/6)
    return (tw.f2_mul(tw.f2_conj(Q[0], p), g[1], p),
            tw.f2_mul(tw.f2_conj(Q[1], p), g[2], p))


def _ate_miller(cv: CurveParams, P, Q):
    """Un-reduced optimal-ate Miller value (canonical; see section comment)."""
    p, xi = cv.fq.p, cv.xi
    if cv.x_param > 0:              # BN family: loop 6x+2 + frobenius lines
        f, T = _miller_loop_g2(cv, P, Q, 6 * cv.x_param + 2)
        _, add_step = _line_steps(cv, P)
        Q1 = _frob_twist(cv, Q)
        Q2 = _frob_twist(cv, Q1)
        nQ2 = (Q2[0], tw.f2_neg(Q2[1], p))
        l, T = add_step(T, Q1)
        f = tw.f12_mul(f, l, p, xi)
        l, T = add_step(T, nQ2)
        return tw.f12_mul(f, l, p, xi)
    # BLS family: loop |x|; x < 0 -> conjugate (== inverse after final exp)
    f, _ = _miller_loop_g2(cv, P, Q, -cv.x_param)
    return tw.f12_conj(f, p)


@lru_cache(maxsize=None)
def _final_exp_hard(name: str) -> int:
    cv = get_curve(name)
    p = cv.fq.p
    return (p ** 4 - p ** 2 + 1) // cv.fr.p


@lru_cache(maxsize=None)
def _frob_gammas(name: str):
    cv = get_curve(name)
    return tw.make_frobenius_gammas(cv.fq.p, cv.xi)


def final_exponentiation(cv: CurveParams, f):
    p, xi = cv.fq.p, cv.xi
    # easy part: f^((p^6-1)(p^2+1))
    f = tw.f12_mul(tw.f12_conj(f, p), tw.f12_inv(f, p, xi), p, xi)
    g = _frob_gammas(cv.name)
    f = tw.f12_mul(tw.f12_frobenius(tw.f12_frobenius(f, p, xi, g), p, xi, g), f, p, xi)
    # hard part
    return tw.f12_pow(f, _final_exp_hard(cv.name), p, xi)


def pairing(cv: CurveParams, P, Q):
    """e(P, Q) with P in G1 affine, Q in G2 affine.  None -> 1."""
    if P is None or Q is None:
        return tw.f12_one()
    return final_exponentiation(cv, _ate_miller(cv, P, Q))


def multi_miller(cv: CurveParams, pairs):
    p, xi = cv.fq.p, cv.xi
    f = tw.f12_one()
    for P, Q in pairs:
        if P is None or Q is None:
            continue
        f = tw.f12_mul(f, _ate_miller(cv, P, Q), p, xi)
    return f


def pairing_eq(cv: CurveParams, pairs) -> bool:
    """prod e(P_i, Q_i) == 1  (ffjavascript pairingEq equivalent)."""
    f = multi_miller(cv, pairs)
    return final_exponentiation(cv, f) == tw.f12_one()


def same_ratio(cv: CurveParams, g1s, g1sx, g2s, g2sx) -> bool:
    """e(g1s, g2sx) == e(g1sx, g2s)  (reference src/misc.js:129-137)."""
    return pairing_eq(cv, [(g1s, g2sx), (g1_neg(cv, g1sx), g2s)])
