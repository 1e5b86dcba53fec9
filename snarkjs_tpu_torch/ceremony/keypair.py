"""Ceremony key generation (port of snarkjs_tpu/ceremony/keypair.py): field
and point sampling from a ChaCha RNG and the hash-to-G2 construction, on host
bigints, bit-compatible with the reference
(src/keypair.js:24-84) and with Bellman's powers-of-tau sampling (the
reference's ffjavascript engine mirrors Bellman so challenge/response files
interoperate).

Sampling conventions (ffjavascript wasm_field1/wasm_curve fromRng):
  * Field element: draw n64 64-bit words (each nextU64 = hi<<32 | lo), mask
    to bitLength(p) bits, retry while >= p.  The draw IS the Montgomery
    representation; the logical value is draw * R^-1 mod p.
  * Curve point: x = F.fromRng, greatest = nextBool(); y = sqrt(x^3 + b)
    with the sign chosen so that (y lexicographically-greatest) == greatest
    (Bellman get_point_from_x), then multiplied by the cofactor.
  * Fp2 ordering is (c1, c0) lexicographic; sqrt sign choice makes the
    returned root's choice irrelevant.

Held against the JAX package's keypair on the same ChaCha streams
(tests/test_torch_ceremony.py).
"""

from __future__ import annotations

import hashlib

from ..curves import host_curve as hc
from ..curves import tower as tw
from ..fields.params import FieldParams
from ..utils.chacha import ChaCha, seed_from_hash_be


def field_from_rng(fp: FieldParams, rng: ChaCha) -> int:
    """Logical (non-Montgomery) field element sampled like Fr/Fq.fromRng."""
    bitlen = fp.p.bit_length()
    n64 = (bitlen - 1) // 64 + 1
    mask = (1 << bitlen) - 1
    while True:
        v = 0
        for i in range(n64):
            v += rng.next_u64() << (64 * i)
        v &= mask
        if v < fp.p:
            break
    return fp.from_mont(v)


def _fq_sqrt(fq: FieldParams, a: int):
    """sqrt in Fq for p % 4 == 3; None if a is not a square."""
    p = fq.p
    r = pow(a, (p + 1) // 4, p)
    return r if r * r % p == a % p else None


def _f2_pow(a, e: int, p: int):
    r = (1, 0)
    b = a
    while e:
        if e & 1:
            r = tw.f2_mul(r, b, p)
        b = tw.f2_mul(b, b, p)
        e >>= 1
    return r


def _f2_sqrt(fq: FieldParams, a):
    """sqrt in Fp2 for p % 4 == 3 (Adj/Rodriguez-Henriquez); None if non-QR."""
    p = fq.p
    if a == (0, 0):
        return (0, 0)
    a1 = _f2_pow(a, (p - 3) // 4, p)
    alpha = tw.f2_mul(tw.f2_mul(a1, a1, p), a, p)
    x0 = tw.f2_mul(a1, a, p)
    if alpha == ((p - 1) % p, 0):
        x = tw.f2_mul((0, 1), x0, p)
    else:
        b = _f2_pow(tw.f2_add((1, 0), alpha, p), (p - 1) // 2, p)
        x = tw.f2_mul(b, x0, p)
    return x if tw.f2_mul(x, x, p) == tuple(c % p for c in a) else None


def _fq_gt(p: int, a: int, b: int) -> bool:
    return a > b


def _f2_gt(p: int, a, b) -> bool:
    """Bellman Fq2 ordering: c1 first, then c0."""
    if a[1] != b[1]:
        return a[1] > b[1]
    return a[0] > b[0]


def g1_cofactor(cv: hc.CurveParams) -> int:
    if cv.name == "bn128":
        return 1
    # BLS12-381: h1 = (#E(Fp)) / r
    t = cv.x_param + 1
    n = cv.fq.p + 1 - t
    assert n % cv.fr.p == 0
    return n // cv.fr.p


def g2_cofactor(cv: hc.CurveParams) -> int:
    """Cofactor of the sextic-twist group E'(Fp2) (NOT of E(Fp2)!), matching
    ffjavascript's hard-coded cofactorG2 constants.

    BN: #E'(Fp2) = h2*r with h2 = p + t - 1 = 36x^4+36x^3+30x^2+6x+1.
    BLS12: h2 = (x^8-4x^7+5x^6-4x^4+6x^3-4x^2-4x+13)/9.
    """
    x = cv.x_param
    if cv.name == "bn128":
        t = 6 * x * x + 1
        return cv.fq.p + t - 1
    return (x**8 - 4 * x**7 + 5 * x**6 - 4 * x**4 + 6 * x**3
            - 4 * x**2 - 4 * x + 13) // 9


def g1_from_rng(cv: hc.CurveParams, rng: ChaCha):
    fq = cv.fq
    p = fq.p
    while True:
        x = field_from_rng(fq, rng)
        greatest = rng.next_bool()
        y = _fq_sqrt(fq, (x * x % p * x + cv.b) % p)
        if y is not None:
            break
    if _fq_gt(p, y, (-y) % p) != greatest:
        y = (-y) % p
    P = (x, y)
    h = g1_cofactor(cv)
    return P if h == 1 else hc.g1_mul(cv, P, h)


def g2_from_rng(cv: hc.CurveParams, rng: ChaCha):
    fq = cv.fq
    p = fq.p
    while True:
        x0 = field_from_rng(fq, rng)
        x1 = field_from_rng(fq, rng)
        x = (x0, x1)
        greatest = rng.next_bool()
        x3b = tw.f2_add(tw.f2_mul(tw.f2_mul(x, x, p), x, p), cv.b2, p)
        y = _f2_sqrt(fq, x3b)
        if y is not None:
            break
    ny = tw.f2_neg(y, p)
    if _f2_gt(p, y, ny) != greatest:
        y = ny
    P = (x, y)
    return g2_mul_cofactor(cv, P)


def g2_mul_cofactor(cv, P):
    return hc.g2_mul_any(cv, P, g2_cofactor(cv))


def hash_to_g2(cv: hc.CurveParams, digest: bytes):
    """reference src/keypair.js:24-35: seed ChaCha from the BE words of a
    64-byte hash, sample a G2 point."""
    rng = ChaCha(seed_from_hash_be(digest))
    return g2_from_rng(cv, rng)


def get_g2sp(cv: hc.CurveParams, personalization: int, challenge: bytes,
             g1s, g1sx):
    """blake2b(personalization byte || challenge || G1 uncompressed(s, sx))
    -> hashToG2 (reference src/keypair.js:38-51)."""
    from ..formats.points import g1_uncompressed_be

    h = hashlib.blake2b(digest_size=64)
    h.update(bytes([personalization]))
    h.update(challenge)
    h.update(g1_uncompressed_be(cv.fq, g1s))
    h.update(g1_uncompressed_be(cv.fq, g1sx))
    return hash_to_g2(cv, h.digest())


def create_ptau_key(cv: hc.CurveParams, challenge_hash: bytes, rng: ChaCha):
    """{tau, alpha, beta} sub-keys (reference src/keypair.js:62-75):
    draw the three private keys first, then each pubkey in order."""
    key = {}
    prv = {}
    for name in ("tau", "alpha", "beta"):
        prv[name] = field_from_rng(cv.fr, rng)
    for i, name in enumerate(("tau", "alpha", "beta")):
        k = {"prvKey": prv[name]}
        k["g1_s"] = g1_from_rng(cv, rng)
        k["g1_sx"] = hc.g1_mul(cv, k["g1_s"], k["prvKey"])
        k["g2_sp"] = get_g2sp(cv, i, challenge_hash, k["g1_s"], k["g1_sx"])
        k["g2_spx"] = hc.g2_mul_any(cv, k["g2_sp"], k["prvKey"])
        key[name] = k
    return key


def create_delta_key(cv: hc.CurveParams, transcript: bytes, rng: ChaCha):
    """Phase-2 delta key (reference src/keypair.js:77-84)."""
    d = {"prvKey": field_from_rng(cv.fr, rng)}
    d["g1_s"] = g1_from_rng(cv, rng)
    d["g1_sx"] = hc.g1_mul(cv, d["g1_s"], d["prvKey"])
    d["g2_sp"] = hash_to_g2(cv, transcript)
    d["g2_spx"] = hc.g2_mul_any(cv, d["g2_sp"], d["prvKey"])
    return d
