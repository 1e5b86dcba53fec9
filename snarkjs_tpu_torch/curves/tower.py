"""Extension field towers Fp2 / Fp6 / Fp12 over Python bigints.

Used for the O(1)-per-proof pairing computations (verification, sameRatio
ceremony checks) which run on host — the reference likewise treats pairings as
a tiny fraction of the cost (reference src/groth16_verify.js:72-78 does a
single 4-pair multi-pairing per verify).

Tower (standard, matching ffjavascript's bn128/bls12-381 construction):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi)      xi = 9+u (bn254), 1+u (bls12-381)
    Fp12 = Fp6[w] / (w^2 - v)

Elements: Fp2 = (a, b) meaning a + b*u; Fp6 = 3-tuple of Fp2; Fp12 = 2-tuple
of Fp6.  All functions take the prime p and xi explicitly so both curves share
the code.
"""

from __future__ import annotations


# ---------------- Fp2 ----------------

def f2_add(x, y, p):
    return ((x[0] + y[0]) % p, (x[1] + y[1]) % p)


def f2_sub(x, y, p):
    return ((x[0] - y[0]) % p, (x[1] - y[1]) % p)


def f2_neg(x, p):
    return ((-x[0]) % p, (-x[1]) % p)


def f2_mul(x, y, p):
    # (a+bu)(c+du) = (ac - bd) + (ad + bc)u   [u^2 = -1]
    a, b = x
    c, d = y
    return ((a * c - b * d) % p, (a * d + b * c) % p)


def f2_sqr(x, p):
    a, b = x
    return ((a + b) * (a - b) % p, 2 * a * b % p)


def f2_scalar(x, k, p):
    return (x[0] * k % p, x[1] * k % p)


def f2_conj(x, p):
    return (x[0], (-x[1]) % p)


def inv_mod(x, p):
    """x^-1 mod p by the extended Euclid of `pow(x, -1, p)` (the same value
    as Fermat's x^(p-2), at a fraction of the cost); 0 -> 0."""
    x %= p
    return pow(x, -1, p) if x else 0


def f2_inv(x, p):
    a, b = x
    t = inv_mod(a * a + b * b, p)
    return (a * t % p, (-b * t) % p)


def f2_pow(x, e, p):
    r = (1, 0)
    while e > 0:
        if e & 1:
            r = f2_mul(r, x, p)
        x = f2_sqr(x, p)
        e >>= 1
    return r


F2_ZERO = (0, 0)
F2_ONE = (1, 0)


# ---------------- Fp6 ----------------

def f6_zero():
    return (F2_ZERO, F2_ZERO, F2_ZERO)


def f6_one():
    return (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(x, y, p):
    return tuple(f2_add(a, b, p) for a, b in zip(x, y))


def f6_sub(x, y, p):
    return tuple(f2_sub(a, b, p) for a, b in zip(x, y))


def f6_neg(x, p):
    return tuple(f2_neg(a, p) for a in x)


def f6_mul(x, y, p, xi):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = f2_mul(a0, b0, p)
    t1 = f2_mul(a1, b1, p)
    t2 = f2_mul(a2, b2, p)
    c0 = f2_add(t0, f2_mul(xi, f2_sub(f2_mul(f2_add(a1, a2, p), f2_add(b1, b2, p), p),
                                      f2_add(t1, t2, p), p), p), p)
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1, p), f2_add(b0, b1, p), p),
                       f2_add(t0, t1, p), p),
                f2_mul(xi, t2, p), p)
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2, p), f2_add(b0, b2, p), p),
                       f2_add(t0, t2, p), p), t1, p)
    return (c0, c1, c2)


def f6_sqr(x, p, xi):
    return f6_mul(x, x, p, xi)


def f6_mul_by_v(x, p, xi):
    # (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2
    a0, a1, a2 = x
    return (f2_mul(xi, a2, p), a0, a1)


def f6_inv(x, p, xi):
    a0, a1, a2 = x
    t0 = f2_sqr(a0, p)
    t1 = f2_sqr(a1, p)
    t2 = f2_sqr(a2, p)
    t3 = f2_mul(a0, a1, p)
    t4 = f2_mul(a0, a2, p)
    t5 = f2_mul(a1, a2, p)
    c0 = f2_sub(t0, f2_mul(xi, t5, p), p)
    c1 = f2_sub(f2_mul(xi, t2, p), t3, p)
    c2 = f2_sub(t1, t4, p)
    t6 = f2_add(f2_mul(a0, c0, p),
                f2_mul(xi, f2_add(f2_mul(a2, c1, p), f2_mul(a1, c2, p), p), p), p)
    t6i = f2_inv(t6, p)
    return (f2_mul(c0, t6i, p), f2_mul(c1, t6i, p), f2_mul(c2, t6i, p))


# ---------------- Fp12 ----------------

def f12_one():
    return (f6_one(), f6_zero())


def f12_mul(x, y, p, xi):
    a0, a1 = x
    b0, b1 = y
    t0 = f6_mul(a0, b0, p, xi)
    t1 = f6_mul(a1, b1, p, xi)
    c0 = f6_add(t0, f6_mul_by_v(t1, p, xi), p)
    c1 = f6_sub(f6_mul(f6_add(a0, a1, p), f6_add(b0, b1, p), p, xi),
                f6_add(t0, t1, p), p)
    return (c0, c1)


def f12_sqr(x, p, xi):
    return f12_mul(x, x, p, xi)


def f12_conj(x, p):
    """x^(p^6): conjugate of the quadratic extension (negate the w-part)."""
    return (x[0], f6_neg(x[1], p))


def f12_inv(x, p, xi):
    a0, a1 = x
    t = f6_sub(f6_sqr(a0, p, xi), f6_mul_by_v(f6_sqr(a1, p, xi), p, xi), p)
    ti = f6_inv(t, p, xi)
    return (f6_mul(a0, ti, p, xi), f6_neg(f6_mul(a1, ti, p, xi), p))


def f12_pow(x, e, p, xi):
    r = f12_one()
    while e > 0:
        if e & 1:
            r = f12_mul(r, x, p, xi)
        x = f12_sqr(x, p, xi)
        e >>= 1
    return r


def f12_eq(x, y):
    return x == y


def f12_frobenius(x, p, xi, gammas):
    """x^p.  gammas = (g1..g5) with g_i = xi^(i*(p-1)/6) in Fp2.

    In the w-basis an Fp12 element is sum c_i * w^i (c_i in Fp2, i=0..5) with
    (a0+a1 v+a2 v^2) + (b0+b1 v+b2 v^2) w  ->  coeffs of w^0..w^5:
    a0, b0, a1, b1, a2, b2 (since v = w^2).  x^p conjugates each c_i and
    multiplies by g_i.
    """
    (a0, a1, a2), (b0, b1, b2) = x
    cs = [a0, b0, a1, b1, a2, b2]
    out = [f2_conj(c, p) for c in cs]
    for i in range(1, 6):
        out[i] = f2_mul(out[i], gammas[i - 1], p)
    return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))


def make_frobenius_gammas(p, xi):
    return tuple(f2_pow(xi, i * (p - 1) // 6, p) for i in range(1, 6))
