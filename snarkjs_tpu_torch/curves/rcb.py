"""Renes–Costello–Batina complete addition, a=0 short Weierstrass, generic
over the FOps field adapter (Fq for G1, Fq2 for G2).

Why this formula set for the scan MSM: the formulas are *complete* — one
straight-line program handles P+Q, P+P, P+(-P), and the identity with no
branches or masks — which is exactly what a branch-free SIMD/systolic model
wants.  The reference's WASM engine uses jacobian formulas with per-case
branches (g1m_* in ffjavascript, driven from reference
src/groth16_prove.js:106-120); branching per lane is not expressible on the
VPU, and mask-based jacobian special-casing costs more vector selects than
the extra multiplications here (selects measured ~4x slower than u32
multiplies on v5e).

Points are pytrees (X, Y, Z) of field elements in homogeneous projective
coordinates; the identity is (0 : 1 : 0).  Completeness holds for prime-order
groups (no 2-torsion), which is the case for the r-order G1/G2 subgroups of
bn254 and bls12-381 (RCB15, eprint 2015/1060, Algorithms 7/8/9).

b3 is the curve constant 3*b (Montgomery form), an f-element broadcastable
against the batch.
"""

from __future__ import annotations


def rcb_add(f, P, Q, b3):
    """Complete projective add P + Q (both projective).  12M, two products
    by b3, 19a."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0 = f.mul(X1, X2)
    t1 = f.mul(Y1, Y2)
    t2 = f.mul(Z1, Z2)
    m = f.sub(f.sub(f.mul(f.add(X1, Y1), f.add(X2, Y2)), t0), t1)  # X1Y2+X2Y1
    s = f.sub(f.sub(f.mul(f.add(Y1, Z1), f.add(Y2, Z2)), t1), t2)  # Y1Z2+Y2Z1
    u = f.sub(f.sub(f.mul(f.add(X1, Z1), f.add(X2, Z2)), t0), t2)  # X1Z2+X2Z1
    return _rcb_tail(f, t0, t1, f.mul(b3, t2), m, s, u, b3)


def rcb_madd(f, P, x2, y2, b3):
    """Complete mixed add P + (x2, y2) with Z2 = 1.  11M, two products by
    b3, 14a.

    (x2, y2) must be a genuine affine point (not the identity); P may be
    anything including the identity.
    """
    X1, Y1, Z1 = P
    t0 = f.mul(X1, x2)
    t1 = f.mul(Y1, y2)
    m = f.sub(f.sub(f.mul(f.add(X1, Y1), f.add(x2, y2)), t0), t1)
    s = f.add(f.mul(y2, Z1), Y1)
    u = f.add(f.mul(x2, Z1), X1)
    return _rcb_tail(f, t0, t1, f.mul(b3, Z1), m, s, u, b3)


def _rcb_tail(f, t0, t1, w, m, s, u, b3):
    """Shared tail: w = b3*Z1Z2, m/s/u the three cross terms."""
    q = f.add(f.add(t0, t0), t0)  # 3*X1X2
    tm = f.sub(t1, w)
    tp = f.add(t1, w)
    B = f.mul(b3, u)
    X3 = f.sub(f.mul(m, tm), f.mul(s, B))
    Y3 = f.add(f.mul(tp, tm), f.mul(B, q))
    Z3 = f.add(f.mul(s, tp), f.mul(m, q))
    return (X3, Y3, Z3)


def rcb_zero(f, batch_shape=()):
    """The identity (0 : 1 : 0)."""
    return (f.zero(batch_shape), f.one(batch_shape), f.zero(batch_shape))


def rcb_select(f, mask, P, Q):
    return tuple(f.select(mask, a, b) for a, b in zip(P, Q))


def from_affine(f, x, y, inf_mask=None):
    """Affine -> projective; inf_mask lanes become the identity."""
    bs = f.batch_shape(x)
    one = f.one(bs)
    zero = f.zero(bs)
    if inf_mask is None:
        return (x, y, one)
    return (f.select(inf_mask, zero, x),
            f.select(inf_mask, one, y),
            f.select(inf_mask, zero, one))


def rcb_double(f, P, b3):
    """Complete doubling = rcb_add(P, P) — kept simple; the MSM hot path
    never doubles on device (window combination happens on host)."""
    return rcb_add(f, P, P, b3)
