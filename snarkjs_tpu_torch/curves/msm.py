"""MSM entry for the prover and the host jacobian helpers (port of
snarkjs_tpu/curves/msm.py: `MSMContext.run` and the bigint finishing).

`MSMContext.run` goes to the suffix-scan engine (`msm_gpu.GpuMSM`) with the
window-width rule of the JAX package: cw = 16 on the card for batches of
2^14 points and more, cw = 8 for smaller batches and off the card (the
bucket tree scales with 2^(cw-1)).
"""

from __future__ import annotations

import torch

from ..fields.params import LIMB_BITS


class MSMContext:
    """One group (G1: extension=1, G2: extension=2) over base field fp."""

    def __init__(self, fq_ctx, fp, extension: int = 1):
        self.fp = fp
        self.ctx = fq_ctx
        self.ext = extension

    def run(self, px, py, pinf, scalars, cw: int = 16):
        """MSM over plain-form scalars; returns a host jacobian int tuple.

        px/py: (NL, N) int32 limb tensors (Fq) or pairs of them (Fq2),
        Montgomery form; pinf: (N,) bool; scalars: (NL, N) 16-bit limbs."""
        from . import msm_gpu
        from .host_curve import curve_from_q

        if cw == LIMB_BITS and (scalars.device.type != "cuda"
                                or scalars.shape[-1] < (1 << 14)):
            cw = 8
        cv = curve_from_q(self.fp.p)
        m = msm_gpu.get_msm(cv.name, "g1" if self.ext == 1 else "g2", cw=cw)
        if cw == 8:
            lo = scalars & 0xFF
            hi = (scalars >> 8) & 0xFF
            scalars = torch.stack([lo, hi], dim=1).reshape(
                2 * scalars.shape[0], scalars.shape[1])
        elif cw != LIMB_BITS:
            raise ValueError("cw must be 8 or 16")
        return m.run(px, py, pinf, scalars)


# ---------------- host jacobian finishing (bigint, exact) ----------------

def _f_mul(fp, a, b, ext):
    if ext == 1:
        return a * b % fp.p
    return ((a[0] * b[0] - a[1] * b[1]) % fp.p, (a[0] * b[1] + a[1] * b[0]) % fp.p)


def _f_add(fp, a, b, ext):
    if ext == 1:
        return (a + b) % fp.p
    return ((a[0] + b[0]) % fp.p, (a[1] + b[1]) % fp.p)


def _f_sub(fp, a, b, ext):
    if ext == 1:
        return (a - b) % fp.p
    return ((a[0] - b[0]) % fp.p, (a[1] - b[1]) % fp.p)


def _f_is_zero(a, ext):
    return a == 0 if ext == 1 else (a[0] == 0 and a[1] == 0)


def _f_int(v, ext):
    return v if ext == 1 else (v, 0)


def _host_jac_dbl(fp, P, ext):
    X1, Y1, Z1 = P
    if _f_is_zero(Z1, ext):
        return P
    m = lambda a, b: _f_mul(fp, a, b, ext)
    s = lambda a, b: _f_sub(fp, a, b, ext)
    ad = lambda a, b: _f_add(fp, a, b, ext)
    A = m(X1, X1)
    B = m(Y1, Y1)
    C = m(B, B)
    D = ad(m(X1, B), m(X1, B))
    D = ad(D, D)
    E = ad(ad(A, A), A)
    F = m(E, E)
    X3 = s(F, ad(D, D))
    Y3 = s(m(E, s(D, X3)), ad(ad(ad(C, C), ad(C, C)), ad(ad(C, C), ad(C, C))))
    Z3 = ad(m(Y1, Z1), m(Y1, Z1))
    return (X3, Y3, Z3)


def _host_jac_add(fp, P, Q, ext):
    if P is None or _f_is_zero(P[2], ext):
        return Q
    if Q is None or _f_is_zero(Q[2], ext):
        return P
    m = lambda a, b: _f_mul(fp, a, b, ext)
    s = lambda a, b: _f_sub(fp, a, b, ext)
    ad = lambda a, b: _f_add(fp, a, b, ext)
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = m(Z1, Z1)
    Z2Z2 = m(Z2, Z2)
    U1 = m(X1, Z2Z2)
    U2 = m(X2, Z1Z1)
    S1 = m(m(Y1, Z2), Z2Z2)
    S2 = m(m(Y2, Z1), Z1Z1)
    H = s(U2, U1)
    r = ad(s(S2, S1), s(S2, S1))
    if _f_is_zero(H, ext):
        if _f_is_zero(r, ext):
            return _host_jac_dbl(fp, P, ext)
        return (_f_int(0, ext), _f_int(1, ext), _f_int(0, ext))
    I = m(ad(H, H), ad(H, H))
    J = m(H, I)
    V = m(U1, I)
    X3 = s(s(m(r, r), J), ad(V, V))
    Y3 = s(m(r, s(V, X3)), ad(m(S1, J), m(S1, J)))
    Z3 = m(H, s(s(m(ad(Z1, Z2), ad(Z1, Z2)), Z1Z1), Z2Z2))
    return (X3, Y3, Z3)


def host_jac_to_affine(fp, P, ext=1):
    """Jacobian int tuple -> affine ints (or None for infinity)."""
    if P is None or _f_is_zero(P[2], ext):
        return None
    X, Y, Z = P
    if ext == 1:
        zi = pow(Z, fp.p - 2, fp.p)
        zi2 = zi * zi % fp.p
        return (X * zi2 % fp.p, Y * zi2 % fp.p * zi % fp.p)
    # Fq2 inverse
    a, b = Z
    t = pow(a * a + b * b, fp.p - 2, fp.p)
    zi = (a * t % fp.p, (-b) * t % fp.p)
    zi2 = _f_mul(fp, zi, zi, 2)
    zi3 = _f_mul(fp, zi2, zi, 2)
    return (_f_mul(fp, X, zi2, 2), _f_mul(fp, Y, zi3, 2))
