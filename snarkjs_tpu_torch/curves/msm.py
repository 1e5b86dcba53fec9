"""MSM entry for the prover, the setup's segmented MSM and the host
Jacobian helpers (port of snarkjs_tpu/curves/msm.py: `MSMContext.run`,
`segmented_msm` and the bigint finishing).

`MSMContext.run` goes to the suffix-scan engine (`msm_gpu.GpuMSM`) with the
window-width rule of the JAX package: cw = 16 on the card for batches of
2^14 points and more, cw = 8 for smaller batches and off the card (the
bucket tree scales with 2^(cw-1)).

`segmented_msm` serves the Groth16 setup: one batched double-and-add over
every entry, then a sum per segment.  The JAX package sums with a two-level
segmented scan whose first level walks n / 64 columns one after another
(one Jacobian add each); on the card that is thousands of sequential steps
of small launches.  Here each round adds every even-ranked entry of a
segment to the entry after it and keeps the even ones, so a segment of m
entries takes ceil(log2 m) rounds and all segments go at once.  The sums are
the same points, so the affine results (the bytes the setup writes) agree.
"""

from __future__ import annotations

import torch

from ..fields.params import LIMB_BITS
from . import jac


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


def segment_sums(f, P, seg, n_out: int):
    """out[k] = sum of the Jacobian points P[i] with seg[i] == k, for
    k < n_out; seg (N,) int64, grouped by segment (equal values adjacent),
    values in [0, n_out] (n_out is a trash segment that is dropped).  Empty
    segments come out as infinity.  Each round pairs every entry of even
    rank within its segment with the next entry of that segment."""
    n = seg.shape[0]
    while n > 1:
        idx = torch.arange(n, device=seg.device)
        start = torch.ones(n, dtype=torch.bool, device=seg.device)
        start[1:] = seg[1:] != seg[:-1]
        rank = idx - torch.cummax(torch.where(start, idx, 0), dim=0).values
        partner = torch.zeros(n, dtype=torch.bool, device=seg.device)
        partner[:-1] = ~start[1:]
        if not bool(partner.any()):
            break
        keep = torch.nonzero(rank % 2 == 0).flatten()
        pair = torch.nonzero(partner[keep]).flatten()
        left = tuple(f.gather(c, keep) for c in P)
        both = keep[pair]
        sums = jac.jac_add(f, tuple(f.gather(c, both) for c in P),
                           tuple(f.gather(c, both + 1) for c in P))
        for c, v in zip(left, sums):
            f.put(c, pair, v)
        P, seg, n = left, seg[keep], keep.shape[0]
    out = jac.jac_zero(f, (n_out + 1,))
    for c, v in zip(out, P):
        f.put(c, seg, v)
    return tuple(f.gather(c, slice(0, n_out)) for c in out)


def segmented_msm(f, px, py, pinf, scalars, seg, n_out: int, nbits: int):
    """Per-segment MSM: out[k] = sum_{i: seg[i] == k} scalars_i * P_i.

    px, py: affine coordinates (Montgomery limbs), pinf (N,) bool, scalars
    (NL, N) plain 16-bit limbs, seg (N,) int64 grouped by segment, values in
    [0, n_out].  Used by the Groth16 setup's per-signal point composition
    (reference src/zkey_new.js:338-501).  The double-and-add runs as many
    steps as the batch's largest scalar has bits (at most nbits).  That only
    saves steps when every scalar of the batch is small: one coefficient such
    as p - 1, which circom writes for a negated term, brings back all nbits
    steps.  Returns Jacobian points with an (n_out,)
    batch; empty segments are the point at infinity."""
    nbits = min(nbits, jac.scalar_bit_length(scalars))
    P = jac.batch_scalar_mul_limbs(f, jac.from_affine(f, px, py, pinf),
                                   scalars, nbits)
    return segment_sums(f, P, seg, n_out)


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
