"""Groth16 circuit-specific setup (port of snarkjs_tpu/protocols/groth16_setup.py),
begun with the two helpers the PLONK setup needs: the Lagrange values at a
secret tau and same-base scalar multiples of the generator.  The Groth16 key
generation itself and the device route of `_points_from_scalars` are still to
be ported (ROADMAP A1).
"""

from __future__ import annotations

import numpy as np

from ..curves import host_curve as hc
from ..fields import ftorch

HOST_ROUTE_MAX = 512


def lagrange_at(fr, tau: int, n: int):
    """[L_i(tau)]_{i<n} over the 2^k domain, ffjavascript root convention."""
    k = n.bit_length() - 1
    w = fr.w[k]
    p = fr.p
    zn = (pow(tau, n, p) - 1) % p
    if zn == 0:
        raise ValueError("tau lies in the evaluation domain")
    n_inv = pow(n, p - 2, p)
    out = []
    wi = 1
    for _ in range(n):
        out.append(zn * n_inv % p * wi % p * pow((tau - wi) % p, p - 2, p) % p)
        wi = wi * w % p
    return out


def _points_from_scalars(cv, scalars, g2=False):
    """[k_i]G as (x, y, inf) Montgomery limb arrays (numpy), on host bigints.

    The JAX package sends more than 512 scalars to a batched double-and-add on
    the device (curves/jac.py, curves/gops.py); that route is not ported yet
    (ROADMAP A1), so larger batches raise."""
    fr, fq = cv.fr, cv.fq
    if len(scalars) > HOST_ROUTE_MAX:
        raise NotImplementedError(
            f"{len(scalars)} scalars: the device route of _points_from_scalars "
            "(batched Jacobian scalar-mul) is ROADMAP A1, not ported yet")
    gen = cv.g2 if g2 else cv.g1
    mul = hc.g2_mul if g2 else hc.g1_mul
    pts = [mul(cv, gen, int(k) % fr.p) for k in scalars]
    if g2:
        id_pt = ((0, 0), (1, 0))
        xs = tuple(ftorch.np_from_ints(
            fq, [fq.to_mont((id_pt if p is None else p)[0][i]) for p in pts])
            for i in (0, 1))
        ys = tuple(ftorch.np_from_ints(
            fq, [fq.to_mont((id_pt if p is None else p)[1][i]) for p in pts])
            for i in (0, 1))
    else:
        xs = ftorch.np_from_ints(
            fq, [fq.to_mont(0 if p is None else p[0]) for p in pts])
        ys = ftorch.np_from_ints(
            fq, [fq.to_mont(1 if p is None else p[1]) for p in pts])
    inf = np.array([p is None for p in pts], dtype=bool)
    return xs, ys, inf
