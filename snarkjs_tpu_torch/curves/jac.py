"""Branch-free batched Jacobian point arithmetic, generic over the field
adapters of `gops` (port of snarkjs_tpu/curves/jac.py).

Points are tuples (X, Y, Z) of field elements; Z == 0 encodes the point at
infinity.  Every special case (an infinite operand, P == Q, P == -Q) is
resolved with masks, so one sequence of field ops serves every lane.  The
formulas, and the order of their field ops, are the JAX package's, so the
Jacobian limbs (not only the affine points) agree with it.  On a CUDA
tensor every field op is a K-field launch.
"""

from __future__ import annotations

import torch

from ..fields.params import LIMB_BITS

DEVICE_BATCH = 1 << 21   # points per batched scalar multiplication on the card


def jac_zero(f, batch_shape=()):
    return (f.zero(batch_shape), f.one(batch_shape), f.zero(batch_shape))


def from_affine(f, x, y, inf_mask=None):
    """Affine -> Jacobian (Z = 1); inf_mask marks points at infinity."""
    bs = f.batch_shape(x)
    one = f.one(bs)
    if inf_mask is None:
        return (x, y, one)
    return (x, y, f.select(inf_mask, f.zero(bs), one))


def is_inf(f, P):
    return f.is_zero(P[2])


def jac_neg(f, P):
    return (P[0], f.neg(P[1]), P[2])


def jac_dbl(f, P):
    """dbl-2007-bl (a = 0).  Maps infinity to infinity (Z3 = 2 Y1 Z1)."""
    X1, Y1, Z1 = P
    A = f.sqr(X1)
    B = f.sqr(Y1)
    C = f.sqr(B)
    # D = 2*((X1+B)^2 - A - C)
    D = f.dbl(f.sub(f.sub(f.sqr(f.add(X1, B)), A), C))
    E = f.add(f.add(A, A), A)  # 3A
    F = f.sqr(E)
    X3 = f.sub(F, f.dbl(D))
    eightC = f.dbl(f.dbl(f.dbl(C)))
    Y3 = f.sub(f.mul(E, f.sub(D, X3)), eightC)
    Z3 = f.dbl(f.mul(Y1, Z1))
    return (X3, Y3, Z3)


def jac_add(f, P, Q):
    """add-2007-bl with every special case resolved by selects."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = f.sqr(Z1)
    Z2Z2 = f.sqr(Z2)
    U1 = f.mul(X1, Z2Z2)
    U2 = f.mul(X2, Z1Z1)
    S1 = f.mul(f.mul(Y1, Z2), Z2Z2)
    S2 = f.mul(f.mul(Y2, Z1), Z1Z1)
    H = f.sub(U2, U1)
    r = f.dbl(f.sub(S2, S1))

    I = f.sqr(f.dbl(H))
    J = f.mul(H, I)
    V = f.mul(U1, I)
    X3 = f.sub(f.sub(f.sqr(r), J), f.dbl(V))
    Y3 = f.sub(f.mul(r, f.sub(V, X3)), f.dbl(f.mul(S1, J)))
    # ((Z1+Z2)^2 - Z1Z1 - Z2Z2) = 2*Z1*Z2
    Z3 = f.mul(H, f.sub(f.sub(f.sqr(f.add(Z1, Z2)), Z1Z1), Z2Z2))

    inf1 = is_inf(f, P)
    inf2 = is_inf(f, Q)
    h_zero = f.is_zero(H)
    r_zero = f.is_zero(r)
    # same x, same y -> doubling; same x, opposite y -> infinity (Z3 = 0 already)
    dbl_case = h_zero & r_zero & ~inf1 & ~inf2
    D = jac_dbl(f, P)

    X3 = f.select(dbl_case, D[0], X3)
    Y3 = f.select(dbl_case, D[1], Y3)
    Z3 = f.select(dbl_case, D[2], Z3)

    X3 = f.select(inf2, X1, f.select(inf1, X2, X3))
    Y3 = f.select(inf2, Y1, f.select(inf1, Y2, Y3))
    Z3 = f.select(inf2, Z1, f.select(inf1, Z2, Z3))
    return (X3, Y3, Z3)


def jac_select(f, mask, P, Q):
    return tuple(f.select(mask, a, b) for a, b in zip(P, Q))


def _double_and_add(f, P, bits):
    """Left-to-right double-and-add from the identity; `bits` yields one
    batch-shaped 0/1 tensor a step, most significant first."""
    acc = jac_zero(f, f.batch_shape(P[0]))
    for bit in bits:
        acc = jac_dbl(f, acc)
        added = jac_add(f, acc, P)
        acc = jac_select(f, bit != 0, added, acc)
    return acc


def batch_scalar_mul(f, P, scalar_bits):
    """k_i * P_i for a batch of Jacobian points and per-point scalars.

    scalar_bits: (nbits, N) 0/1 tensor, most significant first.  A Python
    loop over the bits (the JAX package's lax.scan), one doubling, one add
    and one select a bit."""
    return _double_and_add(f, P, scalar_bits)


def batch_scalar_mul_limbs(f, P, limbs, nbits: int):
    """k_i * P_i with the scalars as (NL, *batch) 16-bit limbs (plain form).

    Each step takes its bit from the limbs, so no (nbits, *batch) array is
    made."""
    def bits():
        for i in range(nbits):
            pos = nbits - 1 - i
            yield (limbs[pos // LIMB_BITS] >> (pos % LIMB_BITS)) & 1

    return _double_and_add(f, P, bits())


def scalar_bit_length(limbs) -> int:
    """Bits a double-and-add needs for the (NL, *batch) plain limb scalars:
    the highest set bit over the whole batch.  Leading zero bits only double
    the identity, so fewer steps give the same points (and, from the first
    set bit on, the same Jacobian limbs)."""
    nz = torch.nonzero((limbs != 0).flatten(1).any(dim=1)).flatten()
    if nz.numel() == 0:
        return 0
    top = int(nz[-1])
    return top * LIMB_BITS + int(limbs[top].max()).bit_length()


def scalar_mul_affine(f, x, y, inf, limbs):
    """[k_i] P_i for affine points (Montgomery limbs; `inf` marks infinity,
    or None) and plain (NL, N) limb scalars, as affine (x, y, inf): one
    double-and-add over as many bits as the batch's largest scalar has, one
    batched inversion."""
    acc = batch_scalar_mul_limbs(f, from_affine(f, x, y, inf), limbs,
                                 scalar_bit_length(limbs))
    return to_affine_batch(f, acc, f.batch_inv)


def scalar_bits_from_limbs(scalars, nbits: int):
    """(NL, N) 16-bit limb scalars -> (nbits, N) int8 bit array, MSB first."""
    pos = nbits - 1 - torch.arange(nbits, device=scalars.device)
    limbs = scalars[pos // LIMB_BITS]                         # (nbits, N)
    return ((limbs >> (pos % LIMB_BITS)[:, None]) & 1).to(torch.int8)


def to_affine_batch(f, P, batch_inv_fn):
    """Jacobian -> affine (x, y, inf) with one batched inversion.

    batch_inv_fn must invert a batch of field elements and map 0 to 0."""
    X, Y, Z = P
    inf = is_inf(f, P)
    zi = batch_inv_fn(Z)
    zi2 = f.sqr(zi)
    zi3 = f.mul(zi2, zi)
    x = f.mul(X, zi2)
    y = f.mul(Y, zi3)
    zero = jac_zero(f, f.batch_shape(X))[0]
    x = f.select(inf, zero, x)
    y = f.select(inf, zero, y)
    return x, y, inf
