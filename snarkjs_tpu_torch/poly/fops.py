"""Vectorized polynomial operations over Fr (port of snarkjs_tpu/poly/fops.py).

Whole-array replacements for the reference's byte-buffer Polynomial class
(reference src/polynomial/polynomial.js): every serial coefficient loop is an
elementwise pass, a log-depth scan (`ftorch.assoc_scan`) or a small reshaped
cumulative operation.  All results are canonical residues, so the order in
which a scan associates its operator does not show in the limbs.

Conventions: coefficient/evaluation tensors are (NL, n) Montgomery limb-major
int32; scalars are passed as (NL, 1) Montgomery tensors.
"""

from __future__ import annotations

import torch

from ..fields import ftorch
from ..fields.ftorch import FieldCtx


def scalar_arr(ctx: FieldCtx, v: int, device="cpu"):
    """Plain int -> (NL, 1) Montgomery constant on `device`."""
    fp = ctx.fp
    return ftorch.to_tensor(ftorch.np_from_ints(fp, [fp.to_mont(v % fp.p)]), device)


def powers_of(ctx: FieldCtx, x_mont, n: int):
    """[1, x, x^2, ..., x^(n-1)] as (NL, n) Montgomery (log-depth scan)."""
    one = ctx.one((1,), x_mont.device)
    seq = torch.cat([one, x_mont.expand(ctx.nl, n - 1)], dim=1)
    return ftorch.assoc_scan(lambda a, b: ftorch.mont_mul(ctx, a, b), seq)


def field_sum(ctx: FieldCtx, arr):
    """Exact sum of Montgomery elements along axis 1 -> (NL, 1).

    Limb-wise sums over chunks of 2^14 (a limb sum stays below 2^30, its top
    carry below 2^16), reduced with a wide carry between levels."""
    from ..protocols.groth16 import reduce_wide

    x = arr
    while x.shape[1] > 1:
        n = x.shape[1]
        chunk = min(1 << 14, n)
        x = torch.nn.functional.pad(x, (0, (-n) % chunk))
        sums = x.reshape(ctx.nl, -1, chunk).sum(dim=2, dtype=torch.int64)
        limbs, carry = ftorch._carry_prop(sums)
        x = reduce_wide(ctx, limbs.to(ftorch.DTYPE), carry)
    return x


def poly_eval(ctx: FieldCtx, coefs, x_plain: int) -> int:
    """P(x) for a plain int x; returns a plain int (host)."""
    pw = powers_of(ctx, scalar_arr(ctx, x_plain, coefs.device), coefs.shape[1])
    s = field_sum(ctx, ftorch.mont_mul(ctx, coefs, pw))
    return ftorch.np_to_ints(ctx.fp, ftorch.from_mont(ctx, s))[0]


def div_zh(ctx: FieldCtx, coefs, n: int):
    """Divide a k*n-coefficient polynomial by Z_H = X^n - 1 (reference
    polynomial.js divZh :592-615): out = -cumsum over the k blocks of n
    coefficients.  The top block of the result is zero for an exact division."""
    nl, total = coefs.shape
    k = total // n
    blocks = coefs.reshape(nl, k, n)
    out = []
    acc = None
    for i in range(k):
        acc = blocks[:, i] if acc is None else ftorch.add(ctx, acc, blocks[:, i])
        out.append(ftorch.neg(ctx, acc))
    return torch.stack(out, dim=1).reshape(nl, total)


def _affine_then(ctx: FieldCtx):
    """Composition of affine maps s -> m*s + a held as pairs (m, a): l then r
    is s -> r_m*(l_m*s + l_a) + r_a."""
    def op(l, r):
        lm, la = l
        rm, ra = r
        return (ftorch.mont_mul(ctx, lm, rm),
                ftorch.add(ctx, ftorch.mont_mul(ctx, rm, la), ra))
    return op


def div_by_x_minus(ctx: FieldCtx, coefs, xi_mont):
    """Synthetic division by (X - xi): (quotient of the same length with a
    zero top coefficient, remainder (NL, 1)).

    Horner over the reversed coefficients, s -> s*xi + c, is a prefix scan of
    affine compositions; its k-th value is the quotient coefficient n-2-k and
    the last one the remainder."""
    nl, n = coefs.shape
    rev = coefs.flip(1)
    m = xi_mont.expand(nl, n)
    _, horner = ftorch.assoc_scan(_affine_then(ctx), (m, rev))
    q_rev = torch.cat([torch.zeros_like(horner[:, :1]), horner[:, :-1]], dim=1)
    return q_rev.flip(1), horner[:, -1:]


def shift_coefs(ctx: FieldCtx, coefs, k: int):
    """Multiply by X^k (prepend k zero coefficients)."""
    return torch.nn.functional.pad(coefs, (k, 0))


def pad_to(coefs, n: int):
    m = coefs.shape[1]
    if m >= n:
        return coefs[:, :n]
    return torch.nn.functional.pad(coefs, (0, n - m))


def div_by_zerofier(ctx: FieldCtx, coefs, m: int, beta_plain: int):
    """Exact division by (X^m - beta) (reference polynomial.js divByZerofier
    :617-674).  Returns a tensor of the same length whose top m coefficients
    are zero when the division is exact.

    The recurrence q_k = (q_{k-m} - p_k) * beta^-1 runs independently per
    residue class mod m; along each chain it is the affine map
    q_j = q_{j-1}*binv - p_j*binv, scanned in log depth."""
    fp = ctx.fp
    nl, total = coefs.shape
    binv_m = scalar_arr(ctx, pow(beta_plain % fp.p, fp.p - 2, fp.p), coefs.device)
    nblk = -(-total // m)
    x = torch.nn.functional.pad(coefs, (0, nblk * m - total))
    # chains: index k = j*m + r  ->  (NL, nblk, m), scan over j (axis 1)
    xb = x.reshape(nl, nblk, m)
    a = ftorch.neg(ctx, ftorch.mont_mul(ctx, xb, binv_m[:, :, None]))
    mm = binv_m[:, :, None].expand(a.shape)
    _, q = ftorch.assoc_scan(_affine_then(ctx), (mm, a))
    return q.reshape(nl, nblk * m)[:, :total]


def lagrange_interp_host(fp, xs, ys):
    """Small Lagrange interpolation on host bigints (reference
    polynomial.js:896-930).  Returns the plain-int coefficient list."""
    p = fp.p
    n = len(xs)
    coefs = [0] * n
    for i in range(n):
        num = zerofier_host(fp, [xs[j] for j in range(n) if j != i])
        den = 1
        for j in range(n):
            if j != i:
                den = den * (xs[i] - xs[j]) % p
        scale = ys[i] * pow(den, p - 2, p) % p
        for k in range(len(num)):
            coefs[k] = (coefs[k] + num[k] * scale) % p
    return coefs


def zerofier_host(fp, roots):
    """prod (X - r_i) expanded on host bigints (polynomial.js:932-948)."""
    p = fp.p
    coefs = [1]
    for r in roots:
        new = [0] * (len(coefs) + 1)
        for k, c in enumerate(coefs):
            new[k + 1] = (new[k + 1] + c) % p
            new[k] = (new[k] - c * r) % p
        coefs = new
    return coefs


def add_many(ctx: FieldCtx, terms, length: int):
    """Sum of [(coefs, weight_mont_or_None), ...] padded to `length`."""
    acc = None
    for coefs, w in terms:
        c = pad_to(coefs, length)
        if w is not None:
            c = ftorch.mont_mul(ctx, c, w)
        acc = c if acc is None else ftorch.add(ctx, acc, c)
    return acc
