"""Plain radix-2 NTT over a reference `Field`, in natural order.

ntt(x)[k] = sum_j x[j] w^(jk), w the field's 2^log2(n)-th root; intt is its
inverse.  Elements in Montgomery form, (L, n) int64 limbs.  A bit-reversal
permutation, then log2(n) butterfly stages, each one vectorised over the
whole array.
"""

from __future__ import annotations

import torch

from .field import Field


def _bitrev(n: int, device) -> torch.Tensor:
    k = n.bit_length() - 1
    i = torch.arange(n, device=device)
    r = torch.zeros_like(i)
    for b in range(k):
        r |= ((i >> b) & 1) << (k - 1 - b)
    return r


def ntt(F: Field, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    L, n = x.shape
    k = n.bit_length() - 1
    if n != 1 << k or k > F.s:
        raise ValueError(f"no NTT of size {n} over this field")
    root = F.w[k]
    if inverse:
        root = pow(root, -1, F.p)
    tw = F.powers(root, max(n // 2, 1), x.device)
    a = x[:, _bitrev(n, x.device)]
    m = 1
    while m < n:
        blocks = a.reshape(L, n // (2 * m), 2, m)
        u, v = blocks[:, :, 0], blocks[:, :, 1]
        v = F.mont_mul(v, tw[:, None, ::n // (2 * m)])
        a = torch.stack([F.add(u, v), F.sub(u, v)], dim=2).reshape(L, n)
        m *= 2
    if inverse:
        a = F.mont_mul(a, F.const(pow(n, -1, F.p) * F.R, a.device))
    return a
