"""Base-field adapters for the curve point code (port of
snarkjs_tpu/curves/gops.py).

`FqOps` is the element-arithmetic interface that `jac`, `rcb` and the MSM
are generic over: G1 uses plain Fq (`FqOps`), G2 the quadratic extension
(`Fq2Ops`, Karatsuba: three Montgomery products a product, u^2 = -1 on both
supported curves).  An Fq element is a (NL, *batch) int32 limb tensor, an
Fq2 element a pair of them.  Every op goes through `ftorch`, so on a CUDA
tensor it launches K-field and on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from ..fields import ftorch
from ..fields.ftorch import FieldCtx


class FqOps:
    def __init__(self, ctx: FieldCtx, device):
        self.ctx = ctx
        self.nl = ctx.nl
        self.device = torch.device(device)

    def add(self, a, b):
        return ftorch.add(self.ctx, a, b)

    def sub(self, a, b):
        return ftorch.sub(self.ctx, a, b)

    def neg(self, a):
        return ftorch.neg(self.ctx, a)

    def mul(self, a, b):
        return ftorch.mont_mul(self.ctx, a, b)

    def sqr(self, a):
        return ftorch.mont_mul(self.ctx, a, a)

    def dbl(self, a):
        return ftorch.add(self.ctx, a, a)

    def is_zero(self, a):
        return ftorch.is_zero(self.ctx, a)

    def zero(self, batch_shape=()):
        return self.ctx.zero(batch_shape, self.device)

    def one(self, batch_shape=()):
        return self.ctx.one(batch_shape, self.device)

    def select(self, mask, a, b):
        """mask: batch-shaped bool; where(mask, a, b)."""
        return torch.where(mask[None], a, b)

    def batch_shape(self, a):
        return tuple(a.shape[1:])

    def gather(self, a, idx):
        return a[:, idx]

    def put(self, a, idx, v):
        """a[idx] = v over the batch axis, in place."""
        a[:, idx] = v

    def stack_last(self, elems):
        return torch.stack(elems, dim=-1)

    def batch_inv(self, a):
        return ftorch.batch_inverse(self.ctx, a, axis=-1)


class Fq2Ops:
    """Fq2 = Fq[u]/(u^2+1), which holds for bn254 and bls12-381."""

    def __init__(self, ctx: FieldCtx, device):
        self.ctx = ctx
        self.fq = FqOps(ctx, device)
        self.nl = ctx.nl

    def add(self, a, b):
        return (self.fq.add(a[0], b[0]), self.fq.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.fq.sub(a[0], b[0]), self.fq.sub(a[1], b[1]))

    def neg(self, a):
        return (self.fq.neg(a[0]), self.fq.neg(a[1]))

    def mul(self, a, b):
        m0 = self.fq.mul(a[0], b[0])
        m1 = self.fq.mul(a[1], b[1])
        m2 = self.fq.mul(self.fq.add(a[0], a[1]), self.fq.add(b[0], b[1]))
        re = self.fq.sub(m0, m1)
        im = self.fq.sub(m2, self.fq.add(m0, m1))
        return (re, im)

    def sqr(self, a):
        # (a0+a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        re = self.fq.mul(self.fq.add(a[0], a[1]), self.fq.sub(a[0], a[1]))
        im = self.fq.dbl(self.fq.mul(a[0], a[1]))
        return (re, im)

    def dbl(self, a):
        return (self.fq.dbl(a[0]), self.fq.dbl(a[1]))

    def is_zero(self, a):
        return self.fq.is_zero(a[0]) & self.fq.is_zero(a[1])

    def zero(self, batch_shape=()):
        return (self.fq.zero(batch_shape), self.fq.zero(batch_shape))

    def one(self, batch_shape=()):
        return (self.fq.one(batch_shape), self.fq.zero(batch_shape))

    def select(self, mask, a, b):
        return (self.fq.select(mask, a[0], b[0]), self.fq.select(mask, a[1], b[1]))

    def batch_shape(self, a):
        return tuple(a[0].shape[1:])

    def gather(self, a, idx):
        return (a[0][:, idx], a[1][:, idx])

    def put(self, a, idx, v):
        self.fq.put(a[0], idx, v[0])
        self.fq.put(a[1], idx, v[1])

    def stack_last(self, elems):
        return (torch.stack([e[0] for e in elems], dim=-1),
                torch.stack([e[1] for e in elems], dim=-1))

    def batch_inv(self, a):
        # (a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2)
        norm = self.fq.add(self.fq.sqr(a[0]), self.fq.sqr(a[1]))
        t = self.fq.batch_inv(norm)
        return (self.fq.mul(a[0], t), self.fq.neg(self.fq.mul(a[1], t)))


def field_ops(ctx: FieldCtx, ext: int, device):
    """FqOps for G1 (ext = 1), Fq2Ops for G2 (ext = 2)."""
    return FqOps(ctx, device) if ext == 1 else Fq2Ops(ctx, device)
