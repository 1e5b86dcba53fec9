"""Radix-2 NTT/iNTT over Fr, matching ffjavascript's FFT semantics
(port of snarkjs_tpu/ntt/ntt.py).

* ``ntt(a)[i] = P(w^i)`` in natural order, ``w = Fr.w[log2(n)]``.
* ``intt`` is the exact inverse (scaled by n^-1, using w^-1).
* Values stay in Montgomery form throughout.
* ``apply_powers``: x_i *= first*inc^i (Fr.batchApplyKey), used for the
  Groth16 coset shift.

Layout (NL, n) limb-major int32.  On the card, transforms of 2^12 and up go
to the digit-matmul NTT (`ntt_mm`, kernel K-mm-norm), as the JAX package routes
them to its MXU NTT on the TPU; smaller ones run the butterflies below, whose
field ops are kernel K-field.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..device import upload
from ..fields import ftorch
from ..fields.ftorch import FieldCtx
from ..fields.params import get_params

MM_MIN_LOG = 12


def bit_reverse_perm(k: int) -> np.ndarray:
    """Permutation p with p[i] = bitreverse_k(i)."""
    n = 1 << k
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


@trace.table
def _twiddles(field_name: str, k: int, inverse: bool):
    """Per-stage twiddle tables, Montgomery form, numpy (NL, m) for stage m."""
    fp = get_params(field_name)
    root = fp.winv[k] if inverse else fp.w[k]
    tables = []
    for s in range(1, k + 1):
        m = 1 << (s - 1)
        ws = pow(root, 1 << (k - s), fp.p)
        tw, cur = [], 1
        for _ in range(m):
            tw.append(fp.to_mont(cur))
            cur = cur * ws % fp.p
        tables.append(ftorch.np_from_ints(fp, tw))
    return tables


@trace.table
def _n_inv_mont(field_name: str, k: int):
    fp = get_params(field_name)
    return ftorch.np_from_ints(fp, [fp.to_mont(pow(1 << k, fp.p - 2, fp.p))])


def _ntt_core(ctx: FieldCtx, a, k: int, inverse: bool):
    n = 1 << k
    nl = ctx.nl
    dev = a.device
    x = a[:, upload(torch.from_numpy(bit_reverse_perm(k)), dev)]
    tables = _twiddles(ctx.fp.name, k, inverse)
    for s in range(1, k + 1):
        m = 1 << (s - 1)
        tw = ftorch.to_tensor(tables[s - 1], dev).reshape(nl, 1, m)
        x = x.reshape(nl, n // (2 * m), 2 * m)
        lo, hi = x[:, :, :m], x[:, :, m:]
        t = ftorch.mont_mul(ctx, hi, tw)
        x = torch.cat([ftorch.add(ctx, lo, t), ftorch.sub(ctx, lo, t)], dim=2)
    x = x.reshape(nl, n)
    if inverse:
        x = ftorch.mont_mul(ctx, x, ftorch.to_tensor(
            _n_inv_mont(ctx.fp.name, k), dev))
    return x


def _use_mm(a, k: int) -> bool:
    return a.device.type == "cuda" and k >= MM_MIN_LOG


def _log2(n: int) -> int:
    k = n.bit_length() - 1
    assert 1 << k == n, "size must be a power of two"
    return k


def ntt(ctx: FieldCtx, a):
    """Forward NTT: coefficients -> evaluations at powers of w (natural order)."""
    k = _log2(a.shape[-1])
    assert k <= ctx.fp.s, f"domain 2^{k} exceeds field 2-adicity {ctx.fp.s}"
    if k == 0:
        return a
    if _use_mm(a, k):
        from . import ntt_mm

        return ntt_mm.ntt(ctx, a)
    return _ntt_core(ctx, a, k, inverse=False)


def intt(ctx: FieldCtx, a):
    """Inverse NTT: evaluations -> coefficients."""
    k = _log2(a.shape[-1])
    if k == 0:
        return a
    if _use_mm(a, k):
        from . import ntt_mm

        return ntt_mm.intt(ctx, a)
    return _ntt_core(ctx, a, k, inverse=True)


@trace.table
def _power_blocks(field_name: str, first: int, inc: int, n: int):
    """Host tables for powers first*inc^i as a b x b outer product:
    lo[j] = first*inc^j (j < b), hi[i] = inc^(b*i)."""
    fp = get_params(field_name)
    b = 1 << ((n.bit_length()) // 2 if n > 1 else 0)
    b = max(1, min(b, n))
    nhi = -(-n // b)
    lo, cur = [], first % fp.p
    for _ in range(b):
        lo.append(fp.to_mont(cur))
        cur = cur * inc % fp.p
    inc_b = pow(inc, b, fp.p)
    hi, cur = [], 1
    for _ in range(nhi):
        hi.append(fp.to_mont(cur))
        cur = cur * inc_b % fp.p
    return b, ftorch.np_from_ints(fp, lo), ftorch.np_from_ints(fp, hi)


def apply_powers(ctx: FieldCtx, a, first: int, inc: int):
    """x_i *= first * inc^i (first/inc plain ints): one Montgomery multiply
    builds the power table from two sqrt(n) host tables, one more applies it."""
    fp = ctx.fp
    n = a.shape[-1]
    b, lo, hi = _power_blocks(fp.name, first % fp.p, inc % fp.p, n)
    nhi = -(-n // b)
    loj = ftorch.to_tensor(lo, a.device).reshape(ctx.nl, 1, b)
    hij = ftorch.to_tensor(hi, a.device).reshape(ctx.nl, nhi, 1)
    powers = ftorch.mont_mul(ctx, hij, loj).reshape(ctx.nl, nhi * b)[:, :n]
    return ftorch.mont_mul(ctx, a, powers)


def coset_shift(ctx: FieldCtx, coeffs, inc: int | None = None):
    """Multiply coefficient i by inc^i, by default the Groth16 odd-coset
    increment (w[power+1] if it exists, else Fr.shift)."""
    k = coeffs.shape[-1].bit_length() - 1
    fp = ctx.fp
    if inc is None:
        inc = fp.w[k + 1] if k < fp.s else fp.shift
    return apply_powers(ctx, coeffs, 1, inc)


def extend_evaluations(ctx: FieldCtx, coeffs, factor: int = 4):
    """Zero-pad coefficients to factor*n and evaluate (Evaluations.fromPolynomial,
    reference src/polynomial/evaluations.js:30-37)."""
    n = coeffs.shape[1]
    return ntt(ctx, torch.nn.functional.pad(coeffs, (0, (factor - 1) * n)))


# --------- one level beyond the field's 2-adicity (size 2^(s+1)) ---------

def _mont_scalar(ctx: FieldCtx, v: int, device):
    fp = ctx.fp
    return ftorch.to_tensor(ftorch.np_from_int(fp, fp.to_mont(v % fp.p)),
                            device).reshape(fp.nl, 1)


def intt_union(ctx: FieldCtx, a, s_log: int | None = None,
               shift: int | None = None):
    """Inverse transform of size 2m = 2^(s_log+1) over the union domain
    D = H u shift*H (H = the 2^s_log roots of unity), the reference's shift
    decomposition for sizes one level past the field's 2-adicity
    (src/powersoftau_preparephase2.js:91-138):

        t0_i = (t_i*shift^m - t_{m+i}) / (shift^m - 1)
        t1_i = (t_{m+i} - t_i) * shift^-i / (shift^m - 1)
        out  = [intt(t0), intt(t1)]

    a: (NL, 2m) evaluations [f(w^i)..., f(shift*w^i)...], Montgomery."""
    fp = ctx.fp
    s_log = fp.s if s_log is None else s_log
    shift = fp.shift if shift is None else shift
    m = a.shape[-1] // 2
    assert m == 1 << s_log, "size must be 2^(s_log+1)"
    p = fp.p
    S = pow(shift, m, p)
    d = pow((S - 1) % p, p - 2, p)
    t, tm = a[:, :m], a[:, m:]
    Sm = _mont_scalar(ctx, S, a.device)
    dm = _mont_scalar(ctx, d, a.device)
    t0 = ftorch.mont_mul(ctx, ftorch.sub(ctx, ftorch.mont_mul(ctx, t, Sm), tm), dm)
    t1 = apply_powers(ctx, ftorch.sub(ctx, tm, t), d, pow(shift, p - 2, p))
    return torch.cat([intt(ctx, t0), intt(ctx, t1)], dim=-1)


def ntt_union(ctx: FieldCtx, a, s_log: int | None = None,
              shift: int | None = None):
    """Forward counterpart of intt_union: coefficient blocks [c0, c1] ->
    evaluations on H u shift*H:  t_i = u_i + shift^i*v_i,
    t_{m+i} = u_i + shift^m*shift^i*v_i  with u = ntt(c0), v = ntt(c1)."""
    fp = ctx.fp
    s_log = fp.s if s_log is None else s_log
    shift = fp.shift if shift is None else shift
    m = a.shape[-1] // 2
    assert m == 1 << s_log, "size must be 2^(s_log+1)"
    S = pow(shift, m, fp.p)
    u = ntt(ctx, a[:, :m])
    v = apply_powers(ctx, ntt(ctx, a[:, m:]), 1, shift)
    t = ftorch.add(ctx, u, v)
    tm = ftorch.add(ctx, u, ftorch.mont_mul(ctx, v, _mont_scalar(ctx, S, a.device)))
    return torch.cat([t, tm], dim=-1)
