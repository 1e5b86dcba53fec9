"""Prime-field arithmetic on torch tensors (port of snarkjs_tpu/fields/fjnp.py).

Representation: a batch of field elements is an int32 tensor of shape
``(NL, *batch)``: 16-bit limbs, limb-major, the layout of the JAX package's
uint32 arrays (torch's uint32 lacks `+` and `>>`, and a 16-bit limb fits
int32 exactly; `to_numpy` gives the uint32 view back).  Montgomery form
where fjnp keeps Montgomery form.

Every op dispatches on the device of its operands, as fjnp's `_*_impl`
dispatch to Pallas: a CUDA tensor goes to kernel K-field (`fcuda`), a CPU
tensor to the plain version below, which computes limbs in int64 (a 16x16
product and a column sum of 2*NL of them fit easily; products with the
constants p and -p^-1 as exact float64 matmuls) and resolves carries a round
at a time across all limbs (`_normalize`).  `plain_versions()`
runs the plain versions on any device; it exists so a run on the card can
hold the kernels against them, and nothing on the prover's path enters it.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from . import fcuda
from .params import LIMB_BITS, LIMB_MASK, FieldParams, get_params

DTYPE = torch.int32


class FieldCtx:
    """Constants for one prime field, shaped for limb-major math."""

    def __init__(self, fp: FieldParams):
        self.fp = fp
        self.nl = fp.nl
        self.p_np = np.array(fp.limbs(fp.p), dtype=np.int64)
        self.pinv_np = np.array(fp.limbs(fp.pinv_neg), dtype=np.int64)
        self.r2_np = np.array(fp.limbs(fp.R2), dtype=np.int64)
        self.one_np = np.array(fp.limbs(fp.one_mont), dtype=np.int64)
        # Toeplitz matrices of -p^-1 (low NL columns) and p (2 NL columns):
        # a product of limbs with either is one matmul
        k, i = np.arange(2 * self.nl)[:, None], np.arange(self.nl)[None, :]
        toe = lambda v, rows: np.where((k[:rows] >= i) & (k[:rows] - i < self.nl),
                                       v[np.clip(k[:rows] - i, 0, self.nl - 1)], 0)
        self.pinv_toe = toe(self.pinv_np, self.nl).astype(np.float64)
        self.p_toe = toe(self.p_np, 2 * self.nl).astype(np.float64)

    def _c(self, arr_np, like, dtype=DTYPE):
        return torch.as_tensor(arr_np, dtype=dtype, device=like.device).reshape(
            (self.nl,) + (1,) * (like.dim() - 1))

    def p(self, x, dtype=DTYPE):
        return self._c(self.p_np, x, dtype)

    def r2(self, x):
        return self._c(self.r2_np, x)

    def one(self, batch_shape=(), device="cpu"):
        t = torch.as_tensor(self.one_np, dtype=DTYPE, device=device)
        return t.reshape((self.nl,) + (1,) * len(batch_shape)).expand(
            (self.nl,) + tuple(batch_shape)).contiguous()

    def zero(self, batch_shape=(), device="cpu"):
        return torch.zeros((self.nl,) + tuple(batch_shape), dtype=DTYPE,
                           device=device)


@functools.lru_cache(maxsize=None)
def get_ctx(name_or_params) -> FieldCtx:
    if isinstance(name_or_params, str):
        return FieldCtx(get_params(name_or_params))
    return FieldCtx(name_or_params)


# ------------------------------------------------------------ dispatch

_PLAIN = [False]


@contextlib.contextmanager
def plain_versions():
    """Run every field op (and the kernels built on them) as its plain
    version, whatever the device.  For checking the kernels only."""
    _PLAIN.append(True)
    try:
        yield
    finally:
        _PLAIN.pop()


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor outside `plain_versions()`."""
    return t.device.type == "cuda" and not _PLAIN[-1]


def _bcast(*ts):
    shape = torch.broadcast_shapes(*[t.shape for t in ts])
    return [t.expand(shape).contiguous() for t in ts]


# ------------------------------------------------- plain limb primitives

def _carry_prop(cols):
    """Propagate carries across limb axis 0 (non-negative int64 columns).

    Returns (16-bit limbs as int64, same shape; final carry-out)."""
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[0])
    for k in range(cols.shape[0]):
        v = cols[k] + carry
        out[k] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return out, carry


def _conv(a, b, out_cols):
    """Column sums of the limb product a*b (int64, carries deferred)."""
    na, nb = a.shape[0], b.shape[0]
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    cols = torch.zeros((max(out_cols, na + nb - 1),) + batch,
                       dtype=torch.int64, device=a.device)
    for i in range(na):
        cols[i:i + nb] += a[i] * b
    return cols[:out_cols]


def _conv_const(toe, x):
    """Column sums of the limb product of x with a constant whose Toeplitz
    matrix is `toe`: one float64 matmul.  Each limb product is below 2^32 and
    each column a sum of at most 24 of them, so every sum is exact."""
    t = torch.as_tensor(toe, device=x.device)
    out = t @ x.reshape(x.shape[0], -1).to(torch.float64)
    return out.to(torch.int64).reshape((t.shape[0],) + tuple(x.shape[1:]))


def _normalize(cols):
    """Exact base-2^16 form of int64 limb columns of any sign: (limbs in
    [0, 2^16), the carry out of the top limb, negative for a borrow).  Every
    column hands its carry one limb up a round, all columns at once; the
    rounds end when no carry is left (a few, but for a run of 0xFFFF limbs)."""
    top = torch.zeros_like(cols[0])
    while True:
        hi = cols >> LIMB_BITS
        if not bool(hi.any()):
            return cols, top
        cols = cols & LIMB_MASK
        cols[1:] += hi[:-1]
        top = top + hi[-1]


def _cond_sub_p(ctx, limbs, carry):
    """(carry*R + limbs) < 2p  ->  [0, p)."""
    diff, top = _normalize(limbs - ctx.p(limbs, torch.int64))
    use_diff = (carry + top) >= 0
    return torch.where(use_diff[None], diff, limbs)


# ------------------------------------------------------- plain versions

def _i64(t):
    return t.to(torch.int64)


def _add_plain(ctx, a, b):
    s, carry = _normalize(_i64(a) + _i64(b))
    return _cond_sub_p(ctx, s, carry).to(DTYPE)


def _sub_plain(ctx, a, b):
    d, top = _normalize(_i64(a) - _i64(b))
    fixed, _ = _normalize(d + ctx.p(d, torch.int64))
    return torch.where((top < 0)[None], fixed, d).to(DTYPE)


def _neg_plain(ctx, a):
    a = _i64(a)
    d, _ = _normalize(ctx.p(a, torch.int64) - a)
    return torch.where(is_zero(ctx, a)[None], torch.zeros_like(a), d).to(DTYPE)


def _mont_mul_plain(ctx, a, b):
    """a*b*R^-1 mod p for a < R, b < p (fjnp._mont_mul_impl's XLA path)."""
    n = ctx.nl
    a, b = _i64(a), _i64(b)
    t, t_top = _normalize(_conv(a, b, 2 * n))
    m, _ = _normalize(_conv_const(ctx.pinv_toe, t[:n]))
    mp, _ = _normalize(_conv_const(ctx.p_toe, m))
    # m p = -t mod R, so the low halves of t and m p sum to 0 or to R: the
    # carry into the high half is 1 exactly when t's low half is nonzero
    cols = mp[n:] + t[n:]
    cols[0] += (t[:n] != 0).any(dim=0)
    u, carry = _normalize(cols)
    return _cond_sub_p(ctx, u, carry + t_top).to(DTYPE)


# ------------------------------------------------------------ public ops

def add(ctx: FieldCtx, a, b):
    if use_kernel(a):
        return fcuda.launch("add", ctx.fp, *_bcast(a, b))
    return _add_plain(ctx, a, b)


def sub(ctx: FieldCtx, a, b):
    if use_kernel(a):
        return fcuda.launch("sub", ctx.fp, *_bcast(a, b))
    return _sub_plain(ctx, a, b)


def neg(ctx: FieldCtx, a):
    if use_kernel(a):
        return fcuda.launch("neg", ctx.fp, a.contiguous())
    return _neg_plain(ctx, a)


def mont_mul(ctx: FieldCtx, a, b):
    """Montgomery product a*b*R^-1 mod p.  a < R, b < p; output in [0, p)."""
    if use_kernel(a):
        return fcuda.launch("mont_mul", ctx.fp, *_bcast(a, b))
    return _mont_mul_plain(ctx, a, b)


def mont_sqr(ctx: FieldCtx, a):
    return mont_mul(ctx, a, a)


def to_mont(ctx: FieldCtx, a):
    return mont_mul(ctx, a, ctx.r2(a))


def from_mont(ctx: FieldCtx, a):
    one_plain = torch.zeros((ctx.nl,) + (1,) * (a.dim() - 1), dtype=DTYPE,
                            device=a.device)
    one_plain[0] = 1
    return mont_mul(ctx, a, one_plain)


def is_zero(ctx: FieldCtx, a):
    return (a == 0).all(dim=0)


def eq(ctx: FieldCtx, a, b):
    return (a == b).all(dim=0)


# ------------------------------------------------- scans, powers, inverses

def assoc_scan(op, elems):
    """Inclusive scan along axis 1 in log depth (the port's stand-in for
    jax.lax.associative_scan).  `elems` is a tensor or a tuple of tensors of
    one shape; `op(left, right)` combines two such values elementwise and must
    be associative.  Step k combines every element with the one k places
    before it, so the field ops inside `op` run ceil(log2 n) times."""
    single = isinstance(elems, torch.Tensor)
    xs = (elems,) if single else tuple(elems)
    n = xs[0].shape[1]
    k = 1
    while k < n:
        left = tuple(x[:, :n - k] for x in xs)
        right = tuple(x[:, k:] for x in xs)
        comb = op(left[0], right[0]) if single else op(left, right)
        comb = (comb,) if single else tuple(comb)
        xs = tuple(torch.cat([x[:, :k], c], dim=1) for x, c in zip(xs, comb))
        k *= 2
    return xs[0] if single else xs


def exp_const(ctx: FieldCtx, a, e: int):
    """a^e for a Python-int exponent (Montgomery in and out): square and
    multiply from the top bit.  e = 0 gives one."""
    if e == 0:
        return ctx.one(a.shape[1:], a.device)
    r = None
    for bit in bin(e)[2:]:
        if r is not None:
            r = mont_sqr(ctx, r)
        if bit == "1":
            r = a if r is None else mont_mul(ctx, r, a)
    return r


def inv(ctx: FieldCtx, a):
    """a^-1 by Fermat's exponent p - 2.  0 -> 0."""
    return exp_const(ctx, a, ctx.fp.p - 2)


def batch_inverse(ctx: FieldCtx, a, axis: int = -1):
    """Montgomery batch inversion along `axis` (a batch axis, never the limb
    axis 0): prefix and suffix products by two log-depth scans and one
    inversion of the total.  Zeros map to zeros, as in fjnp.batch_inverse."""
    if axis < 0:
        axis += a.dim()
    if axis == 0:
        raise ValueError("axis 0 is the limb axis")
    x = a.movedim(axis, 1)
    zmask = is_zero(ctx, x)
    one = ctx.one((1,) * (x.dim() - 1), x.device)
    ax = torch.where(zmask[None], one, x)
    mul = lambda l, r: mont_mul(ctx, l, r)
    pref = assoc_scan(mul, ax)
    suf = assoc_scan(mul, ax.flip(1)).flip(1)
    tinv = inv(ctx, pref[:, -1:].contiguous())
    edge = one.expand((ctx.nl, 1) + tuple(x.shape[2:]))
    pref_shift = torch.cat([edge, pref[:, :-1]], dim=1)
    suf_shift = torch.cat([suf[:, 1:], edge], dim=1)
    out = mont_mul(ctx, mont_mul(ctx, pref_shift, suf_shift), tinv)
    out = torch.where(zmask[None], torch.zeros_like(out), out)
    return out.movedim(1, axis)


# ------------------------------------------- host <-> tensor conversions

def np_from_int(fp: FieldParams, v: int) -> np.ndarray:
    return np.array(fp.limbs(v % fp.p), dtype=np.uint32)


def np_from_ints(fp: FieldParams, vs) -> np.ndarray:
    """list of ints -> (NL, N) uint32 (reduced mod p)."""
    buf = b"".join((int(v) % fp.p).to_bytes(fp.n8, "little") for v in vs)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(vs), fp.nl)
    return np.ascontiguousarray(u16.T).astype(np.uint32)


def np_to_ints(fp: FieldParams, arr) -> list:
    """(NL, ...) limbs (numpy or tensor) -> list of ints."""
    arr = to_numpy(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)
    flat = arr.reshape(fp.nl, -1).astype("<u2").T
    data = np.ascontiguousarray(flat).tobytes()
    n8 = 2 * fp.nl
    return [int.from_bytes(data[j * n8:(j + 1) * n8], "little")
            for j in range(flat.shape[0])]


def to_tensor(arr, device) -> torch.Tensor:
    """uint32 limb array -> int32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array (the JAX package's layout)."""
    return t.detach().cpu().numpy().astype(np.uint32)
