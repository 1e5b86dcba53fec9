"""Digit-matmul NTT over Fr (port of snarkjs_tpu/ntt/ntt_mxu.py).

A size-2^k NTT is split four-step style into DFT-matrix products of size
<= 1024 (`_ntt_last`), the fewest such stages with radices within a factor
of two of each other (`_split`).  Field elements enter each product as balanced
signed 8-bit digits, so an r x r product over Fp becomes nd x nd int8
digit-pair products accumulated into 2*nd - 1 int32 columns, then normalized
back to canonical 16-bit limbs (`_normalize_cols`: the carry pass
`_carry_digits`, then `_reduce_digits`: high-digit fold, Barrett).  The DFT
matrices hold plain residues; data stays in Montgomery form because
sum w*(xR) = (sum w*x)*R.  What a stage reads besides its data, the DFT
matrix and the twiddle parts, goes to a device once (`_w_matrix_on`,
`_twiddle_parts_on`).

`digit_mm_norm` replaces ntt_mxu._pallas_mm_norm: the product with the
normalisation as the kernel's epilogue (kernel K-mm-norm,
csrc/digit_mm_norm.cu), so the columns never reach device memory as int32.
Its plain version is `_normalize_cols(fp, digit_mm_plain(W8, D8))`; the
counter `k_mm_norm` of `trace` counts its launches.  It is the one route of
every stage (`_mm_stage`).

`digit_mm` is the hand-written counterpart of ntt_mxu._pallas_mm: the
columns alone (kernel K-mm, csrc/digit_mm.cu).  No route of the program
calls it; it is kept and held against its plain version, the same sum as
exact matmuls: int64 on the CPU, float64 on the card (every column is below
2^31 < 2^53, and torch has no general integer GEMM on CUDA).  The counter
`k_mm` counts K-mm launches.

Both kernels share one tensor-core main loop (csrc/digit_mma.cuh), which
wants the summed index y contiguous in both operands: W8 (nd, r, q) has it,
the data digits are handed over as (nd, m, q).  The NTT keeps the axis it
transforms innermost (`_ntt_last`), so its digits come out in that layout
(`y_major=True`); the wrappers' default is the JAX package's (nd, q, m),
which they transpose once (`_y_major`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build, trace
from ..device import upload
from ..fields import ftorch
from ..fields.ftorch import FieldCtx
from ..fields.params import FieldParams, get_params

MAX_LOG_R = 10          # largest direct DFT matmul: 1024 x 1024
NORM_TILE_ROWS = 64     # output rows of a K-mm-norm tile (csrc/digit_mma.cuh TK)


def _nd(fp: FieldParams) -> int:
    """Signed digits per element: one more than the byte length."""
    return fp.n8 + 1


# ------------------------------------------------------------------ host math

def _balanced_digits_int(v: int, nd: int):
    """v >= 0 -> nd signed base-256 digits in [-128, 127]."""
    out = []
    for _ in range(nd):
        d = v & 0xFF
        if d >= 128:
            d -= 256
        out.append(d)
        v = (v - d) >> 8
    assert v == 0, "value too large for digit count"
    return out


def _digits_np(vals, nd: int) -> np.ndarray:
    out = np.empty((len(vals), nd), dtype=np.int8)
    for i, v in enumerate(vals):
        out[i] = _balanced_digits_int(int(v), nd)
    return out


def _root_powers(fp: FieldParams, root: int, n: int):
    out = [1] * n
    cur = 1
    for i in range(1, n):
        cur = cur * root % fp.p
        out[i] = cur
    return out


@trace.table
def _w_matrix_digits(field_name: str, k: int, inverse: bool) -> np.ndarray:
    """(nd, r, r) int8: balanced digits of the size-2^k DFT matrix (plain
    residues); the inverse folds in r^-1."""
    fp = get_params(field_name)
    r = 1 << k
    nd = _nd(fp)
    root = fp.winv[k] if inverse else fp.w[k]
    pows = _root_powers(fp, root, r)
    if inverse:
        scale = pow(r, fp.p - 2, fp.p)
        pows = [v * scale % fp.p for v in pows]
    digs = _digits_np(pows, nd)
    idx = np.outer(np.arange(r, dtype=np.int64),
                   np.arange(r, dtype=np.int64)) % r
    return np.ascontiguousarray(digs[idx].transpose(2, 0, 1))


def _twiddle_parts(field_name: str, k: int, k1: int, inverse: bool):
    """Factored twiddles T[k2, j1] = w^(+-j1*k2) = A[k2 % s, j1] * B[k2 // s, j1]
    (Montgomery limbs), so the device builds T with one multiply."""
    fp = get_params(field_name)
    n = 1 << k
    n1 = 1 << k1
    k2 = k - k1
    n2 = n >> k1
    s = 1 << ((k2 + 1) // 2)
    root = fp.winv[k] if inverse else fp.w[k]

    def table(step, rows):
        # row r: root^(r * step * j1) for j1 < n1, a running product a row
        vals = []
        for r in range(rows):
            vals += _root_powers(fp, pow(root, r * step, fp.p), n1)
        return np.ascontiguousarray(ftorch.np_from_ints(
            fp, [fp.to_mont(v) for v in vals]).reshape(fp.nl, rows, n1))

    return s, table(1, s), table(s, n2 // s)


@trace.table
def _fold_tables(field_name: str, ncols: int):
    """(nh, F): F (nh+1, n8+1) int8 balanced digits of 2^(8*(n8+h)) mod p."""
    fp = get_params(field_name)
    ndig = fp.n8
    nh = ncols + 3 - ndig
    F = _digits_np([pow(256, ndig + h, fp.p) for h in range(nh + 1)], ndig + 1)
    return nh, F


@trace.table
def _barrett_consts(field_name: str, nh: int):
    """Barrett shift/mu, p limbs and the fold-compensation C = 128*(nh+1)*p
    as (nl+1)-limb tables."""
    fp = get_params(field_name)
    shift = fp.n8 * 8 - 6
    mu = (1 << (32 + shift)) // fp.p
    p_limbs = tuple(fp.limbs(fp.p)) + (0,)
    C = 128 * (nh + 1) * fp.p
    assert C < 1 << (16 * (fp.nl + 1))
    c_limbs = tuple((C >> (16 * i)) & 0xFFFF for i in range(fp.nl + 1))
    return shift, mu, p_limbs, c_limbs


def _exact_matmul(A, B):
    """Integer matmul of small-magnitude int tensors, exact: int64 on the
    CPU, float64 on the card (all sums here stay below 2^53)."""
    if A.device.type == "cpu":
        return torch.matmul(A.to(torch.int64), B.to(torch.int64))
    return torch.matmul(A.to(torch.float64), B.to(torch.float64)).to(torch.int64)


# ------------------------------------------------------------ digit codecs

def _to_digits(fp: FieldParams, a):
    """(nl, ...) 16-bit limbs -> (nd, ...) int8 balanced digits."""
    a = a.to(torch.int32)
    u = torch.stack([a & 0xFF, (a >> 8) & 0xFF], dim=1).reshape(
        (2 * fp.nl,) + a.shape[1:])
    ds = []
    c = torch.zeros_like(a[0])
    for d in range(2 * fp.nl):
        v = u[d] + c
        mneg = (v >= 128).to(torch.int32)
        ds.append(v - 256 * mneg)
        c = mneg
    ds.append(c)
    return torch.stack(ds).to(torch.int8)


def _y_major(D8):
    """Data digits (nd, q, m) -> (nd, m, q) contiguous: y, the index the
    product sums over, innermost, as the kernels' main loop reads it."""
    return D8.transpose(1, 2).contiguous()


def _carry_digits(cols):
    """(ncols, ...) int32 product columns -> (ncols + 3, ...) uint8 digits of
    sum_c cols[c]*256^c >= 0: the signed carry pass, in increasing c."""
    cols = cols.to(torch.int64)
    ncols = cols.shape[0]
    digs = []
    c = torch.zeros_like(cols[0])
    for i in range(ncols + 3):
        v = (cols[i] + c) if i < ncols else c
        digs.append(v & 0xFF)
        c = v >> 8
    return torch.stack(digs).to(torch.uint8)


def _normalize_cols(fp: FieldParams, cols):
    """(ncols, ...) int32 product columns -> (nl, ...) int32 limbs in [0, p).

    cols represent sum_c cols[c]*256^c >= 0."""
    return _reduce_digits(fp, _carry_digits(cols))


def _reduce_digits(fp: FieldParams, digs):
    """(ncols + 3, ...) uint8 digits of a value >= 0 -> (nl, ...) int32 limbs
    of it mod p."""
    digs = digs.to(torch.int64)
    ncols = digs.shape[0] - 3
    nl, ndig = fp.nl, fp.n8
    nh, F = _fold_tables(fp.name, ncols)
    lo, hi = digs[:ndig], digs[ndig:]
    # 2) balanced-recode the high digits, fold with the 2^(8(n8+h)) table
    hs = []
    hc = torch.zeros_like(digs[0])
    for d in range(nh):
        v = hi[d] + hc
        mneg = (v >= 128).to(torch.int64)
        hs.append(v - 256 * mneg)
        hc = mneg
    hs.append(hc)
    hi8 = torch.stack(hs)
    Ft = upload(torch.from_numpy(F.T.astype(np.int64)), digs.device)
    fold = _exact_matmul(Ft, hi8.reshape(nh + 1, -1)).reshape(
        (ndig + 1,) + digs.shape[1:])
    # 3) 16-bit limbs plus the compensation constant, signed carries
    shift, mu, p_limbs, c_limbs = _barrett_consts(fp.name, nh)
    c = torch.zeros_like(digs[0])
    limbs = []
    for i in range(nl + 1):
        d0 = lo[2 * i] if 2 * i < ndig else 0
        d1 = lo[2 * i + 1] if 2 * i + 1 < ndig else 0
        f0 = fold[2 * i] if 2 * i < ndig + 1 else 0
        f1 = fold[2 * i + 1] if 2 * i + 1 < ndig + 1 else 0
        v = d0 + f0 + ((d1 + f1) << 8) + c_limbs[i] + c
        limbs.append(v & 0xFFFF)
        c = v >> 16
    # 4) Barrett: q_hat = (V >> shift) * mu >> 32, V -= q_hat * p
    sl, sb = divmod(shift, 16)
    T = limbs[sl] >> sb
    for j in range(sl + 1, nl + 1):
        off = 16 * (j - sl) - sb
        if off < 22:
            T = T | (limbs[j] << off)
    mu_lo, mu_hi = mu & 0xFFFF, mu >> 16
    T_lo, T_hi = T & 0xFFFF, T >> 16
    mid = T_lo * mu_hi + T_hi * mu_lo + ((T_lo * mu_lo) >> 16)
    q = T_hi * mu_hi + (mid >> 16)
    q_lo, q_hi = q & 0xFFFF, q >> 16
    c = torch.zeros_like(q)
    sub = []
    for i in range(nl + 1):
        pim = p_limbs[i - 1] if i >= 1 else 0
        v = q_lo * p_limbs[i] + q_hi * pim + c
        sub.append(v & 0xFFFF)
        c = v >> 16
    b = torch.zeros_like(q)
    out = []
    for i in range(nl + 1):
        v = limbs[i] - sub[i] - b
        out.append(v & 0xFFFF)
        b = (v >> 16) & 1
    # 5) final conditional subtracts: V in [0, ~3p)
    for _ in range(2):
        bb = torch.zeros_like(q)
        diff = []
        for i in range(nl + 1):
            v = out[i] - p_limbs[i] - bb
            diff.append(v & 0xFFFF)
            bb = (v >> 16) & 1
        keep = bb.to(torch.bool)
        out = [torch.where(keep, o, d) for o, d in zip(out, diff)]
    return torch.stack(out[:nl]).to(ftorch.DTYPE)


# --------------------------------------------------------- K-mm and its twin

def digit_mm_plain(W8, D8):
    """cols[c] = sum_{i+j=c} W8[i] @ D8[j], as exact matmuls."""
    nd, r, q = W8.shape
    m = D8.shape[2]
    cols = []
    for c in range(2 * nd - 1):
        ii = [i for i in range(nd) if 0 <= c - i < nd]
        jj = [c - i for i in ii]
        Wc = W8[ii].permute(1, 0, 2).reshape(r, len(ii) * q)
        Dc = D8[jj].reshape(len(jj) * q, m)
        cols.append(_exact_matmul(Wc, Dc))
    return torch.stack(cols).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("digit_mm")
    lib.snark_digit_mm.restype = ctypes.c_int
    lib.snark_digit_mm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib


def _check_operands(what: str, W8, D8, y_major: bool):
    """Raises unless D8 fits W8 (nd, r, q); returns (nd, r, q, m)."""
    nd, r, q = W8.shape
    if (W8.dtype != torch.int8 or D8.dtype != torch.int8 or W8.device != D8.device
            or D8.dim() != 3 or D8.shape[0] != nd or D8.shape[2 if y_major else 1] != q):
        raise ValueError(f"{what} takes int8 W8 (nd, r, q) and D8 (nd, q, m), or "
                         "(nd, m, q) with y_major, on one device")
    return nd, r, q, D8.shape[1 if y_major else 2]


def digit_mm(W8, D8, y_major: bool = False):
    """W8 (nd, r, q) int8, D8 (nd, q, m) int8 -> (2nd-1, r, m) int32; with
    y_major D8 comes as (nd, m, q).

    CUDA tensors launch K-mm; CPU tensors take `digit_mm_plain`."""
    if not ftorch.use_kernel(D8):
        return digit_mm_plain(W8, D8.transpose(1, 2) if y_major else D8)
    nd, r, q, m = _check_operands("K-mm", W8, D8, y_major)
    W8, DT = W8.contiguous(), D8.contiguous() if y_major else _y_major(D8)
    out = torch.empty((2 * nd - 1, r, m), dtype=torch.int32, device=D8.device)
    if out.numel():
        err = _lib().snark_digit_mm(W8.data_ptr(), DT.data_ptr(), out.data_ptr(),
                                    nd, r, q, m, _build.stream_ptr(D8.device))
        _build.check(err, "K-mm")
        trace.add("k_mm")
    return out


# ----------------------------------------------------- K-mm-norm and its twin

def digit_mm_norm_plain(fp: FieldParams, W8, D8):
    """Canonical limbs of sum_c cols[c]*256^c mod p, the columns in memory."""
    return _normalize_cols(fp, digit_mm_plain(W8, D8))


@trace.table
def _norm_consts(field_name: str) -> bytes:
    """The kernel's per-field tables as the bytes of its argument struct:
    F (nh+1, n8+1) int8 row-major, padded to a multiple of 4; then p and the
    compensation constant as nl+1 int32 limbs each; then mu as one u32."""
    fp = get_params(field_name)
    nh, F = _fold_tables(field_name, 2 * _nd(fp) - 1)
    shift, mu, p_limbs, c_limbs = _barrett_consts(field_name, nh)
    if shift != fp.n8 * 8 - 6 or not 0 < mu < 1 << 32:
        raise ValueError("K-mm-norm: unexpected Barrett constants")
    fb = np.ascontiguousarray(F, dtype=np.int8).tobytes()
    fb += b"\0" * (-len(fb) % 4)
    words = np.array(list(p_limbs) + list(c_limbs) + [mu], dtype="<u4")
    return fb + words.tobytes()


@functools.lru_cache(maxsize=None)
def _norm_lib():
    lib = _build.library("digit_mm_norm")
    lib.snark_digit_mm_norm.restype = ctypes.c_int
    lib.snark_digit_mm_norm.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
        + [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
    lib.snark_digit_mm_norm_scratch_bytes.restype = ctypes.c_longlong
    lib.snark_digit_mm_norm_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.snark_digit_mm_norm_consts_bytes.restype = ctypes.c_int
    lib.snark_digit_mm_norm_consts_bytes.argtypes = []
    return lib


def digit_mm_norm(fp: FieldParams, W8, D8, y_major: bool = False):
    """W8 (nd, r, q) int8, D8 (nd, q, m) int8 -> (nl, r, m) limbs in [0, p);
    with y_major D8 comes as (nd, m, q).

    CUDA tensors launch K-mm-norm; CPU tensors take `digit_mm_norm_plain`."""
    if not ftorch.use_kernel(D8):
        return digit_mm_norm_plain(fp, W8, D8.transpose(1, 2) if y_major else D8)
    nd, r, q, m = _check_operands("K-mm-norm", W8, D8, y_major)
    if nd != _nd(fp) or fp.n8 != 32:
        raise ValueError("K-mm-norm is built for 32-byte fields (nd = 33)")
    W8, DT = W8.contiguous(), D8.contiguous() if y_major else _y_major(D8)
    consts = _norm_consts(fp.name)
    lib = _norm_lib()
    if lib.snark_digit_mm_norm_consts_bytes() != len(consts):
        raise RuntimeError("K-mm-norm: constants layout differs from the kernel's")
    out = torch.empty((fp.nl, r, m), dtype=ftorch.DTYPE, device=D8.device)
    if out.numel():
        # the retired digits of each resident block's tile: one byte per
        # output and column, written and read back by the same thread
        nbytes = lib.snark_digit_mm_norm_scratch_bytes(r, m)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=D8.device)
        err = lib.snark_digit_mm_norm(
            W8.data_ptr(), DT.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            nbytes, nd, r, q, m, consts, len(consts),
            _build.stream_ptr(D8.device))
        _build.check(err, "K-mm-norm")
        trace.add("k_mm_norm")
    return out


# --------------------------------------------------------------- the NTT

@trace.table
def _w_matrix_on(field_name: str, k: int, inverse: bool, device: str):
    return upload(torch.from_numpy(_w_matrix_digits(field_name, k, inverse)), device)


@trace.table
def _twiddle_parts_on(field_name: str, k: int, k1: int, inverse: bool, device: str):
    """`_twiddle_parts` with A and B on `device`, uploaded once."""
    s, A, B = _twiddle_parts(field_name, k, k1, inverse)
    return s, ftorch.to_tensor(A, device), ftorch.to_tensor(B, device)


def _mm_stage(ctx: FieldCtx, k: int, inverse: bool, aT):
    """Direct DFT matmul along the last axis: aT (nl, m, r) -> (nl, r, m),
    through K-mm-norm."""
    fp = ctx.fp
    W8 = _w_matrix_on(fp.name, k, inverse, str(aT.device))
    DT = _to_digits(fp, aT)           # (nd, m, q): y innermost, as the kernel reads
    return digit_mm_norm(fp, W8, DT, y_major=True)


def _split(k: int) -> int:
    """log2 of the radix of the last stage of a size-2^k NTT (k: one stage).

    The fewest stages of at most 2^MAX_LOG_R, ceil(k / MAX_LOG_R) of them,
    their log radices within one of each other, the largest last: 2^20 runs
    as 10 + 10, 2^22 as 7 + 7 + 8.  A stage's radix is the rows of its
    K-mm-norm launch, which walks the whole reduction for every tile of
    NORM_TILE_ROWS rows, so a radix far under a tile costs about what a full
    tile does: 2^22 as 2 + 10 + 10 took 76 ms on an H100, 7 + 7 + 8 23 ms."""
    return -(-k // -(-k // MAX_LOG_R))


def _ntt_last(ctx: FieldCtx, aT, inverse: bool):
    """NTT along the last axis of aT (nl, bt, sz); returns (nl, sz, bt): a
    matmul stage takes its data with the summed axis innermost and leaves the
    transformed axis outermost, which is what the next stage wants."""
    nl, bt, sz = aT.shape
    k = sz.bit_length() - 1
    if k == 0:
        return aT.reshape(nl, sz, bt)
    k1 = _split(k)
    if k1 == k:
        return _mm_stage(ctx, k, inverse, aT)
    n1, n2 = 1 << k1, 1 << (k - k1)
    # stage A: NTT over j2 for each (j1, bt); index j = j2 * n1 + j1
    y = _ntt_last(ctx, aT.reshape(nl, bt, n2, n1).permute(0, 3, 1, 2).reshape(
        nl, n1 * bt, n2), inverse)
    y = y.reshape(nl, n2, n1, bt)
    # twiddle w^(j1*k2), built on device from two factored ladders
    s, A, B = _twiddle_parts_on(ctx.fp.name, k, k1, inverse, str(aT.device))
    tw = ftorch.mont_mul(ctx, A.reshape(nl, 1, s, n1),
                         B.reshape(nl, n2 // s, 1, n1)).reshape(nl, n2, n1)
    y = ftorch.mont_mul(ctx, y, tw[:, :, :, None])
    # stage B: NTT over j1 for each (k2, bt): y already has j1 innermost
    z = _ntt_last(ctx, y.permute(0, 1, 3, 2).reshape(nl, n2 * bt, n1), inverse)
    return z.reshape(nl, n1 * n2, bt)


def ntt(ctx: FieldCtx, a):
    """Forward NTT, natural order, Montgomery form (ntt.ntt's contract)."""
    n = a.shape[-1]
    k = n.bit_length() - 1
    assert 1 << k == n and k <= ctx.fp.s
    if k == 0:
        return a
    return _ntt_last(ctx, a.reshape(ctx.nl, 1, n), False).reshape(ctx.nl, n)


def intt(ctx: FieldCtx, a):
    n = a.shape[-1]
    k = n.bit_length() - 1
    assert 1 << k == n
    if k == 0:
        return a
    return _ntt_last(ctx, a.reshape(ctx.nl, 1, n), True).reshape(ctx.nl, n)
