"""Sorted suffix-scan Pippenger MSM on the card (port of
snarkjs_tpu/curves/msm_tpu.py).

Per window of a balanced signed-digit recode (|digit| <= 2^(cw-1), sign in
the sort key's low bit):

1. one stable sort of the keys, whose permutation gathers the packed affine
   point rows (two 16-bit limbs per u32 word);
2. kernel K-scan (`scan`, csrc/msm_scan.cu): every lane walks its contiguous
   chunk of C sorted points from the end, one complete mixed add per point,
   and writes the running suffix point after each step;
3. phase 2, kernel K-reduce (`reduce`, csrc/msm_reduce.cu): the suffix
   identity sum_b b*B_b = sum_{t=1}^{2^(cw-1)} Suffix(first index with
   |digit| >= t), where a binary search of 2t in the sorted keys finds each
   row, the suffix of later lanes' totals fixes the cross-lane carry, and
   the rows are summed: complete RCB adds in four launches an MSM, whatever
   its size, curve or window width.

All windows share one sort call, one K-scan launch and one K-reduce call;
the window partials come back to the host and are combined on bigints
(`_finish`).  The lane count RL is a parameter of `_program`: on the card it
is picked so that nw * RL threads fill the SMs (`_lanes`).

`scan_plain` and `reduce_plain` are the kernels' plain twins (phase 2 there
is `searchsorted`, a log-doubling suffix `_suffix_excl` and a halving tree
`_tree_sum` over the field ops, on the CPU hundreds of plain adds); the
counters `k_scan` and `k_reduce` of `trace` count the kernels' launches.
Spans (`trace.span`): `msm.recode`, `msm.sort`, `msm.scan`, `msm.phase2`,
and on the mesh `msm.gather`, then `msm.readback` and `msm.finish`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build, trace
from ..device import upload
from ..fields import fcuda, ftorch
from ..fields.params import LIMB_BITS, FieldParams
from . import rcb
from .gops import field_ops

LN = 128                 # lanes on the CPU (tests)
TARGET_THREADS = 1 << 17  # K-scan threads per launch on the card


def _b3_ints(fp: FieldParams, b, ext):
    """3*b in Montgomery form: an int (G1) or a pair (G2)."""
    if ext == 1:
        return fp.to_mont(3 * b % fp.p)
    return tuple(fp.to_mont(3 * v % fp.p) for v in b)


def _dev_b3(ctx, b, ext, batch_ndim, device):
    fp = ctx.fp

    def one(v):
        return ftorch.to_tensor(ftorch.np_from_int(fp, v), device).reshape(
            (fp.nl,) + (1,) * batch_ndim)

    v = _b3_ints(fp, b, ext)
    return one(v) if ext == 1 else tuple(one(x) for x in v)


# ---------------------------------------------------------- packed rows

def unpack_rows(pk):
    """(k, ...) packed int32 words -> (2k, ...) 16-bit limb rows."""
    lo = pk & 0xFFFF
    hi = (pk >> 16) & 0xFFFF
    return torch.stack([lo, hi], dim=1).reshape((2 * pk.shape[0],) + pk.shape[1:])


def pack_rows(rows):
    """(2k, ...) 16-bit limb rows -> (k, ...) int32 words (bit pattern of u32)."""
    v = rows[0::2].to(torch.int64) + (rows[1::2].to(torch.int64) << 16)
    return (v - ((v >> 31) << 32)).to(torch.int32)


# ---------------------------------------------------------- K-scan + twin

def _flat(P, ext):
    X, Y, Z = P
    if ext == 1:
        return torch.cat([X, Y, Z], dim=0)
    return torch.cat([X[0], X[1], Y[0], Y[1], Z[0], Z[1]], dim=0)


def _unflat(rows, nl, ext):
    if ext == 1:
        return (rows[:nl], rows[nl:2 * nl], rows[2 * nl:])
    return ((rows[:nl], rows[nl:2 * nl]), (rows[2 * nl:3 * nl], rows[3 * nl:4 * nl]),
            (rows[4 * nl:5 * nl], rows[5 * nl:]))


def scan_plain(fq: FieldParams, b, ext: int, xyT):
    """Plain twin of K-scan: the same mixed adds, step by step over C.

    xyT (nw, C, nl*ext + 1, RL) int32 -> (nw, C, 3*nl*ext/2, RL) int32."""
    nl = fq.nl
    ctx = ftorch.get_ctx(fq.name)
    nw, C, nin, RL = xyT.shape
    npk = nin - 1
    dev = xyT.device
    with ftorch.plain_versions():
        f = field_ops(ctx, ext, dev)
        b3 = _dev_b3(ctx, b, ext, 2, dev)
        P = rcb.rcb_zero(f, (nw, RL))
        out = torch.empty((nw, C, 3 * npk // 2, RL), dtype=torch.int32, device=dev)
        for c in range(C - 1, -1, -1):
            rows = xyT[:, c].permute(1, 0, 2)                  # (nin, nw, RL)
            v = unpack_rows(rows[:npk])
            neg = (rows[npk] & 1) != 0
            if ext == 1:
                x2, y2 = v[:nl], v[nl:]
            else:
                x2, y2 = (v[:nl], v[nl:2 * nl]), (v[2 * nl:3 * nl], v[3 * nl:])
            y2 = f.select(neg, f.sub(f.zero((nw, RL)), y2), y2)
            P = rcb.rcb_madd(f, P, x2, y2, b3)
            out[:, c] = pack_rows(_flat(P, ext)).permute(1, 0, 2)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("msm_scan")
    lib.snark_msm_scan.restype = ctypes.c_int
    lib.snark_msm_scan.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_int, ctypes.c_void_p])
    lib.snark_msm_scan_attributes.restype = ctypes.c_int
    lib.snark_msm_scan_attributes.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    return lib


@functools.lru_cache(maxsize=None)
def _b3_words(fq: FieldParams, b, ext):
    n32 = fq.nl // 2
    v = _b3_ints(fq, b, ext)
    pair = (v, 0) if ext == 1 else v
    words = [(x >> (32 * i)) & 0xFFFFFFFF for x in pair for i in range(n32)]
    return (ctypes.c_uint32 * (2 * n32))(*words)


def _curve_args(fq: FieldParams, b, ext, what):
    """The field and 3b arguments K-scan and K-reduce take: p, -p^-1 mod
    2^32, R mod p, 3b (G2, Montgomery words) and 3b (G1, a small integer)."""
    b3_small = 3 * b if ext == 1 else 0
    if ext == 1 and not 0 < b3_small < 64:
        raise ValueError(f"{what} G1 takes 3b as a small integer (an add ladder)")
    p32, np0, one32 = fcuda.consts(fq)
    return (ctypes.cast(p32, ctypes.c_void_p), np0, ctypes.cast(one32, ctypes.c_void_p),
            ctypes.cast(_b3_words(fq, b, ext), ctypes.c_void_p), b3_small)


def scan(fq: FieldParams, b, ext: int, xyT):
    """K-scan over (nw, C, nl*ext + 1, RL) int32 sorted packed points.

    CUDA tensors launch the kernel; CPU tensors take `scan_plain`."""
    if not ftorch.use_kernel(xyT):
        return scan_plain(fq, b, ext, xyT)
    nl = fq.nl
    nw, C, nin, RL = xyT.shape
    if xyT.dtype != torch.int32 or nin != nl * ext + 1:
        raise ValueError("K-scan takes int32 (nw, C, nl*ext+1, RL) rows")
    xyT = xyT.contiguous()
    out = torch.empty((nw, C, 3 * nl * ext // 2, RL), dtype=torch.int32,
                      device=xyT.device)
    err = _lib().snark_msm_scan(
        nl // 2, ext, xyT.data_ptr(), out.data_ptr(), nw, C, RL,
        *_curve_args(fq, b, ext, "K-scan"), _build.stream_ptr(xyT.device))
    _build.check(err, "K-scan")
    trace.add("k_scan")
    return out


def kernel_attributes(n32: int, ext: int) -> dict:
    """Registers and local memory (spills and stack) a thread of the K-scan
    instantiation for (n32, ext), as the loaded library holds it."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_lib().snark_msm_scan_attributes(
        n32, ext, ctypes.byref(regs), ctypes.byref(local)), "K-scan attributes")
    return {"registers": regs.value, "local_bytes": local.value}


# ------------------------------------------------------------ phase 2

def _map(fn, *Ps):
    """Apply fn leafwise over points (tuples of tensors or of tensor pairs)."""
    if isinstance(Ps[0], torch.Tensor):
        return fn(*Ps)
    return tuple(_map(fn, *parts) for parts in zip(*Ps))


def _suffix_excl(f, P, b3):
    """excl[r] = sum_{r' > r} P[r'] along the last axis, by log doubling."""
    n = P[0][0].shape[-1] if isinstance(P[0], tuple) else P[0].shape[-1]
    ident = rcb.rcb_zero(f, (1, 1))

    def shift_left(Q, k):
        return _map(lambda a, i: torch.cat(
            [a[..., k:], i.expand(a.shape[:-1] + (k,))], dim=-1), Q, ident)

    S = shift_left(P, 1)
    k = 1
    while k < n:
        S = rcb.rcb_add(f, S, shift_left(S, k), b3)
        k *= 2
    return S


def _tree_sum(f, P, b3):
    """Sum points along the last axis (a power of two) by halving."""
    n = P[0][0].shape[-1] if isinstance(P[0], tuple) else P[0].shape[-1]
    while n > 1:
        half = n // 2
        P = rcb.rcb_add(f, _map(lambda a: a[..., :half], P),
                        _map(lambda a: a[..., half:n], P), b3)
        n = half
    return P


def reduce_plain(fq: FieldParams, b, ext: int, cw: int, st_all, dsort):
    """Plain twin of K-reduce: searchsorted, the rows, `_suffix_excl` and
    `_tree_sum` over the field ops.

    st_all (nw, C, 3*nl*ext/2, RL) int32 K-scan output, dsort (nw, C*RL)
    sorted keys -> (3*nl*ext, nw) int32 window partials (16-bit limbs)."""
    nl = fq.nl
    nw, C, _, RL = st_all.shape
    Np = C * RL
    half = 1 << (cw - 1)
    dev = st_all.device
    ctx = ftorch.get_ctx(fq.name)
    with ftorch.plain_versions():
        f = field_ops(ctx, ext, dev)
        b3 = _dev_b3(ctx, b, ext, 2, dev)
        tvals = torch.arange(2, 2 * half + 2, 2, dtype=dsort.dtype,
                             device=dev).expand(nw, half).contiguous()
        fidx = torch.searchsorted(dsort, tvals)                      # (nw, half)
        valid = fidx < Np
        safe = fidx.clamp(max=Np - 1)
        lane, cpos = safe // C, safe % C
        widx = torch.arange(nw, device=dev)[:, None]
        A = st_all[widx, cpos, :, lane]                              # (nw, half, nro/2)
        totP = _unflat(unpack_rows(st_all[:, 0].permute(1, 0, 2)), nl, ext)
        carry = _suffix_excl(f, totP, b3)
        Cr = _map(lambda a: a[:, widx, lane], carry)
        Ap = _unflat(unpack_rows(A.permute(2, 0, 1)), nl, ext)
        S = rcb.rcb_add(f, Ap, Cr, b3)
        S = rcb.rcb_select(f, valid, S, rcb.rcb_zero(f, (1, 1)))
        W = _tree_sum(f, S, b3)                                     # half = 2^(cw-1)
        return _flat(_map(lambda a: a[..., 0], W), ext)


@functools.lru_cache(maxsize=None)
def _reduce_lib():
    lib = _build.library("msm_reduce")
    lib.snark_msm_reduce.restype = ctypes.c_int
    lib.snark_msm_reduce.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_int, ctypes.c_void_p])
    lib.snark_msm_reduce_scratch.restype = ctypes.c_longlong
    lib.snark_msm_reduce_scratch.argtypes = [ctypes.c_int] * 5
    lib.snark_msm_reduce_launches.restype = ctypes.c_int
    lib.snark_msm_reduce_launches.argtypes = []
    lib.snark_msm_reduce_attributes.restype = ctypes.c_int
    lib.snark_msm_reduce_attributes.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    return lib


def reduce(fq: FieldParams, b, ext: int, cw: int, st_all, dsort):
    """K-reduce: phase 2 of the MSM, K-scan's output (nw, C, 3*nl*ext/2, RL)
    int32 and the sorted keys (nw, C*RL) -> (3*nl*ext, nw) int32 window
    partials (16-bit limbs).

    CUDA tensors launch the kernel; CPU tensors take `reduce_plain`.  The
    projective words differ from the twin's (another order of adds); the
    points are the same."""
    if not ftorch.use_kernel(st_all):
        return reduce_plain(fq, b, ext, cw, st_all, dsort)
    nl = fq.nl
    nw, C, nro2, RL = st_all.shape
    if st_all.dtype != torch.int32 or nro2 != 3 * nl * ext // 2:
        raise ValueError("K-reduce takes int32 (nw, C, 3*nl*ext/2, RL) rows")
    if tuple(dsort.shape) != (nw, C * RL) or dsort.dtype != torch.int32:
        raise ValueError("K-reduce takes (nw, C*RL) int32 sorted keys")
    st_all, dsort = st_all.contiguous(), dsort.contiguous()
    half = 1 << (cw - 1)
    lib = _reduce_lib()
    words = lib.snark_msm_reduce_scratch(nl // 2, ext, nw, RL, half)
    if words < 0:
        raise ValueError(f"K-reduce has no instantiation for {nl // 2} words")
    scratch = torch.empty(words, dtype=torch.int32, device=st_all.device)
    out = torch.empty((3 * nl * ext, nw), dtype=torch.int32, device=st_all.device)
    err = lib.snark_msm_reduce(
        nl // 2, ext, st_all.data_ptr(), dsort.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), nw, C, RL, half, *_curve_args(fq, b, ext, "K-reduce"),
        _build.stream_ptr(st_all.device))
    _build.check(err, "K-reduce")
    trace.add("k_reduce", lib.snark_msm_reduce_launches())
    return out


def reduce_attributes(n32: int, ext: int) -> dict:
    """Registers and local memory (spills and stack) a thread of the K-reduce
    instantiation for (n32, ext), as the loaded library holds it."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_reduce_lib().snark_msm_reduce_attributes(
        n32, ext, ctypes.byref(regs), ctypes.byref(local)), "K-reduce attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def _lanes(nw: int, n: int, device) -> int:
    """Scan width.  On the CPU about sqrt(n) lanes, at most 128 (the plain
    phase 2 costs lanes x windows adds); on the card enough that nw * RL
    threads fill it, but no wider than the points need."""
    if device.type != "cuda":
        return min(LN, max(8, 1 << ((n - 1).bit_length() + 1) // 2))
    rl = max(LN, TARGET_THREADS // nw)
    rl = 1 << (rl.bit_length() - 1)
    return max(LN, min(rl, 1 << max(0, (n - 1).bit_length())))


class GpuMSM:
    """Pippenger MSM on one card.  G1 (ext=1) and G2 (ext=2)."""

    def __init__(self, fq: FieldParams, fr: FieldParams, b, ext: int = 1,
                 cw: int = LIMB_BITS):
        self.fq = fq
        self.fr = fr
        self.b = b if ext == 1 else tuple(b)
        self.ext = ext
        self.cw = cw
        self.nb = 1 << cw

    def _xy_packed(self, px, py):
        """Affine coords as (nl*ext, n) int32 words, two limbs per word."""
        if self.ext == 1:
            rows = torch.cat([px, py], dim=0)
        else:
            rows = torch.cat([px[0], px[1], py[0], py[1]], dim=0)
        return pack_rows(rows)

    def _program(self, C: int, RL: int, nw: int):
        """The device MSM over exactly C*RL points: window partials (nro, nw)."""
        fq, ext = self.fq, self.ext

        def msm_all(px, py, pinf, scalars):
            with trace.span("msm.recode"):
                keys = self._keys(pinf, scalars)
            assert keys.shape[0] == nw
            with trace.span("msm.sort"):
                xyT, dsort = self._sorted(keys, self._xy_packed(px, py), C, RL)
            with trace.span("msm.scan"):
                st_all = scan(fq, self.b, ext, xyT)                  # (nw, C, nro/2, RL)
            with trace.span("msm.phase2"):
                return reduce(fq, self.b, ext, self.cw, st_all, dsort)

        return msm_all

    def _keys(self, pinf, scalars):
        """Balanced signed recode: (rows, N) window digits -> (nw, N) sort
        keys mag*2 + sign, |digit| <= 2^(cw-1), the carry into the next
        window (and into one extra window when p may fill them all)."""
        half = self.nb // 2
        scal = torch.where(pinf[None], torch.zeros_like(scalars), scalars)
        keys = []
        cin = torch.zeros_like(scal[0])
        for w in range(scal.shape[0]):
            d = scal[w] + cin
            neg = d > half
            cin = neg.to(d.dtype)
            mag = torch.where(neg, self.nb - d, d)
            keys.append(mag * 2 + cin)
        if self.fr.p.bit_length() >= self.cw * scal.shape[0]:
            keys.append(cin * 2)
        return torch.stack(keys)

    def _sorted(self, keys, xyp, C, RL):
        """One stable sort per window; the permutation gathers the packed
        point rows.  -> K-scan input (nw, C, npk+1, RL), sorted keys."""
        nw = keys.shape[0]
        npk = xyp.shape[0]
        dsort, perm = torch.sort(keys, dim=-1, stable=True)          # (nw, Np)
        xys = torch.cat([xyp[:, perm], dsort[None]], dim=0)          # (npk+1, nw, Np)
        return xys.reshape(npk + 1, nw, RL, C).permute(1, 3, 0, 2), dsort

    def scan_input(self, px, py, pinf, scalars, lanes: int | None = None):
        """The K-scan input `run` would build for these points and window
        digits (for holding the kernel against its plain twin)."""
        n = scalars.shape[-1]
        nw = self.n_windows(scalars.shape[0])
        RL = lanes or _lanes(nw, n, scalars.device)
        C = max(1, -(-n // RL))
        px, py, pinf, scalars = _pad_to(C * RL, px, py, pinf, scalars)
        keys = self._keys(pinf, scalars)
        return self._sorted(keys, self._xy_packed(px, py), C, RL)[0].contiguous()

    def n_windows(self, scalar_rows: int) -> int:
        return scalar_rows + int(self.fr.p.bit_length() >= self.cw * scalar_rows)

    def run(self, px, py, pinf, scalars):
        """Full MSM; returns the host jacobian int tuple."""
        n = scalars.shape[-1]
        device = scalars.device
        nw = self.n_windows(scalars.shape[0])
        RL = _lanes(nw, n, device)
        C = max(1, -(-n // RL))
        px, py, pinf, scalars = _pad_to(C * RL, px, py, pinf, scalars)
        flatW = self._program(C, RL, nw)(px, py, pinf, scalars)
        return self._read_and_finish(flatW)

    def run_sharded(self, mesh, px, py, pinf, scalars):
        """MSM with the points sharded over the ranks of `mesh` (port of
        TpuMSM.run_sharded): each rank runs K-scan and phase 2 on its block
        `local_shard_slice(n, mesh)`, every block padded to the same C * RL;
        the (nro, nw) window partials are all-gathered and combined on host
        bigints, so every rank returns the same point.

        scalars: the full (rows, n) digits; px, py, pinf: the full point
        arrays or this rank's block of them (a key uploads only its block)."""
        from ..parallel import distributed as pdist

        n = scalars.shape[-1]
        device = scalars.device
        nw = self.n_windows(scalars.shape[0])
        sl = pdist.local_shard_slice(n, mesh)
        px, py, pinf = local_block(n, sl, px, py, pinf, device)
        per = -(-n // pdist.mesh_size(mesh))
        RL = _lanes(nw, per, device)
        C = max(1, -(-per // RL))
        px, py, pinf, scal = _pad_to(C * RL, px, py, pinf, scalars[:, sl])
        flatW = self._program(C, RL, nw)(px, py, pinf, scal)   # (nro, nw)
        with trace.span("msm.gather"):
            parts = pdist.all_gather(mesh, flatW)                       # (ndev, nro, nw)
        return self._read_and_finish(parts.permute(1, 2, 0))

    def _read_and_finish(self, flatW):
        with trace.span("msm.readback"):
            host = ftorch.to_numpy(flatW)
        with trace.span("msm.finish"):
            return self._finish(host)

    def _finish(self, flatW: np.ndarray):
        """Host window combination (bigints): W = sum_w 2^(cw*w) W_w.

        flatW: (nro, nw) window partials, or (nro, nw, ndev) with one
        partial a rank; each partial is made affine and added."""
        from . import msm as msm_mod

        fq, ext = self.fq, self.ext
        nl = fq.nl
        if flatW.ndim == 2:
            flatW = flatW[:, :, None]
        _, nw, ndev = flatW.shape
        ints = ftorch.np_to_ints(fq, flatW.reshape(3 * ext, nl, nw * ndev)
                                 .transpose(1, 0, 2))      # [(coord*nw + w)*ndev + d]

        def elem(k, w, d):
            at = lambda row: fq.from_mont(ints[(row * nw + w) * ndev + d])
            return at(k) if ext == 1 else (at(2 * k), at(2 * k + 1))

        total = None
        for w in range(nw - 1, -1, -1):
            if total is not None:
                for _ in range(self.cw):
                    total = msm_mod._host_jac_dbl(fq, total, ext)
            for d in range(ndev):
                X, Y, Z = elem(0, w, d), elem(1, w, d), elem(2, w, d)
                if msm_mod._f_is_zero(Z, ext):
                    continue
                Zi = _f_inv(fq, Z, ext)
                x = msm_mod._f_mul(fq, X, Zi, ext)
                y = msm_mod._f_mul(fq, Y, Zi, ext)
                total = msm_mod._host_jac_add(fq, total, (x, y, msm_mod._f_int(1, ext)),
                                              ext)
        if total is None:
            total = (msm_mod._f_int(0, ext), msm_mod._f_int(1, ext),
                     msm_mod._f_int(0, ext))
        return total


def local_block(n: int, sl: slice, px, py, pinf, device):
    """This rank's block [sl] of a length-n point axis on `device`: the
    arrays may hold all n points or already just the block."""
    size = max(0, sl.stop - sl.start)
    have = pinf.shape[-1]
    if have == n:
        take = lambda a: a[..., sl]
    elif have == size:
        take = lambda a: a
    else:
        raise ValueError(f"points: {have} of them, neither all {n} nor the block of {size}")
    put = lambda a: upload(take(a), device)
    return _map(put, px), _map(put, py), put(pinf)


def _pad_to(target, px, py, pinf, scalars):
    pad = target - scalars.shape[-1]
    if not pad:
        return px, py, pinf, scalars
    padl = lambda a: torch.nn.functional.pad(a, (0, pad))
    px = _map(padl, px)
    py = _map(padl, py)
    pinf = torch.cat([pinf, torch.ones(pad, dtype=torch.bool, device=pinf.device)])
    return px, py, pinf, padl(scalars)


def _f_inv(fp, a, ext):
    if ext == 1:
        return pow(a, fp.p - 2, fp.p)
    a0, a1 = a
    t = pow((a0 * a0 + a1 * a1) % fp.p, fp.p - 2, fp.p)
    return (a0 * t % fp.p, (fp.p - a1) * t % fp.p)


@functools.lru_cache(maxsize=None)
def get_msm(curve_name: str, group: str = "g1", cw: int = LIMB_BITS) -> GpuMSM:
    from .host_curve import get_curve

    cv = get_curve(curve_name)
    if group == "g1":
        return GpuMSM(cv.fq, cv.fr, cv.b, ext=1, cw=cw)
    return GpuMSM(cv.fq, cv.fr, cv.b2, ext=2, cw=cw)
