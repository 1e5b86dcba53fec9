"""MSM entry for the prover, the legacy sort-and-segment Pippenger, the
setup's segmented MSM and the host Jacobian helpers (port of
snarkjs_tpu/curves/msm.py).

`MSMContext.run` goes to the suffix-scan engine (`msm_gpu.GpuMSM`) with the
window-width rule of the JAX package: cw = 16 on the card for batches of
2^14 points and more, cw = 8 for smaller batches and off the card (the
bucket tree scales with 2^(cw-1)).  With `mesh` the points are sharded over
the mesh's ranks (`GpuMSM.run_sharded`).

`legacy=True` reaches the older Pippenger (`_msm_device`), which
`parallel.sharded.msm_sharded` also runs on each rank's block: per c-bit
window one stable sort of the points by digit, a segmented Jacobian scan
that leaves each run's sum at its last element, one scatter of the run ends
into 2^c buckets, and sum_j j*B_j.  Every field op goes through `ftorch`, so
on the card through K-field.  The JAX package runs the windows one after
another (a lax.scan); here all windows go through each step together.  The
segmented scan keeps the JAX shape: a Python loop of C Jacobian adds over
the R lanes (launch-bound on the card by nature), then the lanes' carries.
The two scans the JAX package runs one element at a time, the lanes'
carries over R and the bucket sum over 2^c, are log-depth doubling scans
here (jac_add resolves P == Q and P == -Q, so any order of adds gives the
same points); a window costs C + log2(R) + 2c Jacobian adds.

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

from ..fields import ftorch
from ..fields.params import LIMB_BITS
from . import jac
from .gops import field_ops
from .msm_gpu import _map


def window_digits(scalars, c: int, nbits: int):
    """(NL, N) plain 16-bit limb scalars -> (nw, N) int64 c-bit window
    digits, least significant window first (1 <= c <= 16)."""
    nl, n = scalars.shape
    nw = (nbits + c - 1) // c
    s = scalars.to(torch.int64)
    if c == LIMB_BITS:
        return s[:nw]
    if not 1 <= c <= LIMB_BITS:
        raise ValueError(f"unsupported window size {c}")
    mask = (1 << c) - 1
    digs = []
    for w in range(nw):
        i, sh = divmod(w * c, LIMB_BITS)
        v = s[i] >> sh
        if sh + c > LIMB_BITS and i + 1 < nl:
            v = v | (s[i + 1] << (LIMB_BITS - sh))
        digs.append(v & mask)
    return torch.stack(digs, dim=0)


def _leaf0(P):
    while not isinstance(P, torch.Tensor):
        P = P[0]
    return P


def _seg_op(f, left, right):
    """The segmented-sum operator on (point, flag) pairs: right's point
    alone when right starts a segment, else left + right."""
    (lv, lf), (rv, rf) = left, right
    return jac.jac_select(f, rf, rv, jac.jac_add(f, lv, rv)), lf | rf


def _scan_doubling(f, V, flags, reverse=False):
    """Inclusive segmented scan along the last axis by log doubling
    (Hillis-Steele): V Jacobian points with batch (*b, L), flags (*b, L)."""
    L = flags.shape[-1]
    if reverse:
        V, flags = _map(lambda a: a.flip(-1), V), flags.flip(-1)
    d = 1
    while d < L:
        left = (_map(lambda a: a[..., :L - d], V), flags[..., :L - d])
        right = (_map(lambda a: a[..., d:], V), flags[..., d:])
        nv, nf = _seg_op(f, left, right)
        V = _map(lambda a, b: torch.cat([a[..., :d], b], dim=-1), V, nv)
        flags = torch.cat([flags[..., :d], nf], dim=-1)
        d *= 2
    if reverse:
        V, flags = _map(lambda a: a.flip(-1), V), flags.flip(-1)
    return V, flags


def _seg_scan_2level(f, P, seg_start, R: int, C: int):
    """Inclusive segmented scan (op = Jacobian add) over the last axis of
    n = R*C points: P leaves (NL, *b, n), seg_start (*b, n) bool.

      1. a loop over the C columns of the (R, C) grid: lane r adds up its
         chunk [r*C, (r+1)*C) one point a step, all lanes (and all of the
         batch b) at once;
      2. each lane's carry, the segmented sum of the lanes before it, by a
         log-depth scan over R;
      3. the carry added into each lane's positions before its first
         segment start."""
    b = tuple(seg_start.shape[:-1])
    Pg = _map(lambda a: a.reshape(a.shape[:-1] + (R, C)), P)
    flg = seg_start.reshape(b + (R, C))
    acc, anyf = jac.jac_zero(f, b + (R,)), torch.zeros(b + (R,), dtype=torch.bool,
                                                      device=flg.device)
    cols = []
    for c in range(C):
        xv = _map(lambda a: a[..., c], Pg)
        acc, anyf = _seg_op(f, (acc, anyf), (xv, flg[..., c]))
        cols.append(acc)
    vals = tuple(f.stack_last([col[k] for col in cols]) for k in range(3))
    incl, _ = _scan_doubling(f, acc, anyf)
    # exclusive: lane r's carry is the inclusive scan at r - 1
    zero = jac.jac_zero(f, b + (1,))
    carry = _map(lambda z, a: torch.cat([z, a[..., :-1]], dim=-1), zero, incl)
    open_head = torch.cumsum(flg.to(torch.int32), dim=-1) == 0
    fixed = jac.jac_select(f, open_head,
                           jac.jac_add(f, _map(lambda a: a[..., None], carry), vals), vals)
    return _map(lambda a: a.reshape(a.shape[:-2] + (R * C,)), fixed)


def _bucket_accumulate(f, px, py, pinf, digits, c: int, R: int):
    """Bucket sums of every window: digits (nw, N) -> Jacobian points with
    batch (nw, 2^c)."""
    nw, n = digits.shape
    assert n % R == 0
    C = n // R
    d_sorted, order = torch.sort(digits, dim=-1, stable=True)
    P = jac.from_affine(f, f.gather(px, order), f.gather(py, order), pinf[order])
    edge = torch.full((nw, 1), -1, dtype=d_sorted.dtype, device=d_sorted.device)
    seg_start = d_sorted != torch.cat([edge, d_sorted[:, :-1]], dim=1)
    scanned = _seg_scan_2level(f, P, seg_start, R, C)
    run_end = d_sorted != torch.cat([d_sorted[:, 1:], edge], dim=1)
    nb = 1 << c
    target = torch.where(run_end, d_sorted, nb)   # trash slot nb for the rest
    zero = jac.jac_zero(f, (nw, nb + 1))
    return _map(lambda buf, val: buf.scatter(-1, target.expand_as(val), val)[..., :nb],
               zero, scanned)


def _bucket_reduce_batched(f, buckets, c: int):
    """sum_{j>=1} j*B_j for every window at once: buckets with batch
    (nw, 2^c) -> batch (nw,).  The suffix sums S_j = sum_{j' >= j} B_j' by a
    log-depth scan, then their sum by halving."""
    nb = 1 << c
    nw = f.batch_shape(buckets[0])[0]
    dev = _leaf0(buckets).device
    S = _map(lambda a: torch.cat([a[..., 1:], a[..., :1]], dim=-1), buckets)
    last = torch.arange(nb, device=dev) == nb - 1
    S = jac.jac_select(f, last, jac.jac_zero(f, (nw, nb)), S)   # B_1 .. B_(nb-1), 0
    flags = torch.zeros((nw, nb), dtype=torch.bool, device=dev)
    S, _ = _scan_doubling(f, S, flags, reverse=True)
    while nb > 1:
        nb //= 2
        S = jac.jac_add(f, _map(lambda a: a[..., :nb], S), _map(lambda a: a[..., nb:], S))
    return _map(lambda a: a[..., 0], S)


def _msm_device(f, px, py, pinf, scalars, c: int, nbits: int, R: int = 256):
    """Window sums of the MSM: Jacobian points with batch (nw,)."""
    digits = window_digits(scalars, c, nbits)
    return _bucket_reduce_batched(f, _bucket_accumulate(f, px, py, pinf, digits, c, R), c)


def pad_points(target: int, px, py, pinf, scalars):
    """Pad the point axis to `target` with points at infinity (scalar 0)."""
    pad = target - scalars.shape[-1]
    if not pad:
        return px, py, pinf, scalars
    padl = lambda a: torch.nn.functional.pad(a, (0, pad))
    return (_map(padl, px), _map(padl, py),
            torch.cat([pinf, torch.ones(pad, dtype=torch.bool, device=pinf.device)]),
            padl(scalars))


class MSMContext:
    """One group (G1: extension=1, G2: extension=2) over base field fp."""

    def __init__(self, fq_ctx, fp, extension: int = 1):
        self.fp = fp
        self.ctx = fq_ctx
        self.ext = extension

    def run(self, px, py, pinf, scalars, c: int = 8, nbits: int | None = None,
            R: int | None = None, mesh=None, cw: int = 16, legacy: bool = False):
        """MSM over plain-form scalars; returns a host jacobian int tuple.

        px/py: (NL, N) int32 limb tensors (Fq) or pairs of them (Fq2),
        Montgomery form; pinf: (N,) bool; scalars: (NL, N) 16-bit limbs.
        With `mesh` (a `parallel.distributed.prover_mesh`) the points are
        sharded over its ranks (`GpuMSM.run_sharded`); the point arrays may
        then be the full ones or this rank's block.  `legacy=True` runs the
        sort-and-segment Pippenger with c-bit windows over nbits (default
        NL * 16) and R scan lanes (default 256) instead, unsharded."""
        from . import msm_gpu
        from .host_curve import curve_from_q

        if legacy:
            return self._run_legacy(px, py, pinf, scalars, c, nbits, R)
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
        if mesh is not None:
            return m.run_sharded(mesh, px, py, pinf, scalars)
        return m.run(px, py, pinf, scalars)

    def _run_legacy(self, px, py, pinf, scalars, c, nbits, R):
        if nbits is None:
            nbits = self.ctx.nl * LIMB_BITS
        n = scalars.shape[-1]
        R = max(1, min(256 if R is None else R, n))
        px, py, pinf, scalars = pad_points(R * -(-n // R), px, py, pinf, scalars)
        f = field_ops(self.ctx, self.ext, scalars.device)
        return self._finish(_msm_device(f, px, py, pinf, scalars, c, nbits, R), c, nbits)

    def _finish(self, wsums, c: int, nbits: int):
        """Combine the window sums (Jacobian points with batch (nw,)) on host
        bigints: sum_w 2^(c*w) W_w."""
        fp, ext = self.fp, self.ext
        nw = (nbits + c - 1) // c

        def ints(elem):
            if ext == 1:
                return [fp.from_mont(v) for v in ftorch.np_to_ints(fp, elem)]
            re, im = (ftorch.np_to_ints(fp, e) for e in elem)
            return [(fp.from_mont(a), fp.from_mont(b)) for a, b in zip(re, im)]

        X, Y, Z = (ints(e) for e in wsums)
        total = None
        for w in range(nw - 1, -1, -1):
            if total is not None:
                for _ in range(c):
                    total = _host_jac_dbl(fp, total, ext)
            total = _host_jac_add(fp, total, (X[w], Y[w], Z[w]), ext)
        return total


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
