"""The MSM, the four-step NTT and the group iNTT over the ranks of a mesh
(port of snarkjs_tpu/parallel/sharded.py).

Every rank calls these with the same full inputs and gets the same full
result (`parallel.distributed`); it works on its own contiguous block of
the sharded axis, and `torch.distributed` collectives on the mesh's group
carry the rest:

* `msm_sharded`: the legacy Pippenger (`curves/msm._msm_device`) on the
  rank's block of points; the window sums are all-gathered and added in
  rank order.
* `ntt_sharded`: n = n1 * n2 as an (n1, n2) matrix whose columns are split
  over the ranks: NTTs over n1 on the rank's n2 / ndev columns, the
  twiddles w^(k1 * j2), one all-to-all that trades the column block for a
  row block, NTTs over n2 on the rank's n1 / ndev rows, 1/n once for the
  inverse, an all-gather and the transpose to natural order.  An axis of
  2^12 or more goes through the digit matmul (`ntt_mm._ntt_last`, kernel
  K-mm-norm) on the card, a smaller one through the butterflies (K-field).
* `group_intt_sharded`: the same four steps on curve points (the
  preparePhase2 Lagrange basis): radix-2 stages of batched scalar
  multiplications by twiddles and Jacobian adds (K-field), the twiddles
  root^(k1 * i2) from a factored ladder.  `group_intt_blocks` runs several
  blocks of one group at once, as `ptau_ops` batches its unsharded group
  iNTT: stage i of every block shares one batched scalar multiplication,
  the twiddle step (which also carries 1/n) is one batch, and blocks too
  small to split ride along in the first steps on every rank.  The JAX
  package runs one block at a time and multiplies by 1/n in a step of its
  own; the points are the same.

`all_to_all` splits and concatenates dimension 0, so the split axis is
moved to the front before the exchange and the received chunks are laid
back out by source rank.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..curves import jac
from ..curves import msm as msm_mod
from ..curves.msm_gpu import local_block
from ..device import upload
from ..fields import ftorch
from ..fields.params import get_params
from ..ntt import ntt as nttmod
from . import distributed as pdist


def _leaves(P):
    """The limb tensors of a point or element tree, in order."""
    if isinstance(P, torch.Tensor):
        return [P]
    return [t for part in P for t in _leaves(part)]


def _rebuild(P, flat):
    """A tree shaped like P from the tensors `flat` (consumed in order)."""
    if isinstance(P, torch.Tensor):
        return flat.pop(0)
    return tuple(_rebuild(part, flat) for part in P)


# ---------------------------------------------------------------- MSM

def msm_sharded(mesh, f, px, py, pinf, scalars, c: int, nbits: int, R: int = 64):
    """Window sums of the MSM over the mesh: Jacobian points with batch
    (nw,), the same on every rank (combine with `MSMContext._finish`).

    px, py, pinf: all n points or this rank's block; scalars: (NL, n)."""
    n = scalars.shape[-1]
    dev = scalars.device
    sl = pdist.local_shard_slice(n, mesh)
    px, py, pinf = local_block(n, sl, px, py, pinf, dev)
    scal = scalars[:, sl]
    m = scal.shape[-1]
    R = max(1, min(R, m))
    px, py, pinf, scal = msm_mod.pad_points(R * max(1, -(-m // R)), px, py, pinf, scal)
    ws = msm_mod._msm_device(f, px, py, pinf, scal, c, nbits, R)
    flat = _leaves(ws)
    parts = pdist.all_gather(mesh, torch.cat(flat, dim=0))      # (ndev, rows, nw)
    nw = parts.shape[-1]
    total = jac.jac_zero(f, (nw,))
    for d in range(parts.shape[0]):
        total = jac.jac_add(f, total, _rebuild(ws, list(parts[d].split(
            [t.shape[0] for t in flat], dim=0))))
    return total


# ---------------------------------------------------------------- ladders

@functools.lru_cache(maxsize=None)
def _root_ladder(field_name: str, k: int, inverse: bool, b_mont: bool, scale: int = 1):
    """Factored powers of the 2^k-th root (inverse root if `inverse`):
    root^e * scale = mont_mul(A[e & (s1 - 1)], B[e >> log_s1]) with A in
    Montgomery form and B = root^(s1 * u) * scale, Montgomery if `b_mont`
    (the product is then Montgomery) else plain (the product plain).  The
    tables hold about 2 sqrt(2^k) entries."""
    fp = get_params(field_name)
    n = 1 << k
    root = fp.winv[k] if inverse else fp.w[k]
    log_s1 = (k + 1) // 2
    s1 = 1 << log_s1
    A = [fp.to_mont(pow(root, t, fp.p)) for t in range(s1)]
    B = [pow(root, s1 * u, fp.p) * scale % fp.p for u in range(-(-n // s1))]
    if b_mont:
        B = [fp.to_mont(v) for v in B]
    return log_s1, ftorch.np_from_ints(fp, A), ftorch.np_from_ints(fp, B)


def _ladder_limbs(ctx, ladder, e, device):
    """root^e (times the ladder's scale) for an int64 exponent tensor e."""
    log_s1, A, B = ladder
    At, Bt = ftorch.to_tensor(A, device), ftorch.to_tensor(B, device)
    return ftorch.mont_mul(ctx, At[:, e & ((1 << log_s1) - 1)], Bt[:, e >> log_s1])


# ---------------------------------------------------------------- NTT

def _twiddle_matrix(ctx, n1: int, n2: int, inverse: bool, cols: slice, device):
    """w^(k1 * j2) for k1 < n1 and the columns j2 in `cols`, Montgomery
    (NL, n1, len(cols)), built on the card from the factored ladder."""
    n = n1 * n2
    k = n.bit_length() - 1
    k1 = torch.arange(n1, dtype=torch.int64, device=device)
    j2 = torch.arange(cols.start, cols.stop, dtype=torch.int64, device=device)
    e = (k1[:, None] * j2[None, :]) & (n - 1)
    return _ladder_limbs(ctx, _root_ladder(ctx.fp.name, k, inverse, True), e, device)


def _scalar(ctx, v: int, device, ndim: int):
    fp = ctx.fp
    return ftorch.to_tensor(ftorch.np_from_int(fp, fp.to_mont(v % fp.p)),
                            device).reshape((fp.nl,) + (1,) * (ndim - 1))


def ntt_sharded(mesh, ctx, x, inverse: bool = False):
    """Four-step NTT (or iNTT) of x (NL, n) over the mesh: equal, limb for
    limb, to `ntt.ntt` / `ntt.intt`, natural order, on every rank.  The
    mesh size must divide both n1 = 2^(k // 2) and n2 = n / n1."""
    ndev, r = pdist.mesh_size(mesh), pdist.mesh_rank(mesh)
    nl, n = x.shape
    k = nttmod._log2(n)
    n1 = 1 << (k // 2)
    n2 = n // n1
    if n1 % ndev or n2 % ndev:
        raise ValueError(f"the mesh ({ndev}) must divide both factors {n1} and {n2}")
    n1loc, n2loc = n1 // ndev, n2 // ndev
    dev = x.device
    cols = slice(r * n2loc, (r + 1) * n2loc)
    a = _ntt_axis(ctx, x.reshape(nl, n1, n2)[:, :, cols], n1, inverse, 1)
    a = ftorch.mont_mul(ctx, a, _twiddle_matrix(ctx, n1, n2, inverse, cols, dev))
    # the transpose: column block out, row block in (chunk j from rank j)
    recv = pdist.all_to_all(mesh, a.permute(1, 0, 2))             # (n1, nl, n2loc)
    rows = recv.reshape(ndev, n1loc, nl, n2loc).permute(2, 1, 0, 3).reshape(nl, n1loc, n2)
    b = _ntt_axis(ctx, rows, n2, inverse, 2)
    if inverse:
        b = ftorch.mont_mul(ctx, b, _scalar(ctx, pow(n, ctx.fp.p - 2, ctx.fp.p), dev, 3))
    y = pdist.all_gather(mesh, b).permute(1, 0, 2, 3).reshape(nl, n1, n2)
    # y[k1, k2] = X[k1 + n1 * k2]
    return y.transpose(1, 2).reshape(nl, n)


def _ntt_axis(ctx, x, axis_len: int, inverse: bool, over_axis: int):
    """Size-axis_len NTT along `over_axis` of an (NL, A, B) block, without
    the 1/len of the inverse (the caller applies 1/n once)."""
    nl = x.shape[0]
    k = nttmod._log2(axis_len)
    if k == 0:
        return x
    x2 = x.movedim(over_axis, -1)
    lead = tuple(x2.shape[1:-1])
    x2 = x2.reshape(nl, -1, axis_len)
    if nttmod._use_mm(x2, k):
        from ..ntt import ntt_mm

        y = ntt_mm._ntt_last(ctx, x2.contiguous(), inverse)      # (nl, axis_len, bt)
        if inverse:
            # ntt_mm folds 1/len into its matrices: undo it here
            y = ftorch.mont_mul(ctx, y, _scalar(ctx, axis_len, x.device, 3))
        return y.reshape((nl, axis_len) + lead).movedim(1, over_axis)
    bt = x2.shape[1]
    x2 = x2[:, :, upload(torch.from_numpy(nttmod.bit_reverse_perm(k)), x.device)]
    tables = nttmod._twiddles(ctx.fp.name, k, inverse)
    for s in range(1, k + 1):
        m = 1 << (s - 1)
        tw = ftorch.to_tensor(tables[s - 1], x.device).reshape(nl, 1, 1, m)
        x2 = x2.reshape(nl, bt, axis_len // (2 * m), 2 * m)
        lo, hi = x2[..., :m], x2[..., m:]
        t = ftorch.mont_mul(ctx, hi, tw)
        x2 = torch.cat([ftorch.add(ctx, lo, t), ftorch.sub(ctx, lo, t)], dim=-1)
    return x2.reshape((nl,) + lead + (axis_len,)).movedim(-1, over_axis)


# ---------------------------------------------------------------- group iNTT

def _radix2_stages(cv, g2, f, P, segs, device):
    """Inverse radix-2 stages in place on the Jacobian lanes P (no 1/len).

    segs: [(lane offset, k, count)]: `count` sub-blocks of 2^k lanes one
    after another, each in bit-reversed order; afterwards each holds its
    transform in natural order.  Stage i multiplies the hi lanes of every
    sub-block with k > i by w_{2^(i+1)}^-off in one batch (lanes whose
    twiddle is 1 stay out) and adds and subtracts."""
    from ..ceremony import ptau_ops

    fr = cv.fr
    for i in range(max((k for _, k, _ in segs), default=0)):
        m = 1 << i
        los, offs = [], []
        for o, k, cnt in segs:
            if k <= i:
                continue
            t = np.arange(1 << (k - 1))
            base = o + np.arange(cnt)[:, None] * (1 << k)
            los.append((base + (t // m) * 2 * m + t % m).ravel())
            offs.append(np.tile(t % m, cnt))
        lo, off = np.concatenate(los), np.concatenate(offs)
        if i >= 1:
            keep = off != 0
            tw = ptau_ops._powers(fr, 1, fr.winv[i + 1], m, device)
            ptau_ops._scale_lanes(cv, g2, f, P, torch.as_tensor(lo[keep] + m, device=device),
                                  tw[:, torch.as_tensor(off[keep], device=device)].contiguous(),
                                  device)
        lo_t = torch.as_tensor(lo, device=device)
        A = tuple(f.gather(c, lo_t) for c in P)
        B = tuple(f.gather(c, lo_t + m) for c in P)
        top = jac.jac_add(f, A, B)
        bot = jac.jac_add(f, A, jac.jac_neg(f, B))
        for c, tp, bt in zip(P, top, bot):
            f.put(c, lo_t, tp)
            f.put(c, lo_t + m, bt)


def _split(k: int):
    k1 = k // 2
    return k1, k - k1


def group_intt_blocks(mesh, cv, g2: bool, cols, small, device):
    """Inverse group NTTs (G.ifft, 1/n included) of several blocks of one
    group over the mesh.

    cols: [(x, y, inf, k)], this rank's columns of each block of 2^k points
    seen as an (n1, n2) matrix (i = i1 * n2 + i2, n1 = 2^(k // 2)): leaves
    (NL, n1, n2 / ndev), inf (n1, n2 / ndev), the columns
    [r * n2 / ndev, (r + 1) * n2 / ndev); ndev must divide n1 and n2.
    small: [(x, y, inf, k)], whole blocks (leaves (NL, 2^k), k >= 1) that
    every rank transforms alone.  Returns the affine (x, y, inf) of each
    block of cols, then of each of small, in natural order, on every rank."""
    from ..ceremony import ptau_ops

    fr = cv.fr
    ctx_r = ftorch.get_ctx(fr.name)
    f = ptau_ops._f(cv, g2, device)
    ndev, r = pdist.mesh_size(mesh), pdist.mesh_rank(mesh)
    cat = lambda parts: torch.cat(parts, dim=-1)

    # stage A lanes: each big block's columns (column-major, i1
    # bit-reversed), then each small block (bit-reversed)
    xs, ys, infs, segs, meta = [], [], [], [], []
    pos = 0
    for x, y, inf, k in cols:
        k1, k2 = _split(k)
        n1, n2loc = 1 << k1, inf.shape[-1]
        perm = torch.as_tensor(nttmod.bit_reverse_perm(k1), device=device)
        lay = lambda a: a[..., perm, :].transpose(-1, -2).reshape(a.shape[:-2] + (-1,))
        xs.append(ptau_ops._tree(lay, x))
        ys.append(ptau_ops._tree(lay, y))
        infs.append(lay(inf))
        segs.append((pos, k1, n2loc))
        meta.append((pos, k, n1, n2loc))
        pos += n1 * n2loc
    n_big = pos
    for x, y, inf, k in small:
        perm = torch.as_tensor(nttmod.bit_reverse_perm(k), device=device)
        xs.append(ptau_ops._tree(lambda a: a[..., perm], x))
        ys.append(ptau_ops._tree(lambda a: a[..., perm], y))
        infs.append(inf[perm])
        segs.append((pos, k, 1))
        pos += 1 << k
    tree_cat = lambda parts: (cat(parts) if isinstance(parts[0], torch.Tensor)
                              else tuple(tree_cat(list(p)) for p in zip(*parts)))
    P = jac.from_affine(f, tree_cat(xs), tree_cat(ys), torch.cat(infs))
    _radix2_stages(cv, g2, f, P, segs, device)

    # one batch: big lanes by root^(k1 * i2) / n, small ones by 1/n
    scal = []
    for o, k, n1, n2loc in meta:
        c = torch.arange(n2loc, dtype=torch.int64, device=device)
        k1v = torch.arange(n1, dtype=torch.int64, device=device)
        e = (k1v[None, :] * (r * n2loc + c)[:, None]) & ((1 << k) - 1)   # (n2loc, n1)
        ladder = _root_ladder(fr.name, k, True, False, pow(1 << k, fr.p - 2, fr.p))
        scal.append(_ladder_limbs(ctx_r, ladder, e.reshape(-1), device))
    for _, _, _, k in small:
        scal.append(ptau_ops._const(fr, pow(1 << k, fr.p - 2, fr.p), device)
                    .expand(fr.nl, 1 << k))
    ptau_ops._scale_lanes(cv, g2, f, P, torch.arange(pos, device=device),
                          torch.cat(scal, dim=1).contiguous(), device)

    outs = []
    if cols:
        # the transpose: lanes (c, k1) of each block go to the rank owning k1
        send, boffs, bo = [], [], 0
        for o, k, n1, n2loc in meta:
            n1loc = n1 // ndev
            boffs.append(bo)
            bo += n2loc * n1loc
        for j in range(ndev):
            for o, k, n1, n2loc in meta:
                n1loc = n1 // ndev
                c = np.arange(n2loc)[:, None]
                send.append((o + c * n1 + j * n1loc + np.arange(n1loc)[None, :]).ravel())
        send = torch.as_tensor(np.concatenate(send), device=device)
        rows = torch.cat(_leaves(P), dim=0)[:, send]
        recv = pdist.all_to_all(mesh, rows.T).T                      # (rows, n_big)
        chunk = n_big // ndev
        idx, segs_b, pos_b, out_meta = [], [], 0, []
        for (o, k, n1, n2loc), boff in zip(meta, boffs):
            n1loc, (_, k2) = n1 // ndev, _split(k)
            n2 = 1 << k2
            i2 = nttmod.bit_reverse_perm(k2)
            src, c = i2 // n2loc, i2 % n2loc
            k1l = np.arange(n1loc)[:, None]
            idx.append((src[None, :] * chunk + boff + c[None, :] * n1loc + k1l).ravel())
            segs_b.append((pos_b, k2, n1loc))
            out_meta.append((pos_b, n1, n2))
            pos_b += n1loc * n2
        PB = _rebuild(P, list(recv[:, torch.as_tensor(np.concatenate(idx), device=device)]
                              .split([t.shape[0] for t in _leaves(P)], dim=0)))
        _radix2_stages(cv, g2, f, PB, segs_b, device)
        ax, ay, ainf = jac.to_affine_batch(f, PB, f.batch_inv)
        packed = torch.cat(_leaves((ax, ay)) + [ainf[None].to(torch.int32)], dim=0)
        every = pdist.all_gather(mesh, packed)                        # (ndev, rows, lanes)
        widths = [t.shape[0] for t in _leaves((ax, ay))] + [1]
        for pb, n1, n2 in out_meta:
            blk = every[:, :, pb:pb + (n1 // ndev) * n2]
            nat = blk.reshape(ndev, -1, n1 // ndev, n2).permute(1, 0, 2, 3).reshape(
                -1, n1, n2).transpose(1, 2).reshape(-1, n1 * n2)  # k = k1 + n1 * k2
            flat = list(nat.split(widths, dim=0))
            inf_o = flat.pop().reshape(-1) != 0
            outs.append((_rebuild(ax, flat), _rebuild(ay, flat), inf_o))
    if small:
        sx, sy, sinf = jac.to_affine_batch(
            f, tuple(ptau_ops._tree(lambda a: a[..., n_big:], c) for c in P), f.batch_inv)
        po = 0
        for _, _, _, k in small:
            sl = lambda a: a[..., po:po + (1 << k)]
            outs.append((ptau_ops._tree(sl, sx), ptau_ops._tree(sl, sy), sinf[po:po + (1 << k)]))
            po += 1 << k
    return outs


def group_intt_sharded(mesh, cv, g2: bool, px, py, pinf):
    """Inverse group NTT (G.ifft / lagrangeEvaluations) of 2^k affine points
    over the mesh: px, py Montgomery limb tensors (pairs of them on G2),
    pinf (n,) bool, all n points on every rank.  Returns the affine
    (x, y, inf) in natural order on every rank, the points of
    `ptau_ops.host_group_ifft`.  The mesh size must divide n1 = 2^(k // 2)
    and n2 = n / n1, and k <= the 2-adicity of Fr."""
    ndev, r = pdist.mesh_size(mesh), pdist.mesh_rank(mesh)
    n = pinf.shape[-1]
    k = nttmod._log2(n)
    if k > cv.fr.s:
        raise ValueError(f"a group iNTT needs 2^k points with k <= {cv.fr.s}")
    k1, k2 = _split(k)
    n1, n2 = 1 << k1, 1 << k2
    if n1 % ndev or n2 % ndev:
        raise ValueError(f"the mesh ({ndev}) must divide both factors {n1} and {n2}")
    n2loc = n2 // ndev
    device = pinf.device
    take = lambda a: a.reshape(a.shape[:-1] + (n1, n2))[..., r * n2loc:(r + 1) * n2loc]
    from ..ceremony.ptau_ops import _tree

    return group_intt_blocks(mesh, cv, g2, [(_tree(take, px), _tree(take, py), take(pinf), k)],
                             [], device)[0]
