"""Phase 2 of the MSM: `msm_gpu.reduce_plain` (the plain twin) against the
bucket sum on host bigints, and kernel K-reduce (`msm_gpu.reduce`,
csrc/msm_reduce.cu) against the twin on the card.

The inputs are made as the MSM makes them: points tiled from a table of
multiples of the generator, padded with identity points to C * RL, sorted
by `GpuMSM.scan_input` and scanned by K-scan (its plain twin on the CPU).
Their windows hold the cases phase 2 has to get right: random digits, a
window of magnitudes 0 and 1 (every t >= 2 has no row), a window whose
digits are all zero, a window of small magnitudes; the padding fills whole
lanes, whose K-scan totals are not points of the curve (padding has
coordinates 0) and must not reach any partial.  Partials are compared as
affine points: the projective words depend on the order of the adds.

This file imports no jax: the card-only case runs with `python -m pytest
--noconftest -m cuda tests/test_torch_msm_reduce.py`.
"""

import numpy as np
import pytest
import torch

from snarkjs_tpu_torch import trace
from snarkjs_tpu_torch.curves import host_curve as hc
from snarkjs_tpu_torch.curves import msm as msm_mod
from snarkjs_tpu_torch.curves import msm_gpu
from snarkjs_tpu_torch.fields import ftorch
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CURVES = {"bn254": hc.BN254, "bls12_381": hc.BLS12_381}
TABLE = {1: 61, 2: 13}     # distinct multiples of the generator, tiled


def _table(cv, ext):
    add, gen = (hc.g1_add, cv.g1) if ext == 1 else (hc.g2_add, cv.g2)
    pts, acc = [], gen
    for _ in range(TABLE[ext]):
        pts.append(acc)
        acc = add(cv, acc, gen)
    return pts


def _coords(cv, ext, pts, idx, dev):
    """Affine coordinates of pts[idx[i]] as Montgomery limb tensors."""
    fq = cv.fq
    getters = ([lambda p: p[0], lambda p: p[1]] if ext == 1 else
               [lambda p: p[0][0], lambda p: p[0][1], lambda p: p[1][0], lambda p: p[1][1]])
    idx = torch.as_tensor(idx, device=dev)
    cols = [ftorch.to_tensor(ftorch.np_from_ints(fq, [fq.to_mont(g(p)) for p in pts]),
                             dev)[:, idx] for g in getters]
    return (cols[0], cols[1]) if ext == 1 else ((cols[0], cols[1]), (cols[2], cols[3]))


def reduce_input(curve, ext, cw, n, lanes, dev, rows=None, seed=5):
    """(st_all, dsort, xyT, m) for n tiled points with the windows described
    in the module's docstring, sorted over `lanes` lanes (None: the card's
    rule) and scanned by K-scan, or its plain twin on the CPU.  `rows` of
    cw-bit digits (None: as many as the scalar field's bits take, the top
    one below its bits; fewer add the recode's carry window)."""
    cv = CURVES[curve]
    m = msm_gpu.get_msm(cv.name, "g1" if ext == 1 else "g2", cw=cw)
    bits = cv.fr.p.bit_length()
    rows = rows or -(-bits // cw)
    g = torch.Generator().manual_seed(seed)
    scal = torch.randint(0, 1 << cw, (rows, n), generator=g, dtype=torch.int32)
    scal[1:3] = 0                                   # window 1: 0 and 1; window 2: all 0
    scal[3] = torch.randint(0, 40, (n,), generator=g)
    if cw * rows >= bits:
        scal[-1] %= 1 << (bits - cw * (rows - 1))
    idx = torch.randint(0, TABLE[ext], (n,), generator=g)
    px, py = _coords(cv, ext, _table(cv, ext), idx, dev)
    xyT = m.scan_input(px, py, torch.zeros(n, dtype=torch.bool, device=dev),
                       scal.to(dev), lanes=lanes)
    nw, C, _, RL = xyT.shape
    dsort = xyT[:, :, -1].permute(0, 2, 1).reshape(nw, C * RL)   # position l*C + c
    return msm_gpu.scan(cv.fq, m.b, ext, xyT), dsort, xyT, m


def affine_windows(fq, flat, ext):
    """(3*nl*ext, nw) projective window partials -> affine host points."""
    nl = fq.nl
    flat = ftorch.to_numpy(flat) if isinstance(flat, torch.Tensor) else flat
    ints = ftorch.np_to_ints(fq, flat.reshape(3 * ext, nl, -1).transpose(1, 0, 2))
    nw = flat.shape[1]
    out = []
    for w in range(nw):
        at = lambda k: fq.from_mont(ints[k * nw + w])
        el = lambda k: at(k) if ext == 1 else (at(2 * k), at(2 * k + 1))
        X, Y, Z = el(0), el(1), el(2)
        if msm_mod._f_is_zero(Z, ext):
            out.append(None)
            continue
        zi = msm_gpu._f_inv(fq, Z, ext)
        out.append((msm_mod._f_mul(fq, X, zi, ext), msm_mod._f_mul(fq, Y, zi, ext)))
    return out


def bucket_sums(cv, ext, xyT):
    """sum_b b * B_b of each window on host bigints, from the sorted points
    and keys mag*2 + sign that K-scan reads."""
    fq = cv.fq
    nl = fq.nl
    xy = ftorch.to_numpy(xyT)                        # (nw, C, nl*ext + 1, RL) words
    nw, C, nin, RL = xy.shape
    add, mul, neg = ((hc.g1_add, hc.g1_mul, hc.g1_neg) if ext == 1 else
                     (hc.g2_add, hc.g2_mul, hc.g2_neg))
    out = []
    for w in range(nw):
        words = xy[w].transpose(1, 0, 2).reshape(nin, C * RL)
        limbs = np.stack([words[:-1] & 0xFFFF, words[:-1] >> 16], axis=1)
        limbs = limbs.reshape(2 * ext, nl, -1).transpose(1, 0, 2).reshape(nl, -1)
        vals = [fq.from_mont(v) for v in ftorch.np_to_ints(fq, limbs)]   # [k*C*RL + j]
        total = None
        for j in range(C * RL):
            key = int(words[-1, j])
            if key < 2:
                continue
            c = [vals[k * C * RL + j] for k in range(2 * ext)]
            pt = (c[0], c[1]) if ext == 1 else ((c[0], c[1]), (c[2], c[3]))
            pt = mul(cv, neg(cv, pt) if key & 1 else pt, key >> 1)
            total = add(cv, total, pt)
        out.append(total)
    return out


@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("ext", [1, 2])
def test_reduce_plain_equals_the_bucket_sum(curve, ext):
    """cw = 8, four digit rows and the carry window, 20 points over 16 lanes
    (C = 2, 12 padding points: the first lanes are padding only): each
    window's partial is sum_b b*B_b, and the CPU path launches nothing
    (`k_reduce` stays 0)."""
    assert "k_reduce" in trace.COUNTERS
    cv = CURVES[curve]
    st_all, dsort, xyT, m = reduce_input(curve, ext, 8, 20, 16, "cpu", rows=4)
    assert (xyT[:, :, -1] & 1).any() and (dsort[2] == 0).all() and dsort[1].max() <= 3
    trace.reset_counters()
    flat = msm_gpu.reduce(cv.fq, m.b, ext, 8, st_all, dsort)
    assert trace.counters()["k_reduce"] == 0
    got = affine_windows(cv.fq, flat, ext)
    assert got == bucket_sums(cv, ext, xyT)
    assert got[2] is None and got[0] is not None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; K-reduce has no CPU mode")
    return torch.device("cuda")


# (cw, points, lanes): the 2^22 cells' A, B1, B2 and C shape (16, 293, ., 8192)
# at the card's lane rule, the H shape (16, 512, ., 8192), on G1 only as in
# the prover, and a cw = 8 shape of 200 lanes (no multiple of a block) with
# whole lanes of padding
SHAPES = {"p22": (16, 2_400_002, None), "p22_h": (16, 1 << 22, None),
          "cw8": (8, 3_000, 200)}
CARD_CASES = [(curve, ext, shape) for curve in sorted(CURVES) for ext in (1, 2)
              for shape in ("p22", "cw8")] + [(curve, 1, "p22_h") for curve in sorted(CURVES)]


@pytest.mark.cuda
@pytest.mark.parametrize("curve,ext,shape", CARD_CASES)
def test_k_reduce_matches_reduce_plain_on_card(card, curve, ext, shape):
    cw, n, lanes = SHAPES[shape]
    cv = CURVES[curve]
    st_all, dsort, xyT, m = reduce_input(curve, ext, cw, n, lanes, card)
    if shape != "cw8":
        assert tuple(xyT.shape[:2]) == (16, -(-n // 8192)) and xyT.shape[3] == 8192
    del xyT
    before = trace.counters()["k_reduce"]
    got = msm_gpu.reduce(cv.fq, m.b, ext, cw, st_all, dsort)
    torch.cuda.synchronize()
    assert trace.counters()["k_reduce"] - before <= 4
    want = msm_gpu.reduce_plain(cv.fq, m.b, ext, cw, st_all, dsort)
    got, want = affine_windows(cv.fq, got, ext), affine_windows(cv.fq, want, ext)
    assert got == want
    assert got[2] is None and all(p is not None for i, p in enumerate(got) if i != 2)
