"""snarkjs_tpu_torch's Jacobian ops (`curves/jac.py` over `curves/gops.py`)
and `msm.segmented_msm` against snarkjs_tpu on the CPU.

The same seeded inputs (numpy, host bigints) go through both packages, on
bn254 and bls12-381, G1 and G2.  Tolerance: none.  `jac_dbl`, `jac_add`
(every special case) and `batch_scalar_mul` agree limb for limb in Jacobian
coordinates, `to_affine_batch` limb for limb, `segmented_msm` byte for byte
in affine LEM form (its schedule differs from the JAX package's two-level
scan; the sums are the same points).
"""

import numpy as np
import pytest
import torch

from snarkjs_tpu.curves import gops as jgops
from snarkjs_tpu.curves import host_curve as jhc
from snarkjs_tpu.curves import jac as jjac
from snarkjs_tpu.curves import msm as jmsm
from snarkjs_tpu.fields import fjnp
from snarkjs_tpu.formats import points as jpc
from snarkjs_tpu_torch.curves import gops as tgops
from snarkjs_tpu_torch.curves import jac as tjac
from snarkjs_tpu_torch.curves import msm as tmsm
from snarkjs_tpu_torch.fields import ftorch
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CASES = [("bn128", False), ("bn128", True), ("bls12381", False), ("bls12381", True)]


def _ops(cv, g2):
    cj, ct = fjnp.get_ctx(cv.fq.name), ftorch.get_ctx(cv.fq.name)
    if g2:
        return jgops.Fq2Ops(cj), tgops.Fq2Ops(ct, "cpu")
    return jgops.FqOps(cj), tgops.FqOps(ct, "cpu")


def _affine(cv, g2, ks):
    """[k]G for each k (k = 0: infinity) as (x, y, inf), Montgomery limbs."""
    fq = cv.fq
    mul, gen = (jhc.g2_mul, cv.g2) if g2 else (jhc.g1_mul, cv.g1)
    pts = [mul(cv, gen, k) if k else None for k in ks]
    lem = (jpc.g2_lem_from_ints if g2 else jpc.g1_lem_from_ints)(fq, pts)
    return (jpc.g2_lem_from_bytes if g2 else jpc.g1_lem_from_bytes)(fq, lem, len(ks))


def _t(a):
    if isinstance(a, tuple):
        return tuple(_t(x) for x in a)
    a = np.asarray(a)
    return torch.from_numpy(a.copy()) if a.dtype == bool else ftorch.to_tensor(a, "cpu")


def _leaves(a):
    if isinstance(a, (tuple, list)):
        return [y for x in a for y in _leaves(x)]
    return [a]


def _assert_equal(want, got):
    """JAX pytree against port tree, exactly."""
    w, g = _leaves(want), _leaves(got)
    assert len(w) == len(g)
    for a, b in zip(w, g):
        b = b.numpy() if b.dtype == torch.bool else ftorch.to_numpy(b)
        np.testing.assert_array_equal(np.asarray(a), b)


def _pair(cv, g2, seed, n):
    """Two Jacobian batches (Z = 1) on both sides with every special case of
    jac_add: Q = P (doubling), Q = -P (cancel), infinite P, Q and both."""
    rng = np.random.default_rng(seed)
    r = cv.fr.p
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(n)]
    qs = [int(rng.integers(1, 1 << 62)) for _ in range(n)]
    qs[0] = ks[0]
    qs[1] = r - ks[1]
    qs[2] = 0
    ks[3] = 0
    ks[4] = qs[4] = 0
    fj, ft = _ops(cv, g2)
    P, Q = _affine(cv, g2, ks), _affine(cv, g2, qs)
    PJ, QJ = jjac.from_affine(fj, *P), jjac.from_affine(fj, *Q)
    PT, QT = tjac.from_affine(ft, *_t(P)), tjac.from_affine(ft, *_t(Q))
    return fj, ft, PJ, QJ, PT, QT


@pytest.mark.parametrize("curve,g2", CASES)
def test_dbl_and_add_limb_for_limb(curve, g2):
    cv = jhc.get_curve(curve)
    fj, ft, PJ, QJ, PT, QT = _pair(cv, g2, 11, 8)
    _assert_equal(PJ, PT)
    _assert_equal(jjac.jac_dbl(fj, PJ), tjac.jac_dbl(ft, PT))
    _assert_equal(jjac.jac_add(fj, PJ, QJ), tjac.jac_add(ft, PT, QT))
    # Z != 1 on both operands; the special cases survive the doubling
    DJ, EJ = jjac.jac_dbl(fj, PJ), jjac.jac_dbl(fj, QJ)
    DT, ET = tjac.jac_dbl(ft, PT), tjac.jac_dbl(ft, QT)
    sumJ, sumT = jjac.jac_add(fj, DJ, EJ), tjac.jac_add(ft, DT, ET)
    _assert_equal(sumJ, sumT)
    _assert_equal(jjac.jac_neg(fj, sumJ), tjac.jac_neg(ft, sumT))
    inf = tjac.is_inf(ft, sumT).numpy()
    np.testing.assert_array_equal(np.asarray(jjac.is_inf(fj, sumJ)), inf)
    assert inf[1] and inf[4] and not inf[0] and not inf[2] and not inf[3]
    mask = np.arange(8) % 3 == 0
    _assert_equal(jjac.jac_select(fj, mask, DJ, EJ),
                  tjac.jac_select(ft, torch.from_numpy(mask), DT, ET))


@pytest.mark.parametrize("curve,g2", CASES)
def test_batch_scalar_mul_and_to_affine(curve, g2):
    """10 bits of random scalars: the bit count is a shape, so 10 steps run the
    same step as 254."""
    cv = jhc.get_curve(curve)
    fj, ft, PJ, _, PT, _ = _pair(cv, g2, 12, 8)
    bits = np.random.default_rng(13).integers(0, 2, (10, 8)).astype(np.uint32)
    bits[:, 5] = 0                                  # k = 0: infinity
    accJ = jjac.batch_scalar_mul(fj, PJ, bits)
    accT = tjac.batch_scalar_mul(ft, PT, torch.from_numpy(bits.astype(np.int8)))
    _assert_equal(accJ, accT)
    _assert_equal(jjac.to_affine_batch(fj, accJ, fj.batch_inv),
                  tjac.to_affine_batch(ft, accT, ft.batch_inv))


def test_scalar_bits_and_limbs_form():
    fr = jhc.get_curve("bn128").fr
    rng = np.random.default_rng(14)
    ks = [0, 1, fr.p - 1] + [int.from_bytes(rng.bytes(32), "little") % fr.p
                             for _ in range(5)]
    sl = fjnp.np_from_ints(fr, ks)
    want = np.asarray(jjac.scalar_bits_from_limbs(sl, 256))
    got = tjac.scalar_bits_from_limbs(_t(sl), 256)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(want, got.numpy())
    assert tjac.scalar_bit_length(_t(sl)) == fr.p.bit_length()
    assert tjac.scalar_bit_length(_t(fjnp.np_from_ints(fr, [0, 5, 1 << 20]))) == 21
    assert tjac.scalar_bit_length(_t(fjnp.np_from_ints(fr, [0, 0]))) == 0
    # the limbs form runs the same steps as the bit array
    cv = jhc.get_curve("bn128")
    _, ft, _, _, PT, _ = _pair(cv, False, 15, 8)
    small = _t(fjnp.np_from_ints(fr, [int(x) for x in rng.integers(0, 1 << 12, 8)]))
    _assert_equal(tjac.batch_scalar_mul(ft, PT, tjac.scalar_bits_from_limbs(small, 12)),
                  tjac.batch_scalar_mul_limbs(ft, PT, small, 12))


@pytest.mark.parametrize("curve,g2", [("bn128", False), ("bls12381", True)])
def test_segmented_msm_matches_jax(curve, g2):
    """Empty segments (1, 4, 7), an infinite point (segment 3), a zero scalar,
    two terms that cancel (segment 6: 5*[23]G + 0*[29]G + 5*[-23]G +
    65535*[31]G), and two padding
    entries in the trash segment n_out as the JAX setup pads them; byte for
    byte in affine LEM form."""
    cv = jhc.get_curve(curve)
    fq, fr = cv.fq, cv.fr
    n_out = 8
    seg = np.array([0, 0, 2, 2, 2, 3, 5, 5, 6, 6, 6, 6, n_out, n_out], np.int32)
    ks = [3, 5, 7, 11, 13, 0, 17, 19, 23, 29, fr.p - 23, 31, 0, 0]
    scal = [9, 8, 7, 6, 5, 4, 3, 2, 5, 0, 5, 65535, 0, 0]
    x, y, inf = _affine(cv, g2, ks)
    sc = fjnp.np_from_ints(fr, scal)
    fj, ft = _ops(cv, g2)
    outJ = jmsm.segmented_msm(fj, x, y, inf, sc, seg, n_out, fr.p.bit_length(), R=7)
    outT = tmsm.segmented_msm(ft, *_t((x, y, inf)), _t(sc),
                              torch.from_numpy(seg.astype(np.int64)), n_out,
                              fr.p.bit_length())
    to_bytes = jpc.g2_lem_to_bytes if g2 else jpc.g1_lem_to_bytes
    want = to_bytes(fq, *(_np_jax(jjac.to_affine_batch(fj, outJ, fj.batch_inv))))
    got = to_bytes(fq, *_np_tree(tjac.to_affine_batch(ft, outT, ft.batch_inv)))
    assert got == want
    s_pt = (4 if g2 else 2) * fq.n8
    for k in (1, 4, 7):
        assert got[k * s_pt:(k + 1) * s_pt] == bytes(s_pt)
    mul = jhc.g2_mul if g2 else jhc.g1_mul
    gen = cv.g2 if g2 else cv.g1
    want6 = (jpc.g2_lem_from_ints if g2 else jpc.g1_lem_from_ints)(
        fq, [mul(cv, gen, 65535 * 31 % fr.p)])
    assert got[6 * s_pt:7 * s_pt] == want6


def _np_jax(a):
    if isinstance(a, tuple):
        return tuple(_np_jax(x) for x in a)
    return np.asarray(a)


def _np_tree(a):
    if isinstance(a, tuple):
        return tuple(_np_tree(x) for x in a)
    return a.numpy() if a.dtype == torch.bool else ftorch.to_numpy(a)


def test_segment_sums_rounds_and_trash():
    """A segment of 5 points takes three halving rounds; the trash segment is
    dropped; an empty batch gives n_out infinities."""
    cv = jhc.get_curve("bn128")
    fq = cv.fq
    _, ft = _ops(cv, False)
    x, y, inf = _affine(cv, False, [1, 2, 3, 4, 5, 6, 7])
    P = tjac.from_affine(ft, *_t((x, y, inf)))
    seg = torch.tensor([0, 0, 0, 0, 0, 2, 3])
    x, y, pinf = tjac.to_affine_batch(ft, tmsm.segment_sums(ft, P, seg, 3), ft.batch_inv)
    got = jpc.g1_lem_to_ints(fq, jpc.g1_lem_to_bytes(
        fq, ftorch.to_numpy(x), ftorch.to_numpy(y), pinf.numpy()), 3)
    assert got == [jhc.g1_mul(cv, cv.g1, 15), None, jhc.g1_mul(cv, cv.g1, 6)]
    empty = tmsm.segment_sums(ft, tuple(c[:, :0] for c in P), seg[:0], 4)
    assert tjac.is_inf(ft, empty).all() and empty[0].shape == (fq.nl, 4)
