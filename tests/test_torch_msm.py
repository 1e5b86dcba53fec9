"""snarkjs_tpu_torch MSM (plain versions on the CPU, cw=8, 128 lanes)
against snarkjs_tpu's TpuMSM and host bigints.

The point sets of tests/test_msm_tpu.py.  Window partials are compared as
affine points: the projective representative depends on the sort order and
the lane count, the group element does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkjs_tpu.curves import host_curve as hc
from snarkjs_tpu.curves import msm as jmsm
from snarkjs_tpu.curves import msm_tpu
from snarkjs_tpu.fields import fjnp
from snarkjs_tpu_torch.curves import msm as tmsm
from snarkjs_tpu_torch.curves import msm_gpu
from snarkjs_tpu_torch.fields import ftorch
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CW, NW = 8, 2


def _points(cv, n, g2):
    add = hc.g2_add if g2 else hc.g1_add
    gen = cv.g2 if g2 else cv.g1
    pts, acc = [], gen
    for _ in range(n):
        pts.append(acc)
        acc = add(cv, acc, gen)
    fq = cv.fq

    def coords(f):
        return fjnp.np_from_ints(fq, [fq.to_mont(f(p)) for p in pts])

    if not g2:
        return pts, coords(lambda p: p[0]), coords(lambda p: p[1])
    return (pts, (coords(lambda p: p[0][0]), coords(lambda p: p[0][1])),
            (coords(lambda p: p[1][0]), coords(lambda p: p[1][1])))


def _scalars(seed, n):
    rng = np.random.default_rng(seed)
    ints = [int(rng.integers(0, 1 << (CW * NW))) for _ in range(n)]
    ints[0] = 0
    ints[1] = 1
    ints[2] = 1 << CW
    ints[3] = ints[4] = ints[5]
    scal = np.array([[(v >> (CW * w)) & ((1 << CW) - 1) for v in ints]
                     for w in range(NW)], dtype=np.uint32)
    return ints, scal


CASES = {
    "g1_bn254": (hc.BN254, False, 150, 11, 6),
    "g2_bn254": (hc.BN254, True, 60, 12, None),
    "g1_bls12_381": (hc.BLS12_381, False, 100, 13, None),
}


def _tensor(a):
    if isinstance(a, tuple):
        return tuple(_tensor(x) for x in a)
    return ftorch.to_tensor(a, "cpu")


def _affine_windows(fq, flat, ext):
    """(nro, nw) projective window partials -> affine host points."""
    nl = fq.nl
    out = []
    for w in range(flat.shape[1]):
        coord = [fjnp.np_to_ints(fq, flat[i * nl:(i + 1) * nl, w:w + 1])[0]
                 for i in range(3 * ext)]
        if ext == 1:
            X, Y, Z = coord
            if Z == 0:
                out.append(None)
                continue
            zi = pow(Z, fq.p - 2, fq.p)
            out.append((X * zi % fq.p, Y * zi % fq.p))
        else:
            X, Y, Z = (coord[0], coord[1]), (coord[2], coord[3]), (coord[4], coord[5])
            if Z == (0, 0):
                out.append(None)
                continue
            zi = msm_tpu._f_inv(fq, Z, 2)
            out.append((jmsm._f_mul(fq, X, zi, 2), jmsm._f_mul(fq, Y, zi, 2)))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_msm_matches_tpu_msm_and_host(case):
    cv, g2, n, seed, inf_at = CASES[case]
    ext = 2 if g2 else 1
    pts, px, py = _points(cv, n, g2)
    ints, scal = _scalars(seed, n)
    pinf = np.zeros(n, dtype=bool)
    if inf_at is not None:
        pinf[inf_at] = True
    b = cv.b2 if g2 else cv.b
    gen = cv.g2 if g2 else cv.g1
    jm = msm_tpu.TpuMSM(cv.fq, cv.fr, b, gen, ext=ext, cw=CW)
    tm = msm_gpu.GpuMSM(cv.fq, cv.fr, b, ext=ext, cw=CW)

    # window partials, as affine points
    jflat = np.asarray(jm._jitted(2, NW)(
        *jnp_pad(px, py, pinf, scal, 2 * msm_tpu.LN)))
    tin = msm_gpu._pad_to(2 * msm_gpu.LN, _tensor(px), _tensor(py),
                          torch.from_numpy(pinf), _tensor(scal))
    tflat = ftorch.to_numpy(tm._program(2, msm_gpu.LN, tm.n_windows(NW))(*tin))
    assert _affine_windows(cv.fq, tflat, ext) == _affine_windows(cv.fq, jflat, ext)

    # the full MSM against both references
    got = tmsm.host_jac_to_affine(cv.fq, tm.run(_tensor(px), _tensor(py),
                                                torch.from_numpy(pinf),
                                                _tensor(scal)), ext)
    want_j = jmsm.host_jac_to_affine(cv.fq, jm.run(
        jax_tree(px), jax_tree(py), pinf, jnp.asarray(scal)), ext)
    mul, add = (hc.g2_mul, hc.g2_add) if g2 else (hc.g1_mul, hc.g1_add)
    want = None
    for i, v in enumerate(ints):
        if pinf[i] or v == 0:
            continue
        p = mul(cv, pts[i], v)
        want = p if want is None else add(cv, want, p)
    assert got == want_j == want


def jax_tree(a):
    if isinstance(a, tuple):
        return tuple(jax_tree(x) for x in a)
    return jnp.asarray(a)


def jnp_pad(px, py, pinf, scal, target):
    return msm_tpu.TpuMSM._pad_to(target, jax_tree(px), jax_tree(py),
                                  jnp.asarray(pinf), jnp.asarray(scal))


def test_context_narrows_window_off_card():
    cv = hc.BN254
    pts, px, py = _points(cv, 20, False)
    ints = list(range(3, 23))
    scal = fjnp.np_from_ints(cv.fr, ints)
    ctx = tmsm.MSMContext(ftorch.get_ctx(cv.fq.name), cv.fq, extension=1)
    got = tmsm.host_jac_to_affine(cv.fq, ctx.run(
        _tensor(px), _tensor(py), torch.zeros(20, dtype=torch.bool),
        _tensor(scal), cw=16), 1)
    want = hc.g1_mul(cv, cv.g1, sum((i + 1) * v for i, v in enumerate(ints)))
    assert got == want
