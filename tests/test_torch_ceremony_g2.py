"""The G2 cases of the ceremony's device routes (ported from
snarkjs_tpu/ceremony/ptau_ops.py) against snarkjs_tpu on the CPU, apart from
test_torch_ceremony.py so that the test run can spread them: apply-key on 65
points, the group iNTT at k = 1, verify's MSM on 65 points, and the G2 point
codecs with their Fq2 square roots.  Tolerance: none; bytes and points
exact.  The JAX device routes' outputs are stored (tests/_torch_ceremony.py).
"""

import pytest

from snarkjs_tpu.ceremony import ptau_ops as J
from snarkjs_tpu.curves import host_curve as jhc
from snarkjs_tpu.curves import tower as jtw
from snarkjs_tpu.formats import points as jp
from snarkjs_tpu_torch.ceremony import ptau_ops as T
from snarkjs_tpu_torch.curves import host_curve as thc
from tests import _torch_ceremony as tc
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CPU = {"device": "cpu"}


def test_apply_key_g2_device_route_matches_jax():
    """65 points, one above the host cutover: one batched double-and-add
    over Fq2."""
    _, lem2 = tc.module_inputs(jhc.BN254, jp, jhc)
    out = T.apply_key_g2(thc.BN254, lem2, tc.AK_G2, tc.AK_FIRST, tc.AK_INC, **CPU)
    assert tc.sha(out) == tc.stored()["modules"]["apply_key_g2"]


def test_group_lagrange_g2_device_route_matches_jax():
    """G2 at k = 1 through the batched group iNTT (stage 0 multiplies
    nothing; the 1/2 is its own batch), against the JAX force_device=True
    output."""
    _, lem2 = tc.module_inputs(jhc.BN254, jp, jhc)
    out = T.group_lagrange_lem(thc.BN254, lem2, 2, True, force_device=True, **CPU)
    assert tc.sha(out) == tc.stored()["modules"]["group_lagrange_g2_k1"]


def test_msm_lem_g2_device_route_matches_jax():
    _, lem2 = tc.module_inputs(jhc.BN254, jp, jhc)
    got = T._msm_lem(thc.BN254, lem2[:tc.MSM_G2 * 128], tc.msm_scalars(thc.BN254, tc.MSM_G2),
                     True, **CPU)
    assert repr(got) == tc.stored()["modules"]["msm_g2"]


def _g2_points(cv):
    pts = [jhc.g2_mul(cv, cv.g2, 5 + 3 * i) for i in range(8)] + [None]
    return pts + [jhc.g2_neg(cv, P) for P in pts[:4]]


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_g2_codecs_match_jax(curve):
    """lem_to_c / c_to_lem / u_to_lem / lem_to_u on G2, both sign flags
    (ordered by c1, then c0) and the point at infinity, against the JAX host
    codecs."""
    tcv, jcv = getattr(thc, curve), getattr(jhc, curve)
    pts = _g2_points(jcv)
    lem = jp.g2_lem_from_ints(jcv.fq, pts)
    n = len(pts)
    c = J.lem_to_c(jcv, lem, n, True)
    assert T.lem_to_c(tcv, lem, n, True, **CPU) == c
    flags = {c[i * 2 * jcv.fq.n8] & 0xC0 for i in range(n)}
    assert flags == {0, 0x40, 0x80}
    assert T.c_to_lem(tcv, c, n, True, **CPU) == J.c_to_lem(jcv, c, n, True) == lem
    u = J.lem_to_u(jcv, lem, n, True)
    assert T.lem_to_u(tcv, lem, n, True, **CPU) == u
    assert T.u_to_lem(tcv, u, n, True, **CPU) == J.u_to_lem(jcv, u, n, True) == lem


def test_g2_sign_of_a_zero_c1():
    """A y with c1 = 0 takes its sign from c0 (the F2 order of the C
    encoding); the batch agrees with the JAX host codec on both signs."""
    cv = jhc.BN254
    p = cv.fq.p
    # y = (c0, 0): the JAX encoder's flag depends on c0 alone
    pts = [((1, 2), (3, 0)), ((1, 2), (p - 3, 0))]
    lem = jp.g2_lem_from_ints(cv.fq, pts)
    assert T.lem_to_c(thc.BN254, lem, 2, True, **CPU) == J.lem_to_c(cv, lem, 2, True)


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_g2_decompress_raises_off_the_curve(curve):
    """An x in Fq2 whose x^3 + b2 is no square (its norm is no square in Fq)
    raises ValueError, as in the JAX package."""
    tcv, jcv = getattr(thc, curve), getattr(jhc, curve)
    p, n8 = jcv.fq.p, jcv.fq.n8

    def non_square(x):
        a = jtw.f2_add(jtw.f2_mul(jtw.f2_mul(x, x, p), x, p), jcv.b2, p)
        return pow((a[0] * a[0] + a[1] * a[1]) % p, (p - 1) // 2, p) == p - 1

    x = next((a, 1) for a in range(2, 500) if non_square((a, 1)))
    pts = _g2_points(jcv)
    c = bytearray(J.lem_to_c(jcv, jp.g2_lem_from_ints(jcv.fq, pts), len(pts), True))
    c[2 * n8:4 * n8] = x[1].to_bytes(n8, "big") + x[0].to_bytes(n8, "big")
    for call in (lambda: J.c_to_lem(jcv, bytes(c), len(pts), True),
                 lambda: T.c_to_lem(tcv, bytes(c), len(pts), True, **CPU)):
        with pytest.raises(ValueError, match="not on the curve"):
            call()
