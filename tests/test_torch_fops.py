"""snarkjs_tpu_torch.poly.fops (plain field ops on the CPU) against
snarkjs_tpu.poly.fops, function by function.

Inputs from a numpy seed, Montgomery form; equality is limb for limb (every
result is a canonical residue, so the scan's association order cannot show).
Also the port's `ftorch.assoc_scan` against a serial loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkjs_tpu.fields import fjnp
from snarkjs_tpu.poly import fops as jfops
from snarkjs_tpu_torch.fields import ftorch
from snarkjs_tpu_torch.poly import fops as tfops
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

FR = "bn254_fr"
CJ, CT = fjnp.get_ctx(FR), ftorch.get_ctx(FR)
FP = CJ.fp


def _mont(n, seed):
    rng = np.random.default_rng(seed)
    vals = [0, 1, FP.p - 1] + [int.from_bytes(rng.bytes(32), "little") % FP.p
                               for _ in range(n - 3)]
    return fjnp.np_from_ints(FP, [FP.to_mont(v) for v in vals[:n]])


def _t(a):
    return ftorch.to_tensor(a, "cpu")


def _same(got, want):
    np.testing.assert_array_equal(ftorch.to_numpy(got), np.asarray(want))


def test_scalar_arr_and_powers_of():
    x = 0x1234567890ABCDEF
    _same(tfops.scalar_arr(CT, x), jfops.scalar_arr(CJ, x))
    _same(tfops.scalar_arr(CT, FP.p + 5), jfops.scalar_arr(CJ, FP.p + 5))
    for n in (1, 2, 13, 64):
        _same(tfops.powers_of(CT, tfops.scalar_arr(CT, x), n),
              jfops.powers_of(CJ, jfops.scalar_arr(CJ, x), n))


@pytest.mark.parametrize("n", [1, 7, 64])
def test_field_sum_and_poly_eval(n):
    A = _mont(max(n, 3), 1)[:, :n]
    _same(tfops.field_sum(CT, _t(A)), jfops.field_sum(CJ, jnp.asarray(A)))
    x = 0xC0FFEE
    assert tfops.poly_eval(CT, _t(A), x) == jfops.poly_eval(CJ, jnp.asarray(A), x)


def test_field_sum_across_chunks():
    # more than one chunk of 2^14: all elements p - 1, so the limb sums carry
    n = (1 << 14) + 5
    A = np.tile(fjnp.np_from_ints(FP, [FP.p - 1]), (1, n))
    got = ftorch.np_to_ints(FP, tfops.field_sum(CT, _t(A)))[0]
    assert got == n * (FP.p - 1) % FP.p


def test_div_zh():
    A = _mont(64, 2)
    _same(tfops.div_zh(CT, _t(A), 16), jfops.div_zh(CJ, jnp.asarray(A), 16))


@pytest.mark.parametrize("n", [2, 9, 32])
def test_div_by_x_minus(n):
    A = _mont(max(n, 3), 3)[:, :n]
    xi = 0xABCDEF0123
    qt, rt = tfops.div_by_x_minus(CT, _t(A), tfops.scalar_arr(CT, xi))
    qj, rj = jfops.div_by_x_minus(CJ, jnp.asarray(A), jfops.scalar_arr(CJ, xi))
    _same(qt, qj)
    _same(rt, rj)
    # remainder is P(xi)
    assert FP.from_mont(ftorch.np_to_ints(FP, rt)[0]) == \
        tfops.poly_eval(CT, _t(A), xi)


def test_div_by_zerofier():
    A = _mont(40, 4)
    beta = 0x77777
    _same(tfops.div_by_zerofier(CT, _t(A), 8, beta),
          jfops.div_by_zerofier(CJ, jnp.asarray(A), 8, beta))
    _same(tfops.div_by_zerofier(CT, _t(A[:, :37]), 8, beta),
          jfops.div_by_zerofier(CJ, jnp.asarray(A[:, :37]), 8, beta))


def test_shift_pad_add_many():
    A, B = _mont(10, 5), _mont(6, 6)
    _same(tfops.shift_coefs(CT, _t(A), 3), jfops.shift_coefs(CJ, jnp.asarray(A), 3))
    for n in (4, 10, 15):
        _same(tfops.pad_to(_t(A), n), jfops.pad_to(jnp.asarray(A), n))
    w = 0x5555
    got = tfops.add_many(CT, [(_t(A), None), (_t(B), tfops.scalar_arr(CT, w)),
                              (_t(A), tfops.scalar_arr(CT, 3))], 12)
    want = jfops.add_many(CJ, [(jnp.asarray(A), None),
                               (jnp.asarray(B), jfops.scalar_arr(CJ, w)),
                               (jnp.asarray(A), jfops.scalar_arr(CJ, 3))], 12)
    _same(got, want)


def test_host_interpolation_and_zerofier():
    xs, ys = [3, 5, 11, 1 << 70], [7, 0, FP.p - 1, 12345]
    assert tfops.lagrange_interp_host(FP, xs, ys) == \
        jfops.lagrange_interp_host(FP, xs, ys)
    assert tfops.zerofier_host(FP, xs) == jfops.zerofier_host(FP, xs)
    coefs = tfops.lagrange_interp_host(FP, xs, ys)
    for x, y in zip(xs, ys):
        assert sum(c * pow(x, k, FP.p) for k, c in enumerate(coefs)) % FP.p == y


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33])
def test_assoc_scan_matches_serial_loop(n):
    """Integer addition and the affine pair (s -> m*s + a mod 1009), scanned
    in log depth, against the running values of a plain loop."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(0, 1000, (3, n)))
    np.testing.assert_array_equal(
        ftorch.assoc_scan(lambda a, b: a + b, x).numpy(),
        np.cumsum(x.numpy(), axis=1))
    m = torch.from_numpy(rng.integers(1, 1009, (3, n)))
    a = torch.from_numpy(rng.integers(0, 1009, (3, n)))
    op = lambda l, r: (l[0] * r[0] % 1009, (r[0] * l[1] + r[1]) % 1009)
    ms, as_ = ftorch.assoc_scan(op, (m, a))
    s_m, s_a = m[:, 0].clone(), a[:, 0].clone()
    for k in range(n):
        if k:
            s_m, s_a = s_m * m[:, k] % 1009, (m[:, k] * s_a + a[:, k]) % 1009
        assert torch.equal(ms[:, k], s_m) and torch.equal(as_[:, k], s_a)
