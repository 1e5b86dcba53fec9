"""snarkjs_tpu_torch field ops (plain versions on the CPU) against fjnp.

Exact: limbs equal.  Inputs from a numpy seed, with the edge values 0, 1,
p-1, and to_mont of limbs in [p, R) (the wide sums of the Groth16 buildABC).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from snarkjs_tpu.fields import fjnp
from snarkjs_tpu_torch.fields import ftorch
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

FIELDS = ["bn254_fr", "bn254_fq", "bls12_381_fr", "bls12_381_fq"]


def _values(fp, seed, n=61):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(fp.n8), "little") % fp.p for _ in range(n)]
    return [0, 1, fp.p - 1] + vals


def _pair(name):
    ctx_j, ctx_t = fjnp.get_ctx(name), ftorch.get_ctx(name)
    fp = ctx_j.fp
    a = _values(fp, 1)
    b = _values(fp, 2)[::-1]
    A, B = fjnp.np_from_ints(fp, a), fjnp.np_from_ints(fp, b)
    return ctx_j, ctx_t, A, B


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_fjnp(name, op):
    ctx_j, ctx_t, A, B = _pair(name)
    want = np.asarray(getattr(fjnp, op)(ctx_j, jnp.asarray(A), jnp.asarray(B)))
    got = getattr(ftorch, op)(ctx_t, ftorch.to_tensor(A, "cpu"),
                              ftorch.to_tensor(B, "cpu"))
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont"])
def test_unary_ops_match_fjnp(name, op):
    ctx_j, ctx_t, A, _ = _pair(name)
    want = np.asarray(getattr(fjnp, op)(ctx_j, jnp.asarray(A)))
    got = getattr(ftorch, op)(ctx_t, ftorch.to_tensor(A, "cpu"))
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)


@pytest.mark.parametrize("name", FIELDS)
def test_to_mont_of_wide_limbs(name):
    ctx_j, ctx_t = fjnp.get_ctx(name), ftorch.get_ctx(name)
    fp = ctx_j.fp
    R = 1 << (16 * fp.nl)
    wide = [fp.p, fp.p + 1, R - 1, R - fp.p, (fp.p + R) // 2]
    W = np.array([[(v >> (16 * i)) & 0xFFFF for v in wide]
                  for i in range(fp.nl)], dtype=np.uint32)
    want = np.asarray(fjnp.to_mont(ctx_j, jnp.asarray(W)))
    got = ftorch.to_mont(ctx_t, ftorch.to_tensor(W, "cpu"))
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)
    assert ftorch.np_to_ints(fp, got) == [fp.to_mont(v % fp.p) for v in wide]


@pytest.mark.parametrize("name", FIELDS)
def test_codecs_match_fjnp(name):
    fp = fjnp.get_ctx(name).fp
    vals = _values(fp, 3)
    arr = ftorch.np_from_ints(fp, vals)
    np.testing.assert_array_equal(arr, fjnp.np_from_ints(fp, vals))
    assert ftorch.np_to_ints(fp, arr) == fjnp.np_to_ints(fp, arr) == vals


def test_broadcast_matches_fjnp():
    ctx_j, ctx_t, A, B = _pair("bn254_fr")
    col = B[:, :1]
    want = np.asarray(fjnp.mont_mul(ctx_j, jnp.asarray(A), jnp.asarray(col)))
    got = ftorch.mont_mul(ctx_t, ftorch.to_tensor(A, "cpu"),
                          ftorch.to_tensor(col, "cpu"))
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)


@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fq"])
@pytest.mark.parametrize("e", [0, 1, 2, 0xF00D, "p-2"])
def test_exp_const_and_inv_match_fjnp(name, e):
    ctx_j, ctx_t, A, _ = _pair(name)
    A = A[:, :9]
    if e == "p-2":
        want = np.asarray(fjnp.inv(ctx_j, jnp.asarray(A)))
        got = ftorch.inv(ctx_t, ftorch.to_tensor(A, "cpu"))
        assert ftorch.np_to_ints(ctx_t.fp, got)[0] == 0     # 0 -> 0
    else:
        want = np.asarray(fjnp.exp_const(ctx_j, jnp.asarray(A), e))
        got = ftorch.exp_const(ctx_t, ftorch.to_tensor(A, "cpu"), e)
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)


@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fr"])
def test_batch_inverse_with_zeros_matches_fjnp(name):
    ctx_j, ctx_t = fjnp.get_ctx(name), ftorch.get_ctx(name)
    fp = ctx_j.fp
    vals = _values(fp, 4, n=21)          # starts 0, 1, p-1
    vals[7] = vals[8] = vals[-1] = 0     # zeros interspersed and at the end
    A = fjnp.np_from_ints(fp, [fp.to_mont(v) for v in vals])
    want = np.asarray(fjnp.batch_inverse(ctx_j, jnp.asarray(A), axis=1))
    got = ftorch.batch_inverse(ctx_t, ftorch.to_tensor(A, "cpu"), axis=1)
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)
    ints = [fp.from_mont(v) for v in ftorch.np_to_ints(fp, got)]
    assert ints == [pow(v, fp.p - 2, fp.p) for v in vals]
    A3 = A.reshape(fp.nl, 4, 6)
    for axis in (1, 2, -1):
        want = np.asarray(fjnp.batch_inverse(ctx_j, jnp.asarray(A3), axis=axis))
        got = ftorch.batch_inverse(ctx_t, ftorch.to_tensor(A3, "cpu"), axis=axis)
        np.testing.assert_array_equal(ftorch.to_numpy(got), want)
    with pytest.raises(ValueError, match="limb axis"):
        ftorch.batch_inverse(ctx_t, ftorch.to_tensor(A, "cpu"), axis=0)


def test_eq_sqr_one_match_fjnp():
    ctx_j, ctx_t, A, B = _pair("bn254_fr")
    B = B.copy()
    B[:, ::3] = A[:, ::3]
    At, Bt = ftorch.to_tensor(A, "cpu"), ftorch.to_tensor(B, "cpu")
    np.testing.assert_array_equal(
        ftorch.eq(ctx_t, At, Bt).numpy(),
        np.asarray(fjnp.eq(ctx_j, jnp.asarray(A), jnp.asarray(B))))
    np.testing.assert_array_equal(
        ftorch.to_numpy(ftorch.mont_sqr(ctx_t, At)),
        np.asarray(fjnp.mont_sqr(ctx_j, jnp.asarray(A))))
    np.testing.assert_array_equal(ftorch.to_numpy(ctx_t.one((2, 3))),
                                  np.asarray(ctx_j.one((2, 3))))
