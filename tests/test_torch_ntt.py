"""snarkjs_tpu_torch NTTs (plain versions on the CPU) against snarkjs_tpu.

Butterfly ntt/intt/apply_powers against ntt.py; the digit-matmul NTT against
ntt_mxu (at the sizes tests/test_ntt_mxu.py runs on the CPU); the plain
digit matmul against ntt_mxu._einsum_mm and _normalize_cols against its JAX
counterpart.  Exact: limbs equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkjs_tpu.fields import fjnp
from snarkjs_tpu.ntt import ntt as jntt
from snarkjs_tpu.ntt import ntt_mxu
from snarkjs_tpu_torch.fields import ftorch
from snarkjs_tpu_torch.ntt import ntt as tntt
from snarkjs_tpu_torch.ntt import ntt_mm

FR = "bn254_fr"


def _data(k, seed=0):
    fp = fjnp.get_ctx(FR).fp
    rng = np.random.default_rng(seed + k)
    vals = [int.from_bytes(rng.bytes(32), "little") % fp.p for _ in range(1 << k)]
    return fjnp.np_from_ints(fp, vals)


@pytest.mark.parametrize("k", [1, 6, 11])
@pytest.mark.parametrize("fn", ["ntt", "intt"])
def test_butterfly_matches_jax(k, fn):
    A = _data(k)
    want = np.asarray(getattr(jntt, fn)(fjnp.get_ctx(FR), jnp.asarray(A)))
    got = getattr(tntt, fn)(ftorch.get_ctx(FR), ftorch.to_tensor(A, "cpu"))
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)


@pytest.mark.parametrize("k", [1, 6, 11])
def test_apply_powers_matches_jax(k):
    A = _data(k, 1)
    fp = fjnp.get_ctx(FR).fp
    want = np.asarray(jntt.apply_powers(fjnp.get_ctx(FR), jnp.asarray(A), 3,
                                        fp.w[k + 1]))
    got = tntt.apply_powers(ftorch.get_ctx(FR), ftorch.to_tensor(A, "cpu"), 3,
                            fp.w[k + 1])
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)
    want = np.asarray(jntt.coset_shift(fjnp.get_ctx(FR), jnp.asarray(A)))
    got = tntt.coset_shift(ftorch.get_ctx(FR), ftorch.to_tensor(A, "cpu"))
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)


@pytest.mark.parametrize("k", [6, 11])
@pytest.mark.parametrize("fn", ["ntt", "intt"])
def test_digit_matmul_ntt_matches_ntt_mxu(k, fn):
    A = _data(k, 2)
    want = np.asarray(getattr(ntt_mxu, fn)(fjnp.get_ctx(FR), jnp.asarray(A)))
    got = getattr(ntt_mm, fn)(ftorch.get_ctx(FR), ftorch.to_tensor(A, "cpu"))
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)


def _digit_inputs(r, q, m, seed=3):
    fp = fjnp.get_ctx(FR).fp
    rng = np.random.default_rng(seed)
    W8 = rng.integers(-128, 128, (fp.n8 + 1, r, q)).astype(np.int8)
    limbs = rng.integers(0, 1 << 16, (fp.nl, q, m)).astype(np.uint32)
    D8 = np.asarray(ntt_mxu._to_digits(fp, jnp.asarray(limbs)))
    return fp, W8, D8


@pytest.mark.parametrize("r,q,m", [(8, 8, 16), (32, 32, 4)])
def test_digit_mm_plain_matches_einsum(r, q, m):
    fp, W8, D8 = _digit_inputs(r, q, m)
    want = np.asarray(ntt_mxu._einsum_mm(jnp.asarray(W8), jnp.asarray(D8)))
    got = ntt_mm.digit_mm(torch.tensor(W8), torch.tensor(D8))
    np.testing.assert_array_equal(got.numpy(), want)
    dj = np.asarray(ntt_mxu._to_digits(fp, jnp.asarray(_data(4, 5).reshape(
        fp.nl, 4, 4))))
    dt = ntt_mm._to_digits(fp, ftorch.to_tensor(_data(4, 5), "cpu").reshape(
        fp.nl, 4, 4))
    np.testing.assert_array_equal(dt.numpy(), dj)


def test_normalize_cols_matches_jax():
    fp, _, D8 = _digit_inputs(32, 32, 8, seed=4)
    W8 = np.asarray(ntt_mxu._w_matrix_digits(FR, 5, False))
    cols = np.asarray(ntt_mxu._einsum_mm(jnp.asarray(W8), jnp.asarray(D8)))
    want = np.asarray(ntt_mxu._normalize_cols(fp, jnp.asarray(cols)))
    got = ntt_mm._normalize_cols(fp, torch.tensor(cols))
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)
