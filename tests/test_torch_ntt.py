"""snarkjs_tpu_torch NTTs (plain versions on the CPU) against snarkjs_tpu.

Butterfly ntt/intt/apply_powers against ntt.py; the digit-matmul NTT against
ntt_mxu (at the sizes tests/test_ntt_mxu.py runs on the CPU); the plain
digit matmul against ntt_mxu._einsum_mm and _normalize_cols against its JAX
counterpart.  Exact: limbs equal.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkjs_tpu.fields import fjnp
from snarkjs_tpu.ntt import ntt as jntt
from snarkjs_tpu.ntt import ntt_mxu
from snarkjs_tpu_torch import trace
from snarkjs_tpu_torch.fields import ftorch
from snarkjs_tpu_torch.ntt import ntt as tntt
from snarkjs_tpu_torch.ntt import ntt_mm
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

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


def _stages(k):
    """The log radices of a size-2^k NTT's stages in the order `_ntt_last`
    runs them: stage A's (the rest, recursively), then stage B's."""
    k1 = ntt_mm._split(k)
    return [k] if k1 == k else _stages(k - k1) + [k1]


@pytest.mark.parametrize("k", range(1, 29))
def test_split_is_fewest_balanced_stages(k):
    """ceil(k / MAX_LOG_R) stages of at most 2^MAX_LOG_R, log radices within
    one of each other, summing to k; one stage up to 2^10, 2^20 as 10 + 10
    (the 2^20 NTTs keep their shapes), no stage under 2^6 at 2^22; from
    2^12 on no stage has fewer rows than one K-mm-norm tile."""
    got = _stages(k)
    assert sum(got) == k and max(got) <= ntt_mm.MAX_LOG_R
    assert len(got) == -(-k // ntt_mm.MAX_LOG_R)
    assert max(got) - min(got) <= 1
    if k <= ntt_mm.MAX_LOG_R:
        assert got == [k]
    if k == 20:
        assert got == [10, 10]
    if k == 22:
        assert min(got) >= 6
    if k >= 12:
        assert min(got) >= ntt_mm.NORM_TILE_ROWS.bit_length() - 1


def test_norm_tile_rows_is_the_kernels():
    """`_split` gives no stage of a 2^12 or larger NTT fewer rows than one
    K-mm-norm tile: NORM_TILE_ROWS is the TK of the kernels' main loop."""
    src = open(os.path.join(os.path.dirname(ntt_mm.__file__), "..", "csrc",
                            "digit_mma.cuh")).read()
    assert int(re.search(r"constexpr int TK = (\d+);", src).group(1)) == ntt_mm.NORM_TILE_ROWS


@pytest.mark.parametrize("k", [7, 8, 9])
@pytest.mark.parametrize("fn", ["ntt", "intt"])
def test_balanced_stages_match_butterflies(fn, k, monkeypatch):
    """With stages of at most 2^3, k = 7, 8, 9 take three stages (2 + 2 + 3,
    2 + 3 + 3, 3 + 3 + 3; 2^7 would be 1 + 3 + 3 with a radix-2 stage under a
    fixed first radix): each output limb-equal to the JAX butterfly NTT, and
    the stages run as `_split` gives them."""
    monkeypatch.setattr(ntt_mm, "MAX_LOG_R", 3)
    radices, stage = [], ntt_mm._mm_stage

    def rec(ctx, kk, inverse, aT):
        radices.append(kk)
        return stage(ctx, kk, inverse, aT)

    monkeypatch.setattr(ntt_mm, "_mm_stage", rec)
    A = _data(k, 12)
    want = np.asarray(getattr(jntt, fn)(fjnp.get_ctx(FR), jnp.asarray(A)))
    got = getattr(ntt_mm, fn)(ftorch.get_ctx(FR), ftorch.to_tensor(A, "cpu"))
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)
    assert radices == _stages(k) and len(radices) == 3


def test_device_twiddle_table_is_built_once():
    """`_twiddle_parts_on` gives the same tensors on a second call, equal to
    the host parts; another device string is another entry."""
    args = (FR, 13, 7, False)
    builds = lambda: trace.counters()["table_builds"]
    first = ntt_mm._twiddle_parts_on(*args, "cpu")
    n = builds()
    again = ntt_mm._twiddle_parts_on(*args, "cpu")
    assert builds() == n
    assert again[0] == first[0] and again[1] is first[1] and again[2] is first[2]
    s, A, B = ntt_mm._twiddle_parts(*args)
    assert first[0] == s
    np.testing.assert_array_equal(ftorch.to_numpy(first[1]), A)
    np.testing.assert_array_equal(ftorch.to_numpy(first[2]), B)
    assert ntt_mm._twiddle_parts_on(FR, 13, 7, True, "cpu")[1] is not first[1]


@pytest.mark.parametrize("k", [12, 13])
def test_k_mm_round_trip_gives_the_input(k):
    """intt(ntt(a)) == a on the matmul route at 2^12 (6 + 6) and 2^13 (6 + 7),
    twice, so the second pass reads the twiddle tables the first built."""
    ctx = ftorch.get_ctx(FR)
    a = ftorch.to_tensor(_data(k, 5), "cpu")
    for _ in range(2):
        back = ntt_mm.intt(ctx, ntt_mm.ntt(ctx, a))
        assert torch.equal(back, a)


def _digit_inputs(r, q, m, seed=3):
    fp = fjnp.get_ctx(FR).fp
    rng = np.random.default_rng(seed)
    W8 = rng.integers(-128, 128, (fp.n8 + 1, r, q)).astype(np.int8)
    limbs = rng.integers(0, 1 << 16, (fp.nl, q, m)).astype(np.uint32)
    D8 = np.asarray(ntt_mxu._to_digits(fp, jnp.asarray(limbs)))
    return fp, W8, D8


@pytest.mark.parametrize("r,q,m", [(8, 8, 16), (32, 32, 4), (32, 32, 64),
                                   (64, 64, 32)])
def test_digit_mm_plain_matches_einsum(r, q, m):
    """K-mm's wrapper on CPU tensors against the JAX einsum; the last two
    shapes are a 2^11 NTT's two stages (5 + 6)."""
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


# ------------------------------------------- the fused digit matmul (K-mm-norm)

def test_digit_mm_norm_plain_matches_pallas_interpret():
    """The shape of tests/test_ntt_mxu.py's fused-kernel case: r = 256,
    m = 128, k = 8, against the Pallas kernel in interpret mode.  Exact."""
    fp = fjnp.get_ctx(FR).fp
    rng = np.random.default_rng(41)
    r, m, k = 256, 128, 8
    vals = [int.from_bytes(rng.bytes(40), "little") % fp.p for _ in range(r * m)]
    a = fjnp.np_from_ints(fp, vals).reshape(fp.nl, r, m)
    W8 = ntt_mxu._w_matrix_digits(fp.name, k, False)
    D8 = ntt_mxu._to_digits(fp, jnp.asarray(a))
    want = ntt_mxu._pallas_mm_norm(fp.name, r, r, m, 128, 128, interpret=True)(
        jnp.asarray(W8), D8)
    np.testing.assert_array_equal(
        ntt_mm._w_matrix_digits(fp.name, k, False), W8)
    got = ntt_mm.digit_mm_norm_plain(
        ftorch.get_ctx(FR).fp, torch.tensor(W8), torch.tensor(np.asarray(D8)))
    np.testing.assert_array_equal(ftorch.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("field", [FR, "bls12_381_fr"])
@pytest.mark.parametrize("r,q,m", [(4, 4, 24), (32, 32, 4), (5, 10, 6),
                                   (64, 64, 1)])
def test_digit_mm_norm_matches_normalized_einsum(field, r, q, m):
    """Edge shapes (r or m = 4, sizes that are no multiple of 4, and a 2^6
    NTT's one stage with m = 1), both Fr fields: the wrapper on CPU tensors
    against _normalize_cols(_einsum_mm)."""
    fpj = fjnp.get_ctx(field).fp
    rng = np.random.default_rng(r * 100 + m)
    W8 = rng.integers(-128, 128, (fpj.n8 + 1, r, q)).astype(np.int8)
    limbs = rng.integers(0, 1 << 16, (fpj.nl, q, m)).astype(np.uint32)
    D8 = np.asarray(ntt_mxu._to_digits(fpj, jnp.asarray(limbs)))
    want = ntt_mxu._normalize_cols(
        fpj, ntt_mxu._einsum_mm(jnp.asarray(W8), jnp.asarray(D8)))
    got = ntt_mm.digit_mm_norm(ftorch.get_ctx(field).fp, torch.tensor(W8),
                               torch.tensor(D8))
    np.testing.assert_array_equal(ftorch.to_numpy(got), np.asarray(want))


def test_norm_consts_layout():
    """The kernel's argument struct: F row-major int8 padded to 4 bytes, then
    p limbs, compensation limbs and mu as little-endian u32 words."""
    for field in (FR, "bls12_381_fr"):
        fp = ftorch.get_ctx(field).fp
        blob = ntt_mm._norm_consts(field)
        nh, F = ntt_mm._fold_tables(field, 2 * (fp.n8 + 1) - 1)
        nf = (nh + 1) * (fp.n8 + 1)
        assert len(blob) == (nf + 3) // 4 * 4 + 4 * (2 * (fp.nl + 1) + 1)
        np.testing.assert_array_equal(
            np.frombuffer(blob[:nf], dtype=np.int8).reshape(nh + 1, fp.n8 + 1), F)
        words = np.frombuffer(blob[(nf + 3) // 4 * 4:], dtype="<u4")
        p = sum(int(w) << (16 * i) for i, w in enumerate(words[:fp.nl + 1]))
        assert p == fp.p
        assert int(words[-1]) == (1 << (32 + fp.n8 * 8 - 6)) // fp.p


@pytest.mark.parametrize("q,m", [(8, 16), (5, 3)])
def test_y_major_is_to_digits_permuted(q, m):
    """The layout the kernels read: (nd, m, q), contiguous, equal to the JAX
    package's digits with the last two axes swapped."""
    fp = fjnp.get_ctx(FR).fp
    limbs = np.random.default_rng(q).integers(0, 1 << 16, (fp.nl, q, m)).astype(
        np.uint32)
    want = np.asarray(ntt_mxu._to_digits(fp, jnp.asarray(limbs))).transpose(0, 2, 1)
    got = ntt_mm._y_major(ntt_mm._to_digits(
        ftorch.get_ctx(FR).fp, ftorch.to_tensor(limbs, "cpu")))
    assert got.is_contiguous() and got.shape == (fp.n8 + 1, m, q)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrappers take either layout
    tfp = ftorch.get_ctx(FR).fp
    W8 = torch.tensor(np.random.default_rng(m).integers(
        -128, 128, (fp.n8 + 1, 4, q)).astype(np.int8))
    D8 = got.transpose(1, 2).contiguous()
    assert torch.equal(ntt_mm.digit_mm(W8, got, y_major=True), ntt_mm.digit_mm(W8, D8))
    assert torch.equal(ntt_mm.digit_mm_norm(tfp, W8, got, y_major=True),
                       ntt_mm.digit_mm_norm(tfp, W8, D8))


@pytest.mark.parametrize("field", [FR, "bls12_381_fr"])
def test_carry_then_reduce_is_normalize_cols(field):
    """K-mm-norm's epilogue starts from the digits its carry pass retired:
    reduce(carry(cols)) against ntt_mxu._normalize_cols on the same columns,
    and the digits are the base-256 digits of the columns' value.  Exact."""
    fpj = fjnp.get_ctx(field).fp
    fp = ftorch.get_ctx(field).fp
    rng = np.random.default_rng(11)
    W8 = rng.integers(-128, 128, (fpj.n8 + 1, 16, 16)).astype(np.int8)
    limbs = rng.integers(0, 1 << 16, (fpj.nl, 16, 6)).astype(np.uint32)
    D8 = ntt_mxu._to_digits(fpj, jnp.asarray(limbs))
    cols = np.asarray(ntt_mxu._einsum_mm(jnp.asarray(W8), D8))
    want = np.asarray(ntt_mxu._normalize_cols(fpj, jnp.asarray(cols)))
    digs = ntt_mm._carry_digits(torch.tensor(cols))
    assert digs.dtype == torch.uint8 and digs.shape[0] == cols.shape[0] + 3
    got = ntt_mm._reduce_digits(fp, digs)
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)
    value = sum(int(c) << (8 * i) for i, c in enumerate(cols[:, 3, 2]))
    assert value == sum(int(d) << (8 * i) for i, d in enumerate(digs[:, 3, 2]))


# ------------------------------------------------ extended and union domains

@pytest.mark.parametrize("factor", [2, 4])
def test_extend_evaluations_matches_jax(factor):
    A = _data(5, 8)
    want = np.asarray(jntt.extend_evaluations(fjnp.get_ctx(FR), jnp.asarray(A),
                                              factor))
    got = tntt.extend_evaluations(ftorch.get_ctx(FR), ftorch.to_tensor(A, "cpu"),
                                  factor)
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)


@pytest.mark.parametrize("fn", ["ntt_union", "intt_union"])
def test_union_transforms_match_jax(fn):
    A = _data(5, 9)
    fp = fjnp.get_ctx(FR).fp
    kw = dict(s_log=4, shift=fp.shift)
    want = np.asarray(getattr(jntt, fn)(fjnp.get_ctx(FR), jnp.asarray(A), **kw))
    got = getattr(tntt, fn)(ftorch.get_ctx(FR), ftorch.to_tensor(A, "cpu"), **kw)
    np.testing.assert_array_equal(ftorch.to_numpy(got), want)
    back = tntt.intt_union(ftorch.get_ctx(FR), tntt.ntt_union(
        ftorch.get_ctx(FR), ftorch.to_tensor(A, "cpu"), **kw), **kw)
    np.testing.assert_array_equal(ftorch.to_numpy(back), A)
