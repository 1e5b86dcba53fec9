"""Each roofline metric's work count at stated shapes, against numbers
derived here, and the bound as the larger of its two limits."""

import os

import pytest

from benchmark.harness import peaks, spec
from benchmark.tests.conftest import ROOT

QAP = spec.reader(ROOT, "qap_roofline_pct")
MSM = spec.reader(ROOT, "msm_roofline_pct")

N = 1 << 22                      # the p22 domain
N_VARS = 2_400_002               # 2,400,000 constraints + 2
COEFFS = 2 * 2_400_000 + 2       # an A and a B term a constraint, 2 public rows
NTT_PRODUCTS = 46_137_344        # 2^22 / 2 butterflies x 22 stages


def test_the_files_exist():
    for name in ("qap_roofline_pct", "msm_roofline_pct"):
        assert os.path.isfile(spec.metric_file(ROOT, name))


def test_qap_count_at_2_22():
    w = {"domain": N, "n_vars": N_VARS, "coefficients": COEFFS, "fr_bytes": 32}
    k = QAP.work(w)
    assert k["products"] == 6 * NTT_PRODUCTS + COEFFS + 3 * N + 2 * N == 302_595_586
    assert k["bytes"] == COEFFS * (32 + 12) + N_VARS * 32 + N * 32 == 422_217_880
    assert k["words"] == 8
    t, which = QAP.bound_s(w)
    assert which == "operations"
    assert t == pytest.approx(302_595_586 * 264 / (64 * 132 * 1.98e9))   # 4.776 ms


@pytest.mark.parametrize("fq_bytes,group,products,nbytes", [
    (32, 1, N_VARS * 16 * 11, N_VARS * (2 * 32 + 32) + 3 * 32),     # bn128 G1
    (32, 2, N_VARS * 16 * 29, N_VARS * (4 * 32 + 32) + 6 * 32),     # bn128 G2
    (48, 1, N_VARS * 16 * 11, N_VARS * (2 * 48 + 32) + 3 * 48),     # bls12-381 G1
    (48, 2, N_VARS * 16 * 29, N_VARS * (4 * 48 + 32) + 6 * 48),     # bls12-381 G2
])
def test_one_msm_count(fq_bytes, group, products, nbytes):
    w = {"fq_bytes": fq_bytes, "fr_bytes": 32, "scalar_bits": 254 if fq_bytes == 32 else 255,
         "msms": [{"name": "X", "points": N_VARS, "group": group}]}
    k = MSM.work(w)
    assert (k["products"], k["bytes"], k["words"]) == (products, nbytes, fq_bytes // 4)
    t, which = MSM.bound_s(w)
    assert which == "operations"
    per = 4 * (fq_bytes // 4) ** 2 + fq_bytes // 4       # 264 or 588 IMADs a product
    assert t == pytest.approx(products * per / (64 * 132 * 1.98e9))


def test_the_five_msms_at_p22():
    """About 49 ms on bn128 and 110 ms on bls12-381."""
    for fq_bytes, bits, want_ms in ((32, 254, 49.23), (48, 255, 109.64)):
        w = {"fq_bytes": fq_bytes, "fr_bytes": 32, "scalar_bits": bits,
             "msms": [{"name": n, "points": p, "group": g} for n, p, g in (
                 ("A", N_VARS, 1), ("B1", N_VARS, 1), ("B2", N_VARS, 2),
                 ("C", N_VARS - 2, 1), ("H", N, 1))]}
        assert MSM.bound_s(w)[0] * 1e3 == pytest.approx(want_ms, rel=2e-3)


def test_a_g2_mixed_addition_is_the_g1_formula_over_fq2():
    """7 multiplications at 3 Fq products and 4 squarings at 2 over Fq2;
    7 + 4 over Fq."""
    from benchmark.metrics import msm_roofline_pct

    assert msm_roofline_pct.PRODUCTS_PER_MADD == {1: 7 + 4, 2: 7 * 3 + 4 * 2}


def test_bound_takes_the_larger_limit():
    assert peaks.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert peaks.bound_s(1.0, 2 * peaks.IMAD_PER_S) == (2.0, "operations")
    w = {"fq_bytes": 32, "fr_bytes": 32, "scalar_bits": 16,
         "msms": [{"name": "X", "points": 10**9, "group": 1}]}
    k = MSM.work(w)
    assert MSM.bound_s(w)[0] == max(k["bytes"] / 3.35e12, k["products"] * 264 / peaks.IMAD_PER_S)
