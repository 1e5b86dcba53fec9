"""The plain Groth16 reference against the port's prover, and its parts
against Python integers."""

import random

import numpy as np
import pytest
import torch

from benchmark.families import groth16_chain
from benchmark.harness import spec, traffic
from benchmark.reference import groth16 as ref
from benchmark.reference.curve import CURVES, Group
from benchmark.reference.field import Field
from benchmark.reference.ntt import ntt
from benchmark.tests.conftest import ROOT

MIX = {"callers": 1, "pool": 2, "warmup": 0, "constraints": 1000, "public_inputs": 1}


def _config(curve):
    return spec.config(ROOT, f"groth16_{curve}")[1]


@pytest.mark.parametrize("curve", ["bn128", "bls12381"])
def test_field_ops_equal_python_ints(curve):
    cv = CURVES[curve]
    rnd = random.Random(5)
    for p, nbytes in ((cv.r, cv.fr_bytes), (cv.q, cv.fq_bytes)):
        F = Field(p, nbytes)
        xs = [0, 1, p - 1] + [rnd.randrange(p) for _ in range(200)]
        ys = [p - 1, p - 1, 1] + [rnd.randrange(p) for _ in range(200)]
        a, b = F.from_ints(xs, "cpu"), F.from_ints(ys, "cpu")
        rinv = pow(F.R, -1, p)
        assert F.to_ints(F.mont_mul(a, b)) == [x * y * rinv % p for x, y in zip(xs, ys)]
        assert F.to_ints(F.add(a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
        assert F.to_ints(F.sub(a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
        assert F.weighted_sums(a, 7) == (sum(xs) % p,
                                         sum(i % 7 * x for i, x in enumerate(xs)) % p)


@pytest.mark.parametrize("curve", ["bn128", "bls12381"])
def test_ntt_equals_the_dft(curve):
    F = Field(CURVES[curve].r, 32)
    rnd = random.Random(6)
    for n in (1, 2, 32):
        xs = [rnd.randrange(F.p) for _ in range(n)]
        w = F.w[n.bit_length() - 1]
        want = [sum(x * pow(w, i * j, F.p) for i, x in enumerate(xs)) % F.p for j in range(n)]
        a = F.to_mont(F.from_ints(xs, "cpu"))
        assert F.to_ints(F.from_mont(ntt(F, a))) == want
        assert F.to_ints(F.from_mont(ntt(F, ntt(F, a), inverse=True))) == xs


@pytest.mark.parametrize("curve", ["bn128", "bls12381"])
def test_scalar_mul_is_a_homomorphism(curve):
    cv = CURVES[curve]
    for ext in (1, 2):
        g = Group(cv, ext)
        assert g.on_curve(g.gen) and g.mul(g.gen, cv.r) is None
        P, Q = g.mul(g.gen, 123456789), g.mul(g.gen, cv.r - 5)
        assert g.on_curve(P) and g.add(P, Q) == g.mul(g.gen, 123456784)
        assert g.add(P, P) == g.mul(g.gen, 2 * 123456789)


def _prove_both(curve, seed, device="cpu"):
    cell = groth16_chain.Cell(_config(curve), MIX, seed, device)
    reqs = [r for _, r in zip(range(2), traffic.stream(MIX, seed))]
    got = [cell.op(r) for r in reqs]
    return cell, reqs, got


@pytest.mark.parametrize("curve", ["bn128", "bls12381"])
def test_reference_equals_the_port_and_a_tampered_witness_differs(curve):
    """A chain of 1,000 constraints (domain 2^10): the port's proof on the
    CPU, through its plain versions, equals the reference's; with one
    witness value changed the reference gives another proof."""
    cell, reqs, got = _prove_both(curve, 2**33 + 11)
    wants = cell.reference(reqs)
    assert [cell.wrong(g, w) for g, w in zip(got, wants)] == [0, 0]
    cell.wit_limbs[reqs[0].item] = cell.wit_limbs[reqs[0].item].copy()
    cell.wit_limbs[reqs[0].item][0, 500] ^= 1
    cell.terms = {}
    assert cell.wrong(got[0], cell.reference(reqs[:1])[0]) == 3   # pi_a, pi_b, pi_c


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["bn128", "bls12381"])
def test_reference_on_card_equals_the_port_on_card(curve):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell, reqs, got = _prove_both(curve, 2**35 + 3, "cuda")
    assert [cell.wrong(g, w) for g, w in zip(got, cell.reference(reqs))] == [0, 0]


def test_key_holds_the_chain():
    """Every constraint of the key holds for every witness of the pool."""
    mix = dict(MIX, constraints=50)
    cell = groth16_chain.Cell(_config("bn128"), mix, 9, "cpu")
    p = CURVES["bn128"].r
    k = cell.key
    for limbs in cell.wit_limbs:
        w = [sum(int(v) << (16 * j) for j, v in enumerate(col)) for col in limbs.T]
        rows = {}
        for m, c, s in zip(k.m, k.c, k.s):
            rows.setdefault((int(m), int(c)), []).append(w[s])
        for c in range(mix["constraints"]):
            assert rows[(0, c)][0] * rows[(1, c)][0] % p == w[c + 2]
    assert np.all(k.val == k.val[:, :1])
