"""snarkjs_tpu_torch/protocols/proof.py (the port's own copy of the typed
proof container) against snarkjs_tpu/protocols/proof.py."""

import json
import os

import pytest

from snarkjs_tpu.protocols import proof as jproof
from snarkjs_tpu_torch.protocols import proof as tproof

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "snarkjs_tpu_torch", "fixtures")


def _proof(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)["proof"]


@pytest.mark.parametrize("name", ["tiny_bn128_proof.json", "tiny_plonk_bn128_proof.json",
                                  "tiny_plonk_bls12381_proof.json",
                                  "tiny_fflonk_bn128_proof.json"])
def test_round_trip_equals_jax(name):
    obj = _proof(name)
    got = tproof.Proof.from_obj(obj)
    want = jproof.Proof.from_obj(obj)
    assert (got.protocol, got.curve, got.points, got.evaluations) == (
        want.protocol, want.curve, want.points, want.evaluations)
    assert got.to_obj() == want.to_obj()


@pytest.mark.parametrize("name", ["tiny_bn128_proof.json", "tiny_plonk_bn128_proof.json"])
def test_round_trip_gives_the_proof_back(name):
    obj = _proof(name)
    assert tproof.Proof.from_obj(obj).to_obj() == obj


def test_infinity_points_round_trip():
    p = tproof.Proof("groth16", "bn128", points={"pi_a": None, "pi_b": None, "pi_c": None})
    assert tproof.Proof.from_obj(p.to_obj()).points == p.points
    assert p.to_obj() == jproof.Proof("groth16", "bn128", points=dict(p.points)).to_obj()
