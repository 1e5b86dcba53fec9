"""snarkjs_tpu_torch Groth16 against snarkjs_tpu and the host-bigint prover.

The same tiny keys (JAX `setup_from_secrets`, carried over by `convert`) and
witnesses go through both packages on the CPU; proofs must be byte-equal.
Also checks the port's zkey reader and the stored chip-smoke fixture.

`python -m tests.test_torch_groth16` rewrites snarkjs_tpu_torch/fixtures/.
"""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest

from snarkjs_tpu.formats import wtns as jwtns
from snarkjs_tpu.formats import zkey as jzkey
from snarkjs_tpu.protocols import groth16 as jg
from snarkjs_tpu.protocols import groth16_setup
from snarkjs_tpu_torch import convert
from snarkjs_tpu_torch.formats import zkey as tzkey
from snarkjs_tpu_torch.protocols import groth16 as tg
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
R, S = 0x1111, 0x2222


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(ROOT, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    return g


@functools.lru_cache(maxsize=None)
def _tiny(curve, nc):
    g = _graft()
    cv, r1cs, wit = g._tiny_circuit(nc, curve)
    zk = groth16_setup.setup_from_secrets(
        r1cs, tau=0xABCDE, alpha=5, beta=7, gamma=1, delta=11)
    return g, cv, zk, wit


@functools.lru_cache(maxsize=None)
def _jax_proof(curve, nc):
    _, _, zk, wit = _tiny(curve, nc)
    return jg.prove(zk, wit, r=R, s=S)


def fixture_files() -> dict:
    """The chip-smoke fixture as the JAX package makes it: name -> bytes."""
    _, cv, zk, wit = _tiny("bn128", 40)
    proof, publics = _jax_proof("bn128", 40)
    return {
        "tiny_bn128.zkey": groth16_setup.write_groth16_zkey(zk),
        "tiny_bn128.wtns": jwtns.write_wtns(cv.fr, np.asarray(wit.values)),
        "tiny_bn128_proof.json": (json.dumps(
            {"r": R, "s": S, "proof": proof, "publicSignals": publics},
            indent=1) + "\n").encode(),
    }


@pytest.mark.parametrize("curve,nc", [("bn128", 40), ("bls12381", 10)])
def test_proof_bytes_equal_jax_and_host(curve, nc):
    g, cv, zk, wit = _tiny(curve, nc)
    got = tg.prove(convert.zkey_from_numpy(zk), convert.witness_from_numpy(wit),
                   r=R, s=S, device="cpu")
    assert json.dumps(got) == json.dumps(_jax_proof(curve, nc))
    assert json.dumps(got) == json.dumps(g._host_prove(zk, wit, R, S))
    proof, publics = got
    tampered = [str(int(publics[0]) + 1)] + publics[1:]
    vk_t = tg.export_verification_key(convert.zkey_from_numpy(zk))
    vk_j = jg.export_verification_key(zk)
    assert json.dumps(vk_t) == json.dumps(vk_j)
    for verify, vk in ((tg.verify, vk_t), (jg.verify, vk_j)):
        assert verify(vk, publics, proof)
        assert not verify(vk, tampered, proof)


def test_zkey_reader_matches_jax():
    _, _, zk, _ = _tiny("bn128", 40)
    data = groth16_setup.write_groth16_zkey(zk)
    a, b = jzkey.read_groth16_zkey(data), tzkey.read_groth16_zkey(data)
    for name in ("n8q", "n8r", "n_vars", "n_public", "domain_size", "power",
                 "vk_alpha_1", "vk_beta_1", "vk_beta_2", "vk_gamma_2",
                 "vk_delta_1", "vk_delta_2", "ic"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.curve.name == b.curve.name
    for k in ("m", "c", "s", "val"):
        np.testing.assert_array_equal(a.coeffs[k], b.coeffs[k])
    for name in ("a_points", "b1_points", "b2_points", "c_points", "h_points"):
        fa = [np.asarray(x) for x in _leaves(getattr(a, name))]
        fb = [np.asarray(x) for x in _leaves(getattr(b, name))]
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)


def _leaves(t):
    if isinstance(t, tuple):
        return [y for x in t for y in _leaves(x)]
    return [t]


def test_fixture_files_regenerate():
    for name, data in fixture_files().items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name


def test_prove_files_on_fixture():
    proof = tg.prove_files(os.path.join(FIXTURES, "tiny_bn128.zkey"),
                           os.path.join(FIXTURES, "tiny_bn128.wtns"),
                           r=R, s=S, device="cpu")
    with open(os.path.join(FIXTURES, "tiny_bn128_proof.json")) as f:
        want = json.load(f)
    assert json.dumps(proof) == json.dumps((want["proof"], want["publicSignals"]))


if __name__ == "__main__":
    os.makedirs(FIXTURES, exist_ok=True)
    for name, data in fixture_files().items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        print(name, len(data))
