"""snarkjs_tpu_torch Groth16 against snarkjs_tpu and the host-bigint prover.

The same tiny keys (JAX `setup_from_secrets`, carried over by `convert`) and
witnesses go through both packages on the CPU; proofs must be byte-equal.
Also checks the port's zkey reader and the stored chip-smoke fixture.

`python -m tests.test_torch_groth16` rewrites snarkjs_tpu_torch/fixtures/:
the files below and the .ptau setup fixtures of tests/test_torch_groth16_setup.py
(the equal-power key too).
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
from snarkjs_tpu_torch.formats import r1cs as tr1cs
from snarkjs_tpu_torch.protocols import groth16 as tg
from snarkjs_tpu_torch.protocols import groth16_setup as tgs
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


def test_solidity_calldata_equal_jax():
    """`export_solidity_calldata` on the stored fixture proof, string for
    string against the JAX function."""
    with open(os.path.join(FIXTURES, "tiny_bn128_proof.json")) as f:
        want = json.load(f)
    got = tg.export_solidity_calldata(want["proof"], want["publicSignals"])
    assert got == jg.export_solidity_calldata(want["proof"], want["publicSignals"])
    assert got.startswith("[0x") and got.count("0x") == 2 + 4 + 2 + 1


def test_prove_logger_matches_jax():
    """`logger` gets the JAX prover's debug lines, in its order; the proof is
    the one made without a logger."""
    _, _, zk, wit = _tiny("bn128", 40)
    logged = {"jax": [], "torch": []}
    mk = lambda k: type("L", (), {"debug": lambda self, m: logged[k].append(m)})()
    jg.prove(zk, wit, r=R, s=S, logger=mk("jax"))
    got = tg.prove(convert.zkey_from_numpy(zk), convert.witness_from_numpy(wit),
                   r=R, s=S, device="cpu", logger=mk("torch"))
    assert json.dumps(got) == json.dumps(_jax_proof("bn128", 40))
    assert logged["torch"] == logged["jax"] and len(logged["jax"]) == 6


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


@pytest.mark.parametrize("curve,nc", [("bn128", 40), ("bls12381", 10)])
def test_setup_from_secrets_bytes_equal_jax(curve, nc):
    """The port's `setup_from_secrets` + `write_groth16_zkey` against the JAX
    package's on the same circuit and secrets (the key `_tiny` made)."""
    g = _graft()
    _, r1cs, _ = g._tiny_circuit(nc, curve)
    _, _, zk, _ = _tiny(curve, nc)
    tr = tr1cs.R1cs(**{k: getattr(r1cs, k) for k in r1cs.__dataclass_fields__})
    got = tgs.write_groth16_zkey(tgs.setup_from_secrets(
        tr, tau=0xABCDE, alpha=5, beta=7, gamma=1, delta=11, device="cpu"))
    assert got == groth16_setup.write_groth16_zkey(zk)


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


def _chain_witness(cv, nc, x):
    """The squaring chain's witness (`_tiny_circuit`) from the public input x."""
    from snarkjs_tpu_torch.curves import host_curve
    from snarkjs_tpu_torch.fields import ftorch
    from snarkjs_tpu_torch.formats import wtns as twtns

    fr = host_curve.get_curve(cv.name).fr
    w = [1, x]
    for _ in range(nc):
        w.append(w[-1] * w[-1] % fr.p)
    return twtns.Witness(n8=fr.n8, q=fr.p, n=nc + 2, values=ftorch.np_from_ints(fr, w))


def test_proves_on_one_key_stage_its_coefficients_once_and_equal_fresh_keys():
    """Three proves on one key object (witnesses w1, w2, w1) convert the key's
    coefficients once; each proof equals the one a fresh key object gives
    for its witness, and a second key object stages its own."""
    from snarkjs_tpu_torch import trace

    _, cv, zk, wit = _tiny("bn128", 40)
    w1, w2 = convert.witness_from_numpy(wit), _chain_witness(cv, 40, 0xC0FFEE)
    key = convert.zkey_from_numpy(zk)
    staged = lambda: trace.counters()["coef_stagings"]
    before = staged()
    got = [tg.prove(key, w, r=R, s=S, device="cpu") for w in (w1, w2, w1)]
    assert staged() - before == 1
    fresh = [tg.prove(convert.zkey_from_numpy(zk), w, r=R, s=S, device="cpu")
             for w in (w1, w2)]
    assert staged() - before == 3
    assert [json.dumps(p) for p in got] == [json.dumps(fresh[i]) for i in (0, 1, 0)]
    assert json.dumps(got[0]) == json.dumps(_jax_proof("bn128", 40))
    assert json.dumps(got[1]) != json.dumps(got[0])
    proof, publics = got[1]
    assert publics == [str(0xC0FFEE)]
    assert tg.verify(tg.export_verification_key(key), publics, proof)


def test_prove_leaves_the_key_coefficients_unchanged():
    _, _, zk, wit = _tiny("bn128", 40)
    key = convert.zkey_from_numpy(zk)
    want = {k: (v.dtype, v.copy()) for k, v in key.coeffs.items()}
    tg.prove(key, convert.witness_from_numpy(wit), r=R, s=S, device="cpu")
    assert key.coeffs.keys() == want.keys()
    for k, (dtype, v) in want.items():
        assert key.coeffs[k].dtype == dtype, k
        np.testing.assert_array_equal(key.coeffs[k], v)


if __name__ == "__main__":
    from tests.test_torch_groth16_setup import equal_power_fixture_files, setup_fixture_files

    os.makedirs(FIXTURES, exist_ok=True)
    files = {**fixture_files(), **setup_fixture_files()}
    with open(os.path.join(FIXTURES, "tiny_p4_bn128.ptau"), "wb") as f:
        f.write(files["tiny_p4_bn128.ptau"])
    files.update(equal_power_fixture_files())
    for name, data in files.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        print(name, len(data))
