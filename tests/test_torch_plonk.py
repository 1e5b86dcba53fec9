"""snarkjs_tpu_torch PLONK (setup, prove, verify, codecs) against snarkjs_tpu.

The tiny squaring-chain circuit (`__graft_entry__._tiny_circuit(40)`, bn128,
domain 64, one public input) is set up from tau = 0xDEADBEEF12345 and proved
with the blinders b = 1..12 by both packages on the CPU.  Equality is byte
for byte (zkey bytes, proof JSON) and field by field (parsed key).  The JAX
setup and prove run once, in a module-scoped fixture.

`JAX_PLATFORMS=cpu python -m tests.test_torch_plonk` rewrites the stored
fixture snarkjs_tpu_torch/fixtures/tiny_plonk_bn128{.zkey,.wtns,_proof.json}
from the JAX package (`plonk_setup.setup_from_secrets`, `write_wtns`,
`plonk.prove`).
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from snarkjs_tpu.formats import wtns as jwtns
from snarkjs_tpu.formats import zkey as jzkey
from snarkjs_tpu.protocols import plonk as jp
from snarkjs_tpu.protocols import plonk_setup as jsetup
from snarkjs_tpu.utils import keccak as jkeccak
from snarkjs_tpu_torch import convert
from snarkjs_tpu_torch.curves import host_curve as thc
from snarkjs_tpu_torch.formats import r1cs as tr1cs
from snarkjs_tpu_torch.formats import zkey as tzkey
from snarkjs_tpu_torch.protocols import groth16_setup as tg16setup
from snarkjs_tpu_torch.protocols import plonk as tp
from snarkjs_tpu_torch.protocols import plonk_setup as tsetup
from snarkjs_tpu_torch.utils import keccak as tkeccak
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
TAU = 0xDEADBEEF12345
B = list(range(1, 13))


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(ROOT, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    return g


def _jax_side():
    """Circuit, witness, zkey bytes, parsed key and proof from the JAX package."""
    cv, r1cs, wit = _graft()._tiny_circuit(40, "bn128")
    zbytes = jsetup.setup_from_secrets(r1cs, TAU)
    zk = jzkey.read_plonk_zkey(zbytes)
    proof, publics = jp.prove(zk, wit, b=B)
    return {"cv": cv, "r1cs": r1cs, "wit": wit, "zbytes": zbytes, "zk": zk,
            "proof": proof, "publics": publics}


@pytest.fixture(scope="module")
def jax_side():
    return _jax_side()


@pytest.fixture(scope="module")
def torch_proof(jax_side):
    zk = convert.plonk_zkey_from_numpy(jax_side["zk"])
    return tp.prove(zk, convert.witness_from_numpy(jax_side["wit"]), b=B,
                    device="cpu")


def fixture_files(js) -> dict:
    return {
        "tiny_plonk_bn128.zkey": js["zbytes"],
        "tiny_plonk_bn128.wtns": jwtns.write_wtns(js["cv"].fr,
                                                  np.asarray(js["wit"].values)),
        "tiny_plonk_bn128_proof.json": (json.dumps(
            {"b": B, "proof": js["proof"], "publicSignals": js["publics"]},
            indent=1) + "\n").encode(),
    }


def _torch_r1cs(r1cs):
    return tr1cs.R1cs(**{k: getattr(r1cs, k) for k in r1cs.__dataclass_fields__})


# ------------------------------------------------------------------ keccak

@pytest.mark.parametrize("msg,digest", [
    (b"", "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"),
    (b"abc", "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"),
])
def test_keccak_known_vectors(msg, digest):
    assert tkeccak.keccak256(msg).hex() == digest


@pytest.mark.parametrize("n", [1, 135, 136, 137, 500])
def test_keccak_matches_jax_copy(n):
    msg = np.random.default_rng(n).bytes(n)
    assert tkeccak.keccak256(msg) == jkeccak.keccak256(msg)


# ------------------------------------------------------------------- setup

def test_setup_bytes_equal_jax(jax_side):
    got = tsetup.setup_from_secrets(_torch_r1cs(jax_side["r1cs"]), TAU,
                                    device="cpu")
    assert got == jax_side["zbytes"]
    assert tzkey.zkey_protocol(got) == jzkey.zkey_protocol(got) == "plonk"


def test_process_constraints_matches_jax(jax_side):
    fr = jax_side["cv"].fr
    want = jsetup.process_constraints(fr, jax_side["r1cs"])
    got = tsetup.process_constraints(thc.get_curve("bn128").fr,
                                     _torch_r1cs(jax_side["r1cs"]))
    assert got == want


def test_setup_files_draws_tau_when_none(tmp_path, monkeypatch):
    """`setup_files` with no tau draws one (31 random bytes, as the JAX
    function does), passes it to `setup_from_secrets` and writes its bytes;
    a given tau is passed as it is."""
    from snarkjs_tpu_torch.formats import r1cs as r1cs_mod

    taus = []
    monkeypatch.setattr(r1cs_mod, "read_r1cs", lambda path: path)
    monkeypatch.setattr(tsetup, "setup_from_secrets",
                        lambda r1cs, tau, device=None: taus.append(tau) or b"zkey")
    out = tmp_path / "c.zkey"
    assert tsetup.setup_files("c.r1cs", str(out)) == out.read_bytes() == b"zkey"
    tsetup.setup_files("c.r1cs", str(out))
    tsetup.setup_files("c.r1cs", str(out), TAU)
    assert 0 < taus[0] < 1 << 248 and taus[0] != taus[1] and taus[2] == TAU


def test_check_witness_matches_jax(jax_side):
    from snarkjs_tpu.formats import r1cs as jr1cs

    fr = jax_side["cv"].fr
    vals = np.asarray(jax_side["wit"].values)
    bad = vals.copy()
    bad[0, 5] ^= 1
    for w, ok in ((vals, True), (bad, False)):
        assert jr1cs.check_witness(jax_side["r1cs"], w, fr) is ok
        assert tr1cs.check_witness(_torch_r1cs(jax_side["r1cs"]), w,
                                   thc.get_curve("bn128").fr) is ok


def test_setup_from_ptau_bytes_equal_jax():
    """PLONK `setup_from_ptau` of `_tiny_circuit(3)` (domain 8) from the stored
    power-4 .ptau of tests/test_torch_groth16_setup.py, against the JAX
    package's on the same bytes."""
    from snarkjs_tpu.formats import ptau as jptau
    from snarkjs_tpu_torch.formats import ptau as tptau

    _, r1cs, _ = _graft()._tiny_circuit(3, "bn128")
    with open(os.path.join(FIXTURES, "tiny_p4_bn128.ptau"), "rb") as f:
        data = f.read()
    want = jsetup.setup_from_ptau(r1cs, jptau.read_ptau(data))
    got = tsetup.setup_from_ptau(_torch_r1cs(r1cs), tptau.read_ptau(data), device="cpu")
    assert got == want


def test_points_from_scalars_device_route_matches_jax(jax_side):
    """513 scalars: both packages take their batched double-and-add; the
    (x, y, inf) limb arrays agree exactly (infinity as x = y = 0).  Scalars
    below 2^16, with 0 and 1."""
    from snarkjs_tpu.protocols import groth16_setup as jg16setup

    cvj, cvt = jax_side["cv"], thc.get_curve("bn128")
    ks = [0, 1] + [int(k) for k in np.random.default_rng(6).integers(2, 1 << 16, 511)]
    want = jg16setup._points_from_scalars(cvj, ks)
    got = tg16setup._points_from_scalars(cvt, ks, device="cpu")
    for a, b in zip(_leaves(want), _leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert got[2][0] and not got[2][1:].any()


def test_points_and_lagrange_match_jax(jax_side):
    from snarkjs_tpu.protocols import groth16_setup as jg16setup

    cvj, cvt = jax_side["cv"], thc.get_curve("bn128")
    ks = [0, 1, 2, cvj.fr.p - 1, 0xABCDEF]
    for g2 in (False, True):
        want = jg16setup._points_from_scalars(cvj, ks, g2=g2)
        got = tg16setup._points_from_scalars(cvt, ks, g2=g2)
        for a, b in zip(_leaves(want), _leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert tg16setup.lagrange_at(cvt.fr, TAU, 16) == \
        jg16setup.lagrange_at(cvj.fr, TAU, 16)


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [y for x in t for y in _leaves(x)]
    return [t]


# ------------------------------------------------------------------- codec

def test_read_plonk_zkey_field_by_field(jax_side):
    a = jax_side["zk"]
    b = tzkey.read_plonk_zkey(jax_side["zbytes"])
    assert a.curve.name == b.curve.name
    for name in ("n8q", "n8r", "n_vars", "n_public", "domain_size", "power",
                 "n_additions", "n_constraints", "k1", "k2", "qm", "ql", "qr",
                 "qo", "qc", "s1", "s2", "s3", "x_2"):
        assert getattr(a, name) == getattr(b, name), name
    for k in ("a", "b", "af", "bf"):
        np.testing.assert_array_equal(a.additions[k], b.additions[k])
    for name in ("a_map", "b_map", "c_map", "qm_p4", "ql_p4", "qr_p4", "qo_p4",
                 "qc_p4", "sigma1_p4", "sigma2_p4", "sigma3_p4", "lagrange",
                 "ptau"):
        fa, fb = _leaves(getattr(a, name)), _leaves(getattr(b, name))
        assert len(fa) == len(fb), name
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(np.asarray(x), y, err_msg=name)
    with pytest.raises(ValueError, match="not a plonk zkey"):
        with open(os.path.join(FIXTURES, "tiny_bn128.zkey"), "rb") as f:
            tzkey.read_plonk_zkey(f.read())


# ------------------------------------------------- prove and verify, whole

def test_proof_json_equal_jax(jax_side, torch_proof):
    assert json.dumps(torch_proof) == json.dumps(
        (jax_side["proof"], jax_side["publics"]))


def test_proof_equal_with_fused_ntt_route(jax_side, torch_proof, monkeypatch):
    """`torch_proof` went the default route (K-mm-norm's); the same prove with
    every stage sent through K-mm and `_normalize_cols` gives the same proof."""
    from snarkjs_tpu_torch.ntt import ntt_mm

    stage = ntt_mm._mm_stage
    routes = []

    def unfused(ctx, k, inverse, a, fused=True):
        routes.append(fused)
        return stage(ctx, k, inverse, a, fused=False)

    monkeypatch.setattr(ntt_mm, "_mm_stage", unfused)
    zk = tzkey.read_plonk_zkey(jax_side["zbytes"])
    got = tp.prove(zk, convert.witness_from_numpy(jax_side["wit"]), b=B,
                   device="cpu")
    assert json.dumps(got) == json.dumps(torch_proof)
    assert all(routes), "the prover asked for a route of its own"


def test_each_verifies_the_other_and_rejects_tampering(jax_side, torch_proof):
    proof, publics = torch_proof
    vk_t = tp.export_verification_key(tzkey.read_plonk_zkey(jax_side["zbytes"]))
    vk_j = jp.export_verification_key(jax_side["zk"])
    assert json.dumps(vk_t) == json.dumps(vk_j)
    tampered = [str(int(publics[0]) + 1)] + publics[1:]
    bad_proof = dict(proof, eval_a=str(int(proof["eval_a"]) + 1))
    assert tp.verify(vk_t, jax_side["publics"], jax_side["proof"])
    assert jp.verify(vk_j, publics, proof)
    for verify, vk in ((tp.verify, vk_t), (jp.verify, vk_j)):
        assert not verify(vk, tampered, proof)
        assert not verify(vk, publics, bad_proof)


def test_blinders_drawn_when_not_given(jax_side):
    zk = tzkey.read_plonk_zkey(jax_side["zbytes"])
    proof, publics = tp.prove(zk, convert.witness_from_numpy(jax_side["wit"]),
                              device="cpu")
    assert proof["A"] != jax_side["proof"]["A"]
    assert jp.verify(jp.export_verification_key(jax_side["zk"]), publics, proof)


def test_prove_rejects_wrong_witness(jax_side):
    zk = tzkey.read_plonk_zkey(jax_side["zbytes"])
    wit = convert.witness_from_numpy(jax_side["wit"])
    vals = wit.values.copy()
    vals[0, 7] ^= 1
    bad = type(wit)(n8=wit.n8, q=wit.q, n=wit.n, values=vals)
    with pytest.raises(RuntimeError, match="Copy constraints|not divisible"):
        tp.prove(zk, bad, b=B, device="cpu")
    short = type(wit)(n8=wit.n8, q=wit.q, n=wit.n - 1, values=vals[:, :-1])
    with pytest.raises(ValueError, match="invalid witness length"):
        tp.prove(zk, short, b=B, device="cpu")


def test_solidity_calldata_equal_jax(jax_side, torch_proof):
    assert tp.export_solidity_calldata(*torch_proof) == \
        jp.export_solidity_calldata(jax_side["proof"], jax_side["publics"])


# ---------------------------------------------------------- stored fixture

def test_fixture_files_regenerate(jax_side):
    for name, data in fixture_files(jax_side).items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name


def test_prove_files_on_fixture():
    with open(os.path.join(FIXTURES, "tiny_plonk_bn128_proof.json")) as f:
        want = json.load(f)
    got = tp.prove_files(os.path.join(FIXTURES, "tiny_plonk_bn128.zkey"),
                         os.path.join(FIXTURES, "tiny_plonk_bn128.wtns"),
                         b=want["b"], device="cpu")
    assert json.dumps(got) == json.dumps((want["proof"], want["publicSignals"]))


if __name__ == "__main__":
    os.makedirs(FIXTURES, exist_ok=True)
    for name, data in fixture_files(_jax_side()).items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        print(name, len(data))
