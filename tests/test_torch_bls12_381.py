"""snarkjs_tpu_torch on bls12-381 against snarkjs_tpu on the CPU: PLONK
setup from a secret tau, prove and verify on `_tiny_circuit(40,
"bls12-381")`, and Groth16 `setup_from_ptau` from a prepared power-4
bls12-381 .ptau.  Tolerance: none; zkey bytes and proof JSON exactly.

The JAX package's runs compile XLA programs for minutes on a CPU, so its
outputs are stored in snarkjs_tpu_torch/fixtures/ (tiny_plonk_bls12381.*,
tiny_p4_bls12381.ptau, tiny3_bls12381_from_ptau.zkey).
`test_bls12_381_fixtures_regenerate` (marked slow) rebuilds them with the JAX
package; `python -m tests.test_torch_bls12_381` rewrites them.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from snarkjs_tpu.formats import ptau as jptau
from snarkjs_tpu.formats import wtns as jwtns
from snarkjs_tpu.formats import zkey as jzkey
from snarkjs_tpu.protocols import groth16_setup as jgs
from snarkjs_tpu.protocols import plonk as jp
from snarkjs_tpu_torch.formats import ptau as tptau
from snarkjs_tpu_torch.formats import r1cs as tr1cs
from snarkjs_tpu_torch.formats import zkey as tzkey
from snarkjs_tpu_torch.formats.binfile import BinFile
from snarkjs_tpu_torch.protocols import groth16_setup as tgs
from snarkjs_tpu_torch.protocols import plonk as tp
from snarkjs_tpu_torch.protocols import plonk_setup as tps
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_groth16_setup import ALPHA, BETA, TAU, jax_ptau_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
PLONK_TAU = 0xDEADBEEF12345
B = list(range(1, 13))
PLONK = "tiny_plonk_bls12381"
PTAU = "tiny_p4_bls12381.ptau"
PTAU_ZKEY = "tiny3_bls12381_from_ptau.zkey"


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(ROOT, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    return g


def _torch_r1cs(r1cs):
    return tr1cs.R1cs(**{k: getattr(r1cs, k) for k in r1cs.__dataclass_fields__})


def fixture_files() -> dict:
    """The JAX package's PLONK key (setup_from_secrets, PLONK_TAU), witness and
    proof (B) of `_tiny_circuit(40, "bls12-381")`; its prepared power-4 .ptau
    of (TAU, ALPHA, BETA) and Groth16 `setup_from_ptau` of `_tiny_circuit(3)`."""
    from snarkjs_tpu.protocols import plonk_setup as jps

    cv, r1cs, wit = _graft()._tiny_circuit(40, "bls12-381")
    zbytes = jps.setup_from_secrets(r1cs, PLONK_TAU)
    proof, publics = jp.prove(jzkey.read_plonk_zkey(zbytes), wit, b=B)
    ptau = jax_ptau_bytes(4, "bls12381")
    _, r1cs3, _ = _graft()._tiny_circuit(3, "bls12-381")
    return {
        PLONK + ".zkey": zbytes,
        PLONK + ".wtns": jwtns.write_wtns(cv.fr, np.asarray(wit.values)),
        PLONK + "_proof.json": (json.dumps(
            {"b": B, "proof": proof, "publicSignals": publics}, indent=1) + "\n").encode(),
        PTAU: ptau,
        PTAU_ZKEY: jgs.setup_from_ptau(r1cs3, jptau.read_ptau(ptau)),
    }


def _fixture(name) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _sections(data) -> dict:
    bf = BinFile(data, "zkey")
    return {sid: bf.read_section(sid) for sid in sorted(bf.sections)}


@pytest.fixture(scope="module")
def plonk_proof():
    return tp.prove_files(os.path.join(FIXTURES, PLONK + ".zkey"),
                          os.path.join(FIXTURES, PLONK + ".wtns"), b=B, device="cpu")


def test_plonk_setup_from_secrets_bytes_equal_jax():
    _, r1cs, _ = _graft()._tiny_circuit(40, "bls12-381")
    assert tps.setup_from_secrets(_torch_r1cs(r1cs), PLONK_TAU, device="cpu") == \
        _fixture(PLONK + ".zkey")


def test_plonk_proof_equal_jax(plonk_proof):
    want = json.loads(_fixture(PLONK + "_proof.json"))
    assert json.dumps(list(plonk_proof)) == json.dumps([want["proof"], want["publicSignals"]])


def test_plonk_each_verifies_the_other_and_rejects_tampering(plonk_proof):
    want = json.loads(_fixture(PLONK + "_proof.json"))
    data = _fixture(PLONK + ".zkey")
    vk_t = tp.export_verification_key(tzkey.read_plonk_zkey(data))
    vk_j = jp.export_verification_key(jzkey.read_plonk_zkey(data))
    assert json.dumps(vk_t) == json.dumps(vk_j)
    proof, publics = plonk_proof
    assert tp.verify(vk_t, want["publicSignals"], want["proof"])
    assert jp.verify(vk_j, publics, proof)
    tampered = [str(int(publics[0]) + 1)] + publics[1:]
    for verify, vk in ((tp.verify, vk_t), (jp.verify, vk_j)):
        assert not verify(vk, tampered, proof)


def test_groth16_setup_from_ptau_bytes_equal_jax():
    """Groth16 `setup_from_ptau` of `_tiny_circuit(3, "bls12-381")` (domain 8)
    from the stored power-4 .ptau; sections 1-9 also equal the key of
    `setup_from_secrets` with the same secrets."""
    _, r1cs, _ = _graft()._tiny_circuit(3, "bls12-381")
    tr = _torch_r1cs(r1cs)
    pt = tptau.read_ptau(_fixture(PTAU))
    assert pt.curve.name == "bls12381" and pt.power == 4
    got = tgs.setup_from_ptau(tr, pt, device="cpu")
    assert got == _fixture(PTAU_ZKEY)
    a = _sections(got)
    b = _sections(tgs.write_groth16_zkey(
        tgs.setup_from_secrets(tr, TAU, ALPHA, BETA, device="cpu")))
    for sid in range(1, 10):
        assert a[sid] == b[sid], sid


@pytest.mark.slow
def test_bls12_381_fixtures_regenerate():
    """Marked slow: the JAX PLONK setup and prove and Groth16 setup compile
    XLA programs for minutes on a CPU."""
    for name, data in fixture_files().items():
        assert _fixture(name) == data, name


if __name__ == "__main__":
    os.makedirs(FIXTURES, exist_ok=True)
    for name, data in fixture_files().items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        print(name, len(data))
