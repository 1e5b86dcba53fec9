"""snarkjs_tpu_torch.api (and the package's lazy namespaces) against the
JAX package on the CPU.  The full proves run the circuit's .wasm
(tests/_wasm_chain.py) with fixed blinders and must equal the JAX proofs
stored in snarkjs_tpu_torch/fixtures/ (*_proof.json, made from the same
witness); the cheap calls are compared with snarkjs_tpu.api live.
Tolerance: none; proof JSON, bytes and dicts exactly.
"""

import json
import os

import pytest

import snarkjs_tpu_torch
from snarkjs_tpu import api as japi
from snarkjs_tpu_torch import api as tapi
from snarkjs_tpu_torch.curves import host_curve as thc
from snarkjs_tpu_torch.formats import wtns as twtns
from tests import _wasm_chain
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
NAMESPACES = ("groth16", "plonk", "fflonk", "powersOfTau", "powers_of_tau", "zKey",
              "zkey", "wtns", "r1cs")


def _fixture(name):
    return os.path.join(FIXTURES, name)


def _chain(tmp_path, stem, curve):
    """The chain's .wasm and input.json with as many constraints as the
    stored witness `stem`.wtns has."""
    nc = twtns.read_wtns(_fixture(f"{stem}.wtns")).n - 2
    p = thc.get_curve(curve).fr.p
    return _wasm_chain.write_chain(str(tmp_path / stem), p, nc)


@pytest.mark.parametrize("proto,stem,curve,blinders,vm", [
    ("groth16", "tiny_bn128", "bn128", ("r", "s"), "native"),
    ("groth16", "tiny_bn128", "bn128", ("r", "s"), "python"),
    ("plonk", "tiny_plonk_bn128", "bn128", ("b",), "native"),
    ("plonk", "tiny_plonk_bls12381", "bls12381", ("b",), "native"),
    ("fflonk", "tiny_fflonk_bn128", "bn128", ("b",), "native"),
])
def test_full_prove_equals_stored_jax_proof(tmp_path, proto, stem, curve, blinders, vm):
    files = _chain(tmp_path, stem, curve)
    with open(_fixture(f"{stem}_proof.json")) as f:
        stored = json.load(f)
    kw = {k: stored[k] for k in blinders}
    ns = getattr(snarkjs_tpu_torch, proto)
    fn = ns.fullProve if vm == "python" else ns.full_prove   # the alias too
    proof, publics = fn(files["input.json"], files["chain.wasm"], _fixture(f"{stem}.zkey"),
                        device="cpu", vm=vm, **kw)
    assert json.dumps(proof) == json.dumps(stored["proof"])
    assert publics == stored["publicSignals"]
    vk = tapi.zKey.export_verification_key(_fixture(f"{stem}.zkey"))
    assert vk == japi.zKey.export_verification_key(_fixture(f"{stem}.zkey"))
    assert ns.verify(vk, publics, proof)
    assert ns.exportSolidityCallData(proof, publics) == getattr(
        japi, proto).export_solidity_call_data(proof, publics)


def test_namespaces_and_camel_case_aliases():
    """Every operation of every JAX namespace exists in the port under the
    same name, and its camelCase spelling resolves to it."""
    for ns in NAMESPACES:
        j, t = getattr(japi, ns), getattr(snarkjs_tpu_torch, ns)
        assert t is getattr(tapi, ns)
        names = [n for n in dir(type(j)) if not n.startswith("_")]
        assert names and names == [n for n in dir(type(t)) if not n.startswith("_")]
        for n in names:
            camel = n.split("_")[0] + "".join(w[0].upper() + w[1:] for w in n.split("_")[1:])
            assert getattr(t, camel) == getattr(t, n), (ns, camel)
    assert snarkjs_tpu_torch.zKey.exportVerificationKey == tapi._Zkey.export_verification_key
    assert snarkjs_tpu_torch.powersOfTau.preparePhase2 == tapi._PowersOfTau.prepare_phase2
    with pytest.raises(AttributeError):
        snarkjs_tpu_torch.groth16.noSuchCall
    with pytest.raises(AttributeError):
        snarkjs_tpu_torch.noSuchNamespace


def test_wtns_and_r1cs_namespaces_equal_jax(tmp_path):
    files = _wasm_chain.write_chain(str(tmp_path), thc.BN254.fr.p, 40)
    data = tapi.wtns.calculate(files["input.json"], files["chain.wasm"],
                               str(tmp_path / "w.wtns"))
    assert data == japi.wtns.calculate(files["input.json"], files["chain.wasm"])
    assert tapi.wtns.calculate(files["input.json"], files["chain.wasm"], vm="python") == data
    assert tapi.wtns.exportJson(data) == japi.wtns.export_json(data)
    assert tapi.wtns.check(files["chain.r1cs"], data, device="cpu")
    assert tapi.wtns.debug(files["input.json"], files["chain.wasm"],
                           sym=files["chain.sym"]) == data
    assert tapi.r1cs.info(files["chain.r1cs"]) == japi.r1cs.info(files["chain.r1cs"])
    assert tapi.r1cs.exportJson(files["chain.r1cs"]) == japi.r1cs.export_json(
        files["chain.r1cs"])
    assert tapi.r1cs.printConstraints(files["chain.r1cs"], files["chain.sym"]) == \
        japi.r1cs.print_constraints(files["chain.r1cs"], files["chain.sym"])


def test_setup_namespaces_equal_stored_keys():
    """zKey.newZkey and fflonk.setup through the API give the stored JAX
    keys of the all-1 chains."""
    p = thc.BN254.fr.p
    r3 = _wasm_chain.chain_r1cs(p, 3, ones=True)
    with open(_fixture("tiny3_bn128_from_ptau.zkey"), "rb") as f:
        assert tapi.zKey.newZkey(r3, _fixture("tiny_p4_bn128.ptau"), device="cpu") == f.read()
    r12 = _wasm_chain.chain_r1cs(p, 12, ones=True)
    with open(_fixture("tiny_fflonk_bn128.zkey"), "rb") as f:
        assert tapi.fflonk.setup(r12, _fixture("tiny_p7_bn128.ptau"), device="cpu") == f.read()
