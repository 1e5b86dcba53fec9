"""snarkjs_tpu_torch witness calculation against snarkjs_tpu on the CPU.

The circuit is tests/_wasm_chain.py's squaring chain (a circom-2 .wasm whose
Montgomery arithmetic runs in WASM).  Four VMs run it: the JAX package's
Python interpreter (its `SNARKJS_NO_NATIVE_WASM` switch) and native VM, and
the port's `vm="python"` and `vm="native"`.  Tolerance: none; .wtns bytes
and trap messages exactly.
"""

import importlib.util
import os

import numpy as np
import pytest

from snarkjs_tpu.formats import r1cs as jr1cs
from snarkjs_tpu.formats import wtns as jwtns
from snarkjs_tpu.wasm import interp as jinterp
from snarkjs_tpu.wasm import witness_calculator as jwc
from snarkjs_tpu_torch import _build
from snarkjs_tpu_torch.curves import host_curve as thc
from snarkjs_tpu_torch.fields import ftorch
from snarkjs_tpu_torch.formats import r1cs as tr1cs
from snarkjs_tpu_torch.wasm import interp as tinterp
from snarkjs_tpu_torch.wasm import native as tnative
from snarkjs_tpu_torch.wasm import witness_calculator as twc
from tests import _torch_inputs as inputs
from tests import _wasm_chain
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = {"bn128": 40, "bls12381": 10}


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(ROOT, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    return g


def _four_vms(monkeypatch, wasm, run):
    """run(calculator) through the four VMs: name -> result or exception."""
    out = {}

    def attempt(name, make):
        try:
            out[name] = run(make())
        except Exception as e:  # the message is what is compared
            out[name] = e

    with monkeypatch.context() as m:
        m.setenv("SNARKJS_NO_NATIVE_WASM", "1")
        attempt("jax python", lambda: jwc.WitnessCalculator(wasm))
    attempt("jax native", lambda: jwc.WitnessCalculator(wasm))
    attempt("port python", lambda: twc.WitnessCalculator(wasm, vm="python"))
    attempt("port native", lambda: twc.WitnessCalculator(wasm))
    return out


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_four_vms_give_the_tiny_circuit_wtns(monkeypatch, curve):
    g = _graft()
    cv, _, wit = g._tiny_circuit(CURVES[curve], curve)
    wasm = _wasm_chain.chain_wasm(cv.fr.p, CURVES[curve])
    got = _four_vms(monkeypatch, wasm,
                    lambda c: (type(c.inst).__name__, c.calculate_wtns_bin({"x": _wasm_chain.X})))
    assert [got[k][0] for k in sorted(got)] == ["NativeInstance", "Instance"] * 2
    want = jwtns.write_wtns(cv.fr, np.asarray(wit.values))
    assert {k: v[1] for k, v in got.items()} == dict.fromkeys(got, want)
    assert twc.calculate_wtns({"x": str(_wasm_chain.X)}, wasm, vm="python") == want


@pytest.mark.parametrize("case", ["unknown signal", "assert", "assert off"])
def test_trap_messages_equal_in_both_packages_and_vms(monkeypatch, case):
    """An unknown input hash (ValueError), the chain's assert with the
    sanity check on (Trap, with the message the circuit printed), and the
    same input with the check off (no trap; every square 0)."""
    wasm = _wasm_chain.chain_wasm(thc.BN254.fr.p, 5)
    inputs = {"y": 5} if case == "unknown signal" else {"x": 0}
    sanity = case == "assert"
    got = _four_vms(monkeypatch, wasm, lambda c: c.calculate_witness(inputs, sanity))
    if case == "assert off":
        assert list(got.values()) == [[1] + [0] * 6] * 4
        return
    kinds = {k: type(v).__name__ for k, v in got.items()}
    msgs = {str(v) for v in got.values()}
    if case == "unknown signal":
        assert set(kinds.values()) == {"ValueError"} and msgs == {"Signal y not found"}
    else:
        assert all(isinstance(got[k], jinterp.Trap) for k in ("jax python", "jax native"))
        assert all(isinstance(got[k], tinterp.Trap) for k in ("port python", "port native"))
        assert msgs == {"Assert Failed. " + _wasm_chain.MESSAGE.decode() + "\n"}


def test_native_build_failure_raises_and_never_falls_back(monkeypatch, tmp_path):
    """A g++ that cannot build the VM raises: the Python VM is never taken."""
    monkeypatch.setattr(_build, "OUT", str(tmp_path))
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("--no-such-flag",))
    monkeypatch.delitem(_build._libs, "host:wasmvm", raising=False)
    monkeypatch.setattr(tinterp, "Instance",
                        lambda *a: pytest.fail("fell back to the Python VM"))
    tnative._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed for wasmvm"):
            twc.WitnessCalculator(_wasm_chain.chain_wasm(thc.BN254.fr.p, 2))
        assert not list(tmp_path.glob("*.so"))
    finally:
        tnative._lib.cache_clear()


def test_vm_is_chosen_by_argument():
    wasm = _wasm_chain.chain_wasm(thc.BN254.fr.p, 2)
    assert twc.WitnessCalculator(wasm).vm == "native"
    assert isinstance(twc.WitnessCalculator(wasm, vm="python").inst, tinterp.Instance)
    # debug-logging hooks need the Python VM
    hooked = twc.WitnessCalculator(wasm, hooks={"start": print})
    assert hooked.vm == "python" and isinstance(hooked.inst, tinterp.Instance)
    with pytest.raises(ValueError, match="unknown WASM VM"):
        twc.WitnessCalculator(wasm, vm="wasmtime")


@pytest.mark.parametrize("ones", [False, True], ids=["circom_chain", "plonk_circuit"])
def test_generated_r1cs_is_the_chip_smoke_chain(ones):
    """Both packages read the generator's .r1cs as chip_smoke's chain at
    nc = 40 (circom's coefficients, or every coefficient 1), its labels the
    wires, its .sym one line a signal wire."""
    fr = thc.BN254.fr
    want, wit = (inputs.plonk_circuit if ones else inputs.circom_chain)(fr, 40)
    data = _wasm_chain.chain_r1cs(fr.p, 40, ones)
    for read in (jr1cs.read_r1cs, tr1cs.read_r1cs):
        got = read(data)
        assert (got.n8, got.prime, got.n_wires, got.n_pub_out, got.n_pub_in, got.n_prv_in,
                got.n_labels, got.n_constraints) == (
            want.n8, want.prime, want.n_wires, want.n_pub_out, want.n_pub_in,
            want.n_prv_in, want.n_labels, want.n_constraints)
        for k in ("m", "c", "s", "vals"):
            np.testing.assert_array_equal(np.asarray(getattr(got, k)), getattr(want, k))
        np.testing.assert_array_equal(got.map, np.arange(42))
        assert tr1cs.check_witness(tr1cs.read_r1cs(data), wit.values, fr)
    sym = _wasm_chain.chain_sym(40).splitlines()
    assert len(sym) == 41 and sym[0] == "1,1,0,main.x" and sym[-1] == "41,41,0,main.y[39]"
    assert _wasm_chain.chain_witness(fr.p, 40) == ftorch.np_to_ints(fr, wit.values)
