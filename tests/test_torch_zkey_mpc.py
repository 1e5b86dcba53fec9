"""snarkjs_tpu_torch's phase 2 (`ceremony/zkey_mpc.py`: contribute, beacon,
the MPC params codec, verify_from_init, verify_from_r1cs) against
snarkjs_tpu on the CPU.  Tolerance: none; zkey bytes, contribution hashes,
verdicts and logger messages exactly.

Inputs are the in-repo Groth16 keys of `_tiny_circuit` made by
`setup_from_ptau` (tests/_torch_phase2.py): bn128 at domain 8 and 16,
bls12-381 at domain 8, with fixed ChaCha seeds and numpy Generators.  The
JAX package runs live.  Its `verify_from_r1cs` rebuilds the init key with
`groth16_setup.setup_from_ptau`, minutes of XLA compiles on a CPU, so here
that call returns the stored key, which the slow tests of
tests/test_torch_groth16_setup.py and tests/test_torch_bls12_381.py hold
equal to it.
"""

import functools

import numpy as np
import pytest

from snarkjs_tpu.ceremony import zkey_mpc as J
from snarkjs_tpu.curves import host_curve as jhc
from snarkjs_tpu.formats import ptau as jptau
from snarkjs_tpu.protocols import groth16_setup as jgs
from snarkjs_tpu.utils.chacha import ChaCha as JChaCha
from snarkjs_tpu_torch.ceremony import ptau_ops as TP
from snarkjs_tpu_torch.ceremony import zkey_mpc as T
from snarkjs_tpu_torch.formats import ptau as tptau
from snarkjs_tpu_torch.formats import r1cs as tr1cs
from snarkjs_tpu_torch.formats.binfile import BinFile
from snarkjs_tpu_torch.utils.chacha import ChaCha as TChaCha
from tests import _torch_phase2 as p2
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CASES = sorted(p2.CASES)
OTHER_INIT = {"bn128_d8": "bn128_d16", "bn128_d16": "bn128_d8",
              "bls12381_d8": "bn128_d8"}


@functools.lru_cache(maxsize=None)
def _inputs(case):
    zk, pt, *_ = p2.CASES[case]
    data = p2.fixture(pt)
    return p2.fixture(zk), jptau.read_ptau(data), tptau.read_ptau(data)


@functools.lru_cache(maxsize=None)
def _jax_chain(case):
    return p2.chain(J, JChaCha, _inputs(case)[0])


def _final(case) -> bytes:
    return _jax_chain(case)[-1][0]


def _scenario(case, name):
    """(init, zkey) of a verify scenario, and the verdict it must give."""
    init, final = _inputs(case)[0], _final(case)
    return {
        "valid": (init, final, True),
        "init_itself": (init, init, True),
        "l_swapped": (init, p2.swap_points(final, 8), False),
        "h_swapped": (init, p2.swap_points(final, 9), False),
        "transcript_flipped": (init, p2.edit_last_contribution(T, final, p2.flip_transcript),
                               False),
        "beacon_key_mismatch": (init, p2.edit_last_contribution(T, final,
                                                                p2.flip_beacon_hash), False),
        "other_circuit": (_inputs(OTHER_INIT[case])[0], final, False),
    }[name]


def _verify_both(case, init, zkey, **kw):
    """(verdict, logger lines) of the JAX package and of the port."""
    _, jpt, tpt = _inputs(case)
    jl, tl = p2.Log(), p2.Log()
    jv = J.verify_from_init(init, jpt, zkey, logger=jl,
                            rng=np.random.default_rng(p2.VERIFY_SEED))
    tv = T.verify_from_init(init, tpt, zkey, logger=tl,
                            rng=np.random.default_rng(p2.VERIFY_SEED), device="cpu", **kw)
    return (jv, jl.lines), (tv, tl.lines)


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("case", CASES)
def test_contribute_and_beacon_equal_jax(case):
    got = p2.chain(T, TChaCha, _inputs(case)[0], device="cpu")
    assert got == _jax_chain(case)


@pytest.mark.parametrize("case", ["bn128_d8", "bls12381_d8"])
def test_contribute_and_beacon_device_route_equal_jax(case, monkeypatch):
    """With the host cutovers at 0, sections 8 and 9 go through one batched
    double-and-add a contribution, as on the card."""
    p2.force_device_route(monkeypatch, TP)
    calls = []
    apply_keys = TP._apply_keys
    monkeypatch.setattr(TP, "_apply_keys",
                        lambda cv, g2, parts, dev: calls.append(len(parts))
                        or apply_keys(cv, g2, parts, dev))
    got = p2.chain(T, TChaCha, _inputs(case)[0], device="cpu")
    assert got == _jax_chain(case)
    assert calls == [2, 2]


@pytest.mark.parametrize("case", CASES)
def test_mpc_params_round_trip(case):
    """Section 10 of the final key reads and writes back to the same bytes,
    and reads as the JAX package reads it."""
    final = _final(case)
    sec10 = BinFile(final, "zkey").read_section(10)
    cv = T._parse(final)[1]
    mp = T.read_mpc_params(cv, sec10)
    assert T.write_mpc_params(cv, mp) == sec10
    jmp = J.read_mpc_params(J._parse(final)[1], sec10)
    assert [vars(c) for c in mp.contributions] == [vars(c) for c in jmp.contributions]
    assert mp.cs_hash == jmp.cs_hash
    assert [c.type for c in mp.contributions] == [0, 1]


SCENARIOS = ["valid", "init_itself", "l_swapped", "h_swapped", "transcript_flipped",
             "beacon_key_mismatch", "other_circuit"]


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("case", CASES)
def test_verify_from_init_equals_jax(case, scenario):
    init, zkey, want = _scenario(case, scenario)
    jax_side, port = _verify_both(case, init, zkey)
    assert port == jax_side
    assert port[0] is want
    assert bool(port[1]) is not want


@pytest.mark.parametrize("scenario", ["valid", "h_swapped"])
def test_verify_from_init_device_route_equals_jax(scenario, monkeypatch):
    """Every MSM through `MSMContext.run` (K-scan's plain version here) and
    the H check's differences through the batched Jacobian add."""
    p2.force_device_route(monkeypatch, TP)
    msms = []
    msm = TP._msm_lem
    monkeypatch.setattr(TP, "_msm_lem", lambda cv, lem, sc, g2, dev: msms.append(
        sc.shape[-1]) or msm(cv, lem, sc, g2, dev))
    init, zkey, want = _scenario("bn128_d8", scenario)
    jax_side, port = _verify_both("bn128_d8", init, zkey)
    assert port == jax_side and port[0] is want
    assert msms == [3, 3, 8, 8]


def _stored_setup(r1cs, pt):
    """The JAX package's `groth16_setup.setup_from_ptau` of a circuit from
    its curve's power-4 .ptau: the stored key of that circuit."""
    for zk, _, curve, nc in p2.CASES.values():
        if r1cs.n_constraints == nc and r1cs.prime == jhc.get_curve(curve).fr.p:
            return p2.fixture(zk)
    raise KeyError(r1cs.n_constraints)


@pytest.mark.parametrize("case,circuit", [("bn128_d8", "own"), ("bn128_d8", "other"),
                                          ("bls12381_d8", "own")])
def test_verify_from_r1cs_equals_jax(case, circuit, monkeypatch):
    """From the circuit itself (True), and on bn128 from a circuit of
    another domain made from the same .ptau (False)."""
    _, _, curve, nc = p2.CASES[case]
    if circuit == "other":
        nc = p2.CASES["bn128_d16"][3]
    _, r1cs, _ = p2.graft()._tiny_circuit(nc, curve)
    monkeypatch.setattr(jgs, "setup_from_ptau", _stored_setup)
    _, jpt, tpt = _inputs(case)
    jl, tl = p2.Log(), p2.Log()
    jv = J.verify_from_r1cs(r1cs, jpt, _final(case), logger=jl,
                            rng=np.random.default_rng(p2.VERIFY_SEED))
    tv = T.verify_from_r1cs(tr1cs.R1cs(**{k: getattr(r1cs, k)
                                           for k in r1cs.__dataclass_fields__}),
                            tpt, _final(case), logger=tl,
                            rng=np.random.default_rng(p2.VERIFY_SEED), device="cpu")
    assert (tv, tl.lines) == (jv, jl.lines)
    assert tv is (circuit == "own")
