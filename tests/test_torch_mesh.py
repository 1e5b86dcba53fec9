"""The provers', the ceremony's and the CLI's `mesh` in the port against
the stored JAX outputs, over four Gloo ranks on the CPU
(tests/_torch_dist.py: one spawn for every case of this file).

* Groth16, PLONK and FFLONK `prove(..., mesh=...)` with the stored blinders
  give the stored JAX proofs byte for byte; a Groth16 proof whose r, s are
  drawn is the same on every rank (drawn on rank 0, broadcast).
* `contribute` (bn128 power 4, the chain's seed) and `prepare_phase2` of
  the stored beacon file over the mesh give the stored JAX files.
* `groth16 prove --device=cpu --devices=4` proves over four ranks and its
  proof passes both packages' `verify`; without `--device=cpu` on a machine
  with no card it raises before any rank starts.
"""

import json
import os

import pytest
import torch

from snarkjs_tpu.protocols import groth16 as jg
from snarkjs_tpu_torch import cli as tcli
from snarkjs_tpu_torch.formats.zkey import read_groth16_zkey
from snarkjs_tpu_torch.protocols import groth16 as tg
from tests import _torch_ceremony as tc
from tests import _torch_dist as td
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

RANKS = 4
ZKEY = os.path.join(td.FIXTURES, "tiny_bn128.zkey")
WTNS = os.path.join(td.FIXTURES, "tiny_bn128.wtns")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.run_world(RANKS, td.MESH_CASES, tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("what", sorted(td.PROVERS))
def test_mesh_prove_equals_stored_jax_proof(ranks, what):
    want = td.stored_proof(what)
    for r in ranks:
        proof, publics = r["prove_case"][what]
        assert json.dumps([proof, publics]) == json.dumps([want["proof"],
                                                           want["publicSignals"]])


def test_drawn_blinders_are_the_same_on_every_rank(ranks):
    proofs = {json.dumps(r["prove_case"]["groth16_drawn"]) for r in ranks}
    assert len(proofs) == 1
    proof, publics = ranks[0]["prove_case"]["groth16_drawn"]
    assert proof != td.stored_proof("groth16")["proof"]
    assert tg.verify(tg.export_verification_key(read_groth16_zkey(ZKEY)), publics, proof)


@pytest.mark.parametrize("item", ["contributed", "prepared"])
def test_mesh_ceremony_equals_stored_jax(ranks, item):
    want = tc.stored()["bn128_p4"]["sha256"][item]
    assert all(r["ceremony_case"][item] == want for r in ranks)


def test_cli_devices_proves_over_ranks(tmp_path):
    proof_p, public_p = str(tmp_path / "proof.json"), str(tmp_path / "public.json")
    assert tcli.main(["groth16", "prove", ZKEY, WTNS, proof_p, public_p,
                      "--device=cpu", f"--devices={RANKS}"]) == 0
    with open(proof_p) as f:
        proof = json.load(f)
    with open(public_p) as f:
        publics = json.load(f)
    vk = tg.export_verification_key(read_groth16_zkey(ZKEY))
    assert tg.verify(vk, publics, proof)
    assert jg.verify(vk, publics, proof)


def test_cli_devices_without_cards_raises_before_any_rank(tmp_path, monkeypatch):
    from snarkjs_tpu_torch.parallel import distributed as pdist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(pdist, "spawn", lambda *a, **k: started.append(a))
    with pytest.raises(ValueError, match=f"--devices {RANKS}: only 0 devices visible"):
        tcli.main(["groth16", "prove", ZKEY, WTNS, str(tmp_path / "p.json"),
                   str(tmp_path / "q.json"), f"--devices={RANKS}"])
    assert not started and not os.path.exists(tmp_path / "p.json")
