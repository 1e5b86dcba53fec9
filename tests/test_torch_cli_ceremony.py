"""The powers-of-tau commands of snarkjs_tpu_torch.cli against the JAX CLI's
stored outputs (fixtures/cli_jax.json) on the CPU (`--device=cpu`): new,
contribute, export challenge, challenge contribute, import response,
beacon, prepare phase2, convert, truncate, verify and export json at power
4 on bn128, the contributions fixed by their entropy (tests/_torch_cli.py).
Tolerance: none; file bytes (SHA-256), exit codes, standard output and
logger lines exactly.
"""

import pytest

from snarkjs_tpu_torch import cli as tcli
from tests import _torch_cli as tc
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

STEPS = [s for s in tc.STEPS if s[0].startswith("ptau ")]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return tc.session(tcli.main, "snarkjs_tpu_torch", str(tmp_path_factory.mktemp("port")),
                      STEPS, ("--device=cpu",))


@pytest.mark.parametrize("key", [k for k, _, _ in STEPS])
def test_ceremony_step_equals_stored_jax(port, key):
    want = tc.stored()[key]
    got = port[key]
    assert (got["rc"], got["stdout"], got["log"], got["files"]) == (
        want["rc"], want["stdout"], want["log"], want["files"])


def test_ceremony_says_what_it_must(port):
    assert port["ptau verify"]["stdout"] == "Powers of Tau Ok!\n"
    assert port["ptau contribute"]["stdout"].startswith("Contribution Response Hash:")
    assert len(port["ptau truncate"]["files"]) == 3
