"""snarkjs_tpu_torch.cli against snarkjs_tpu.cli on the CPU (`--device=cpu`).

tests/_torch_cli.py holds the session: Groth16 setup, phase 2 and proves,
PLONK and FFLONK setups and proves, the exports and the r1cs / wtns tools
on tiny chains written by tests/_wasm_chain.py (the powers-of-tau steps are
in tests/test_torch_cli_ceremony.py).  Deterministic outputs equal the JAX
CLI's: stored for the steps whose JAX side compiles XLA programs
(fixtures/cli_jax.json), live for the cheap ones.  Proofs are random, so
each package's `verify` command takes the other's proofs, and a tampered
public exits 1 in both.  Tolerance: none; file bytes (SHA-256), exit codes,
standard output and logger lines exactly.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from snarkjs_tpu import cli as jcli
from snarkjs_tpu_torch import cli as tcli
from tests import _torch_cli as tc
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ("--device=cpu",)
STEPS = [s for s in tc.STEPS if not s[0].startswith("ptau ")]
FIXED = [key for key, _, files in STEPS if files is not None]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The port's session and live steps; the JAX CLI's live steps on a copy
    of the port's directory.  (port results, JAX live results, port dir)."""
    d = str(tmp_path_factory.mktemp("port"))
    port = tc.session(tcli.main, "snarkjs_tpu_torch", d, STEPS, CPU)
    port.update(tc.live(tcli.main, "snarkjs_tpu_torch", d, CPU))
    j = str(tmp_path_factory.mktemp("jax") / "s")
    shutil.copytree(d, j)
    return port, tc.live(jcli.main, "snarkjs_tpu", j), d


@pytest.mark.parametrize("key", FIXED)
def test_step_equals_stored_jax(dirs, key):
    want = tc.stored()[key]
    got = dirs[0][key]
    assert (got["rc"], got["stdout"], got["log"], got["files"]) == (
        want["rc"], want["stdout"], want["log"], want["files"])


@pytest.mark.parametrize("key", [k for k, _, _ in tc.LIVE])
def test_live_step_equals_jax(dirs, key):
    assert dirs[0][key] == dirs[1][key]


def test_known_outputs(dirs):
    """What the steps must say, whatever both packages say: the stored
    keys, the witness check's verdicts."""
    port, _, d = dirs
    for key, fixture in (("groth16 setup", "tiny3_bn128_from_ptau.zkey"),
                         ("fflonk setup", "tiny_fflonk_bn128.zkey")):
        (fn, digest), = port[key]["files"].items()
        assert digest == tc.sha(os.path.join(tc.FIXTURES, fixture)), key
    assert port["wtns check"]["log"] == ["WITNESS IS CORRECT"]
    assert (port["wtns check flipped"]["rc"], port["wtns check flipped"]["log"]) == (
        1, ["Constraint 5 does not match"])
    for key in ("zkey verify r1cs", "zkey verify init", "zkey verify"):
        assert (port[key]["rc"], port[key]["stdout"]) == (0, "ZKey Ok!\n")


@pytest.mark.parametrize("proto", sorted(tc.VERIFY))
def test_proofs_cross_verify(dirs, proto):
    """The port's `verify` accepts the JAX CLI's proofs and the JAX `verify`
    the port's; with the first public plus one both exit 1."""
    port, _, d = dirs
    vk, keys = tc.VERIFY[proto]
    stored = tc.stored()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        for key in keys:
            proof_fn, public_fn = tc.PROVES[key]
            for src, main, name in ((stored[key]["files"], tcli.main, "snarkjs_tpu_torch"),
                                    (port[key]["files"], jcli.main, "snarkjs_tpu")):
                proof, public = src[proof_fn], src[public_fn]
                assert proof["protocol"] == proto and public == ["3735928559"]
                for pubs, rc, said in ((public, 0, "OK!\n"),
                                       ([str(int(public[0]) + 1)], 1, "INVALID proof\n")):
                    with open("x_proof.json", "w") as f:
                        json.dump(proof, f)
                    with open("x_public.json", "w") as f:
                        json.dump(pubs, f)
                    r = tc.run(main, name, [proto, "verify", vk, "x_public.json",
                                            "x_proof.json"])
                    assert (r["rc"], r["stdout"]) == (rc, said), (key, name)
    finally:
        os.chdir(cwd)


def _handler(words):
    best = None
    for cmd, fn in tcli.COMMANDS:
        w = [tcli.ALIASES.get(words[0], words[0])] + list(words[1:])
        if tuple(w[:len(cmd)]) == cmd and (best is None or len(cmd) > len(best[0])):
            best = (cmd, fn)
    return best[0]


def test_every_command_is_driven():
    """The session, the live steps and the verify calls reach all 43
    commands of the CLI, the same table as the JAX CLI's."""
    assert [c for c, _ in tcli.COMMANDS] == [c for c, _ in jcli.COMMANDS]
    assert len(tcli.COMMANDS) == 43 and tcli.ALIASES == jcli.ALIASES
    driven = {_handler(words) for _, words, _ in tc.STEPS + tc.LIVE}
    driven |= {(proto, "verify") for proto in tc.VERIFY}
    assert driven == {c for c, _ in tcli.COMMANDS}


USAGE = [
    ["powersoftau", "new"],                          # missing arguments
    ["r1cs", "info", "a.r1cs", "b", "c", "d"],       # too many
    ["groth16", "setup", "a.r1cs", "--ptau_path=x"],  # missing, with an option
    ["no", "such", "command"],
    ["zkey", "export"],                              # no complete command
    ["--help", "no", "such"],
    [],
]


@pytest.mark.parametrize("words", USAGE, ids=[" ".join(w) or "none" for w in USAGE])
def test_usage_errors_and_exit_codes_equal_jax(capsys, words):
    """Usage errors are found before the call: the same exit code and the
    same first line on stderr as the JAX CLI."""
    rc_j = jcli.main(list(words))
    err_j = capsys.readouterr().err.splitlines()[:1]
    rc_t = tcli.main(list(words) + list(CPU))
    err_t = capsys.readouterr().err.splitlines()[:1]
    assert (rc_t, err_t) == (rc_j, err_j)


def test_help_lists_the_parameters(capsys):
    assert tcli.main(["groth16", "--help"]) == 0
    out = capsys.readouterr().out
    assert out.count("snarkjs_tpu_torch groth16 ") == 4 and "device='cuda'" in out


@pytest.mark.parametrize("vm", ["python", "native"])
def test_fullprove_takes_the_vm(dirs, monkeypatch, vm):
    """`fullprove --vm=...` reaches the witness calculator, as `wtns
    calculate --vm` and the API's `vm` do; the proof verifies."""
    from snarkjs_tpu_torch.wasm import witness_calculator as wc

    port, _, d = dirs
    seen, calc = [], wc.calculate_wtns
    monkeypatch.setattr(wc, "calculate_wtns",
                        lambda inp, wasm, vm="native": seen.append(vm) or calc(inp, wasm, vm=vm))
    monkeypatch.chdir(d)
    r = tc.run(tcli.main, "snarkjs_tpu_torch",
               ["groth16", "fullprove", "c3/input.json", "c3/chain.wasm", "k3.zkey",
                f"vm_{vm}_proof.json", f"vm_{vm}_public.json", f"--vm={vm}", *CPU])
    assert r["rc"] == 0 and seen == [vm]
    r = tc.run(tcli.main, "snarkjs_tpu_torch",
               ["groth16", "verify", "g16_vk.json", f"vm_{vm}_public.json",
                f"vm_{vm}_proof.json", *CPU])
    assert (r["rc"], r["stdout"]) == (0, "OK!\n")


def test_devices_above_one_names_roadmap_a5(dirs, monkeypatch):
    """ROADMAP A5 is done: `--devices N` proves over N ranks
    (tests/test_torch_mesh.py).  On the card it needs N cards: with none
    visible it raises the JAX CLI's message before any rank starts."""
    port, _, d = dirs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="--devices 2: only 0 devices visible"):
        tcli.main(["groth16", "prove", os.path.join(d, "k3.zkey"),
                   os.path.join(d, "c3", "w.wtns"), "--devices=2"])


def test_default_device_is_the_card(dirs, monkeypatch):
    """Without --device a command that computes runs on the card, and
    raises without one; one that does not compute runs anyway."""
    port, _, d = dirs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["wtns", "check", "c40/chain.r1cs", "c40.wtns"])
    assert tcli.main(["r1cs", "info", "c40/chain.r1cs"]) == 0


def test_python_m_prints_the_usage():
    out = subprocess.run([sys.executable, "-m", "snarkjs_tpu_torch"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("usage: python -m snarkjs_tpu_torch <command>")
    assert len(lines) == 1 + len(tcli.COMMANDS) and lines[1] == "  powersoftau new"


@pytest.mark.slow
def test_cli_fixture_regenerates(tmp_path):
    """Marked slow: the JAX CLI session (XLA compiles, minutes on a CPU)
    gives the stored outputs; proofs are random and compared by shape."""
    got, want = tc.jax_session(str(tmp_path)), tc.stored()
    assert sorted(got) == sorted(want)
    for key, r in got.items():
        if key in tc.PROVES:
            assert r["rc"] == want[key]["rc"] == 0
            assert sorted(r["files"]) == sorted(want[key]["files"])
        else:
            assert r == want[key], key

