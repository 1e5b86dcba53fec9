"""Shared by tests/test_torch_cli*.py: the CLI session run the same way
through either package's `cli.main`, and the stored JAX outputs.

The session (`STEPS`) drives every command of the CLI on tiny bn128 files
written by tests/_wasm_chain.py: the ceremony at power 4, Groth16 setup of
the 3-constraint chain from the stored power-4 .ptau (the key equals
fixtures/tiny3_bn128_from_ptau.zkey) and its phase 2, PLONK setup from the
same .ptau, FFLONK setup of the 12-constraint chain from the power-7 .ptau
(equal to fixtures/tiny_fflonk_bn128.zkey), proves and full proves, the
exports, and the r1cs / wtns tools on the 40-constraint chain with
circom's coefficients.  `secrets.token_bytes` gives ENTROPY_BYTES during a
session, so the contributions are fixed by their `-e` entropy.

The JAX package's ceremony, setup, phase-2 and prove steps take XLA
compiles on a CPU, so what they wrote (SHA-256 of each output file, exit
code, standard output; the proof files themselves, which are random) is
stored in snarkjs_tpu_torch/fixtures/cli_jax.json.  `python -m
tests._torch_cli` rewrites it; the slow-marked `test_cli_fixture_regenerates`
checks it.  The cheap steps (`LIVE`) run through the JAX CLI in the test
itself.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import logging
import os
import secrets
import shutil

from tests import _wasm_chain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
FIXTURE = os.path.join(FIXTURES, "cli_jax.json")
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ENTROPY_BYTES = bytes(range(64))
BEACON = "0123456789abcdef" * 4

# (key, command words, files it writes); paths are relative to the session
# directory.  Order matters: later steps read what earlier ones wrote.
STEPS = [
    ("ptau new", ["powersoftau", "new", "bn128", "4", "pot0.ptau"], ["pot0.ptau"]),
    ("ptau contribute", ["powersoftau", "contribute", "pot0.ptau", "pot1.ptau",
                         "--name=first", "-eentropy one"], ["pot1.ptau"]),
    ("ptau export challenge", ["powersoftau", "export", "challenge", "pot1.ptau",
                               "challenge"], ["challenge"]),
    ("ptau challenge contribute", ["powersoftau", "challenge", "contribute", "bn128",
                                   "challenge", "response", "-eentropy two"], ["response"]),
    ("ptau import response", ["powersoftau", "import", "response", "pot1.ptau",
                              "response", "pot2.ptau", "--name=second"], ["pot2.ptau"]),
    ("ptau beacon", ["ptau", "beacon", "pot2.ptau", "pot3.ptau", BEACON, "3",
                     "--name=final"], ["pot3.ptau"]),
    ("ptau prepare phase2", ["powersoftau", "prepare", "phase2", "pot3.ptau",
                             "pot_final.ptau"], ["pot_final.ptau"]),
    ("ptau convert", ["powersoftau", "convert", "pot_final.ptau", "pot_conv.ptau"],
     ["pot_conv.ptau"]),
    ("ptau truncate", ["powersoftau", "truncate", "pot_final.ptau"],
     [f"pot_final_{p:02d}.ptau" for p in (1, 2, 3)]),
    ("ptau verify", ["powersoftau", "verify", "pot_final.ptau"], []),
    ("ptau export json", ["powersoftau", "export", "json", "pot_final.ptau", "pot.json"],
     ["pot.json"]),
    ("wtns calculate c3", ["wtns", "calculate", "c3/chain.wasm", "c3/input.json",
                           "c3/w.wtns"], ["c3/w.wtns"]),
    ("groth16 setup", ["groth16", "setup", "c3/chain.r1cs", "p4.ptau", "k0.zkey"],
     ["k0.zkey"]),
    ("zkey contribute", ["zkey", "contribute", "k0.zkey", "k1.zkey", "--name=one",
                         "-eentropy three"], ["k1.zkey"]),
    ("zkey beacon", ["zkey", "beacon", "k1.zkey", "k2.zkey", BEACON, "3",
                     "--name=beacon"], ["k2.zkey"]),
    ("zkey verify r1cs", ["zkey", "verify", "r1cs", "c3/chain.r1cs", "p4.ptau",
                          "k2.zkey"], []),
    ("zkey verify init", ["zkey", "verify", "init", "k0.zkey", "p4.ptau", "k2.zkey"], []),
    ("zkey verify", ["zk", "verify", "c3/chain.r1cs", "p4.ptau", "k2.zkey"], []),
    ("zkey export bellman", ["zkey", "export", "bellman", "k2.zkey", "c.mpcparams"],
     ["c.mpcparams"]),
    ("zkey bellman contribute", ["zkey", "bellman", "contribute", "bn128", "c.mpcparams",
                                 "c2.mpcparams", "-eentropy four"], ["c2.mpcparams"]),
    ("zkey import bellman", ["zkey", "import", "bellman", "k2.zkey", "c2.mpcparams",
                             "k3.zkey", "--name=imported"], ["k3.zkey"]),
    ("groth16 prove", ["g16", "prove", "k3.zkey", "c3/w.wtns", "g16_proof.json",
                       "g16_public.json"], None),
    ("groth16 fullprove", ["groth16", "fullprove", "c3/input.json", "c3/chain.wasm",
                           "k3.zkey", "g16f_proof.json", "g16f_public.json"], None),
    ("plonk setup", ["plonk", "setup", "c3/chain.r1cs", "p4.ptau", "pk.zkey"], ["pk.zkey"]),
    ("plonk prove", ["plonk", "prove", "pk.zkey", "c3/w.wtns", "plonk_proof.json",
                     "plonk_public.json"], None),
    ("plonk fullprove", ["plonk", "fullprove", "c3/input.json", "c3/chain.wasm", "pk.zkey",
                         "plonkf_proof.json", "plonkf_public.json"], None),
    ("wtns calculate c12", ["wtns", "calculate", "c12/chain.wasm", "c12/input.json",
                            "c12/w.wtns"], ["c12/w.wtns"]),
    ("fflonk setup", ["fflonk", "setup", "c12/chain.r1cs", "p7.ptau", "fk.zkey"], ["fk.zkey"]),
    ("fflonk prove", ["fflonk", "prove", "fk.zkey", "c12/w.wtns", "fflonk_proof.json",
                      "fflonk_public.json"], None),
    ("fflonk fullprove", ["fflonk", "fullprove", "c12/input.json", "c12/chain.wasm",
                          "fk.zkey", "fflonkf_proof.json", "fflonkf_public.json"], None),
]
# proves: files None, their proof and public files are stored whole
PROVES = {key: words[-2:] for key, words, files in STEPS if files is None}

# the cheap steps, compared with the JAX CLI live: (key, words, files)
LIVE = [
    ("r1cs info", ["r1cs", "info", "c40/chain.r1cs"], []),
    ("r1cs print", ["r1cs", "print", "c40/chain.r1cs", "c40/chain.sym"], []),
    ("r1cs export json", ["r1cs", "export", "json", "c40/chain.r1cs", "c40.json"],
     ["c40.json"]),
    ("wtns calculate", ["wtns", "calculate", "c40/chain.wasm", "c40/input.json",
                        "c40.wtns"], ["c40.wtns"]),
    ("wtns debug", ["wtns", "debug", "c40/chain.wasm", "c40/input.json", "c40d.wtns",
                    "c40/chain.sym"], ["c40d.wtns"]),
    ("wtns export json", ["wtns", "export", "json", "c40.wtns", "c40w.json"],
     ["c40w.json"]),
    ("wtns check", ["wtns", "check", "c40/chain.r1cs", "c40.wtns"], []),
    ("wtns check flipped", ["wtns", "check", "c40/chain.r1cs", "bad.wtns"], []),
    ("zkey export json", ["zkey", "export", "json", "k3.zkey", "k3.json"], ["k3.json"]),
    ("zkey export verificationkey", ["zkey", "export", "verificationkey", "k3.zkey",
                                     "g16_vk.json"], ["g16_vk.json"]),
    ("zkey export verificationkey plonk", ["zkey", "export", "verificationkey", "pk.zkey",
                                           "plonk_vk.json"], ["plonk_vk.json"]),
    ("zkey export verificationkey fflonk", ["zkey", "export", "verificationkey", "fk.zkey",
                                            "fflonk_vk.json"], ["fflonk_vk.json"]),
    ("zkey export solidityverifier", ["zkey", "export", "solidityverifier", "k3.zkey",
                                      "verifier.sol"], ["verifier.sol"]),
    ("zkey export soliditycalldata", ["zkey", "export", "soliditycalldata",
                                      "g16_public.json", "g16_proof.json"], []),
    ("file info", ["file", "info", "p4.ptau"], []),
]
# the verify commands, run on each package's proofs by the other's CLI
VERIFY = {"groth16": ("g16_vk.json", ["groth16 prove", "groth16 fullprove"]),
          "plonk": ("plonk_vk.json", ["plonk prove", "plonk fullprove"]),
          "fflonk": ("fflonk_vk.json", ["fflonk prove", "fflonk fullprove"])}


def write_inputs(d: str):
    """The session's input files: the three chains and the stored .ptau files."""
    _wasm_chain.write_chain(os.path.join(d, "c3"), BN254_R, 3, ones=True)
    _wasm_chain.write_chain(os.path.join(d, "c12"), BN254_R, 12, ones=True)
    _wasm_chain.write_chain(os.path.join(d, "c40"), BN254_R, 40)
    shutil.copy(os.path.join(FIXTURES, "tiny_p4_bn128.ptau"), os.path.join(d, "p4.ptau"))
    shutil.copy(os.path.join(FIXTURES, "tiny_p7_bn128.ptau"), os.path.join(d, "p7.ptau"))


def flip_value(src: str, dst: str, wire: int, n_wires: int):
    """A copy of a bn128 .wtns with the low bit of one wire's value flipped."""
    with open(src, "rb") as f:
        data = bytearray(f.read())
    data[len(data) - 32 * (n_wires - wire)] ^= 1
    with open(dst, "wb") as f:
        f.write(data)


def sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run(main, logger_name: str, words, extra=()) -> dict:
    """One CLI call in the current directory: exit code, standard output and
    the logger's messages."""
    handler = _Lines()
    logger = logging.getLogger(logger_name)
    logger.addHandler(handler)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(list(words) + list(extra))
    finally:
        logger.removeHandler(handler)
    return {"rc": rc, "stdout": out.getvalue(), "log": handler.lines}


@contextlib.contextmanager
def fixed_entropy():
    saved = secrets.token_bytes
    secrets.token_bytes = lambda n=32: ENTROPY_BYTES[:n]
    try:
        yield
    finally:
        secrets.token_bytes = saved


def session(main, logger_name: str, d: str, steps=STEPS, extra=()) -> dict:
    """Run `steps` in directory d (inputs written first): key -> the call's
    result, with the SHA-256 of the files it wrote or, for a prove, the
    proof and public signals."""
    write_inputs(d)
    res = {}
    cwd = os.getcwd()
    os.chdir(d)
    try:
        with fixed_entropy():
            for key, words, files in steps:
                r = run(main, logger_name, words, extra)
                if files is None:
                    r["files"] = {}
                    for fn in words[-2:]:
                        with open(fn) as f:
                            r["files"][fn] = json.load(f)
                else:
                    r["files"] = {fn: sha(fn) for fn in files}
                res[key] = r
    finally:
        os.chdir(cwd)
    return res


def live(main, logger_name: str, d: str, extra=()) -> dict:
    """Run the LIVE steps in directory d, where a session has run; the
    flipped witness is written just before its check."""
    res = {}
    cwd = os.getcwd()
    os.chdir(d)
    try:
        for key, words, files in LIVE:
            if key == "wtns check flipped":
                flip_value("c40.wtns", "bad.wtns", 7, 42)   # constraint 5's output
            res[key] = run(main, logger_name, words, extra)
            res[key]["files"] = {fn: sha(fn) for fn in files}
    finally:
        os.chdir(cwd)
    return res


def jax_session(d: str) -> dict:
    from snarkjs_tpu import cli as jcli

    return session(jcli.main, "snarkjs_tpu", d)


def stored() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


if __name__ == "__main__":
    import tempfile

    import tests.conftest  # noqa: F401  (JAX on the CPU, the compile cache)

    with tempfile.TemporaryDirectory() as tmp:
        out = jax_session(tmp)
    with open(FIXTURE, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {FIXTURE}")
