"""snarkjs_tpu_torch.tools against snarkjs_tpu.tools on the CPU: r1cs info,
export json and print (with the .sym), wtns export json, check and debug,
the Groth16 zkey dump.  Inputs: tests/_wasm_chain.py's chain (circom's
coefficients and all-1) and fixtures/tiny_bn128.zkey.  Tolerance: none;
dicts, strings, bytes and logger lines exactly.
"""

import collections
import os

import numpy as np
import pytest

from snarkjs_tpu import tools as jtools
from snarkjs_tpu.formats import r1cs as jr1cs
from snarkjs_tpu.formats import wtns as jwtns
from snarkjs_tpu_torch import tools as ttools
from snarkjs_tpu_torch.curves import host_curve as thc
from snarkjs_tpu_torch.fields import ftorch
from snarkjs_tpu_torch.formats import r1cs as tr1cs
from snarkjs_tpu_torch.formats import wtns as twtns
from snarkjs_tpu_torch.wasm import witness_calculator as twc
from tests import _wasm_chain
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
NC = 40
P = {"bn128": thc.BN254.fr.p, "bls12381": thc.BLS12_381.fr.p}


class Lines:
    """A logger that keeps its lines."""

    def __init__(self):
        self.lines = []

    def info(self, m):
        self.lines.append(("info", m))

    def error(self, m):
        self.lines.append(("error", m))


def _files(curve="bn128", ones=False, nc=NC):
    p = P[curve]
    data = _wasm_chain.chain_r1cs(p, nc, ones)
    wtns = twc.wtns_bytes(p, 8, _wasm_chain.chain_witness(p, nc))
    return data, wtns


def _ragged_r1cs(prime: int, n8: int, nc: int, seed: int) -> bytes:
    """A .r1cs whose linear combinations hold 0 to 4 entries each."""
    import struct

    rng = np.random.default_rng(seed)
    n_wires = 50
    header = (struct.pack("<I", n8) + prime.to_bytes(n8, "little")
              + struct.pack("<IIIIQI", n_wires, 1, 1, 2, n_wires, nc))
    body = b""
    for _ in range(3 * nc):
        ne = int(rng.integers(0, 5))
        body += struct.pack("<I", ne)
        for _ in range(ne):
            body += struct.pack("<I", int(rng.integers(0, n_wires)))
            body += (int(rng.integers(0, 2**62)) ** 4 % prime).to_bytes(n8, "little")
    sections = [(1, header), (2, body)]
    return (b"r1cs" + struct.pack("<II", 1, len(sections))
            + b"".join(struct.pack("<IQ", sid, len(p)) + p for sid, p in sections))


@pytest.mark.parametrize("curve,n8,nc", [("bn128", 32, 300), ("bls12381", 32, 7),
                                          ("bn128", 32, 0)])
def test_read_r1cs_ragged_equals_jax(curve, n8, nc):
    """The port's parse (every entry cut out at once) gives the JAX reader's
    arrays on combinations of 0 to 4 entries, and on no constraint."""
    data = _ragged_r1cs(P[curve], n8, nc, seed=nc)
    jr, tr = jr1cs.read_r1cs(data), tr1cs.read_r1cs(data)
    for k in ("m", "c", "s", "vals"):
        a, b = getattr(tr, k), getattr(jr, k)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        np.testing.assert_array_equal(a, b)
    assert tr.n_constraints == jr.n_constraints == nc


@pytest.mark.parametrize("curve,ones", [("bn128", False), ("bn128", True),
                                        ("bls12381", False)])
def test_r1cs_tools_equal_jax(curve, ones):
    data, _ = _files(curve, ones)
    jr, tr = jr1cs.read_r1cs(data), tr1cs.read_r1cs(data)
    jl, tl = Lines(), Lines()
    assert ttools.r1cs_info(tr, logger=tl) == jtools.r1cs_info(jr, logger=jl)
    assert tl.lines == jl.lines and len(tl.lines) == 7
    assert ttools.r1cs_export_json(tr) == jtools.r1cs_export_json(jr)
    sym = _wasm_chain.chain_sym(NC)
    assert ttools.load_syms(sym) == jtools.load_syms(sym)
    jl, tl = Lines(), Lines()
    got = ttools.r1cs_print(tr, ttools.load_syms(sym), logger=tl)
    assert got == jtools.r1cs_print(jr, jtools.load_syms(sym), logger=jl)
    assert tl.lines == jl.lines
    assert got[1] == ("[ main.y[0] ] * [ main.y[0] ] - [ main.y[1] ] = 0" if ones
                      else "[ main.y[0] ] * [ -main.y[0] ] - [ -main.y[1] ] = 0")


def test_wtns_export_json_equals_jax():
    _, wtns = _files()
    got = ttools.wtns_export_json(twtns.read_wtns(wtns))
    assert got == jtools.wtns_export_json(jwtns.read_wtns(wtns))
    assert got == [str(v) for v in _wasm_chain.chain_witness(P["bn128"], NC)]


def _flip(wtns: bytes, wire: int, n_wires: int) -> bytes:
    bad = bytearray(wtns)
    bad[len(bad) - 32 * (n_wires - wire)] ^= 1
    return bytes(bad)


@pytest.mark.parametrize("case", ["good", "flipped", "other curve", "short"])
def test_wtns_check_equals_jax(case):
    """True on the chain's witness; False with one flipped limb (constraint
    5's output), a witness of the other curve, or a short witness; the same
    logger lines as the JAX package."""
    data, wtns = _files()
    if case == "flipped":
        wtns = _flip(wtns, 7, NC + 2)
    elif case == "other curve":
        wtns = _files("bls12381")[1]
    elif case == "short":
        wtns = twc.wtns_bytes(P["bn128"], 8, _wasm_chain.chain_witness(P["bn128"], NC - 1))
    jl, tl = Lines(), Lines()
    want = jtools.wtns_check(jr1cs.read_r1cs(data), jwtns.read_wtns(wtns), logger=jl)
    got = ttools.wtns_check(tr1cs.read_r1cs(data), twtns.read_wtns(wtns), logger=tl,
                            device="cpu")
    assert got is want is (case == "good")
    assert tl.lines == jl.lines
    expect = {"good": ("info", "WITNESS IS CORRECT"),
              "flipped": ("error", "Constraint 5 does not match"),
              "other curve": ("error", "Curve of the witness does not match the r1cs curve"),
              "short": ("error", f"Invalid witness length. Circuit: {NC + 2}, witness: {NC + 1}")}
    assert tl.lines == [expect[case]]


def test_wtns_check_makes_16_field_launches(monkeypatch):
    """Every field op of `wtns_check` is one K-field launch on the card: 16,
    whatever the size (chip_smoke.py phase 15 checks the count there)."""
    counts = collections.Counter()
    for op in ("add", "sub", "mont_mul", "neg"):
        orig = getattr(ftorch, op)

        def wrap(*a, _o=orig, _n=op):
            counts[_n] += 1
            return _o(*a)
        monkeypatch.setattr(ftorch, op, wrap)
    for nc in (5, NC):
        counts.clear()
        data, wtns = _files(nc=nc)
        assert ttools.wtns_check(tr1cs.read_r1cs(data), twtns.read_wtns(wtns), device="cpu")
        assert counts == {"mont_mul": 13, "add": 3}


def test_wtns_debug_equals_jax():
    p = P["bn128"]
    wasm = _wasm_chain.chain_wasm(p, NC)
    sym = _wasm_chain.chain_sym(NC)
    jl, tl = Lines(), Lines()
    got = ttools.wtns_debug({"x": _wasm_chain.X}, wasm, sym_path=sym, logger=tl)
    assert got == jtools.wtns_debug({"x": _wasm_chain.X}, wasm, sym_path=sym, logger=jl)
    assert got == _files()[1] and tl.lines == jl.lines


def test_zkey_export_json_equals_jax():
    path = os.path.join(FIXTURES, "tiny_bn128.zkey")
    got = ttools.zkey_export_json(path)
    assert got == jtools.zkey_export_json(path)
    assert len(got["ccoefs"]) == 2 * NC + 2 and got["C"][:2] == [None, None]
    assert np.all([len(c) == 3 for c in got["A"]])
