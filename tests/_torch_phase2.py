"""Shared by tests/test_torch_zkey_mpc.py and tests/test_torch_bellman.py:
the phase-2 inputs (in-repo Groth16 keys from `setup_from_ptau` and their
.ptau files), the fixed seeds, and the tampering helpers.

Both packages read and write the same bytes, so each case runs the JAX
package and the port on the same inputs and compares bytes, hashes,
verdicts and logger messages exactly.  On CPU tensors the port sends
apply-keys and MSMs of up to `ptau_ops.HOST_MAX` points and group iNTT
blocks of up to `ptau_ops.HOST_IFFT_MAX_CPU` points to host bigints;
`force_device_route` sets both cutovers to 0, so every size takes the route
it takes on the card.
"""

import importlib.util
import os

from snarkjs_tpu_torch.formats.binfile import BinFile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")

# case -> (init zkey, .ptau, curve, constraints of `_tiny_circuit`).  Every
# init key was made from the power-4 .ptau of its curve; the domain-16 key
# is verified against the power-7 .ptau of the same secrets, whose tauG1
# section holds the 2 * 16 points its H check reads.
CASES = {
    "bn128_d8": ("tiny3_bn128_from_ptau.zkey", "tiny_p4_bn128.ptau", "bn128", 3),
    "bn128_d16": ("tiny10_bn128_from_ptau.zkey", "tiny_p7_bn128.ptau", "bn128", 10),
    "bls12381_d8": ("tiny3_bls12381_from_ptau.zkey", "tiny_p4_bls12381.ptau",
                    "bls12-381", 3),
}
SEED_CONTRIB = [0x2001, 0x2002, 0x2003, 0x2004, 5, 6, 7, 8]
SEED_BELLMAN = [0xBE11, 0xBE12, 0xBE13, 0xBE14, 1, 2, 3, 4]
BEACON = bytes.fromhex("22" * 32)
BEACON_EXP = 5
VERIFY_SEED = 11


class Log:
    """A logger that keeps what it is given."""

    def __init__(self):
        self.lines = []

    def error(self, m):
        self.lines.append(("error", m))

    def info(self, m):
        self.lines.append(("info", m))

    def warn(self, m):
        self.lines.append(("warn", m))

    def debug(self, m):
        pass


def fixture(name) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def graft():
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(ROOT, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    return g


def force_device_route(monkeypatch, ptau_ops):
    monkeypatch.setattr(ptau_ops, "HOST_MAX", 0)
    monkeypatch.setattr(ptau_ops, "HOST_IFFT_MAX_CPU", 0)


def chain(zkey_mpc, chacha, init: bytes, **kw):
    """contribute (SEED_CONTRIB) then beacon: [(zkey, contribution hash)]."""
    z1, h1 = zkey_mpc.contribute(init, name="first", rng=chacha(SEED_CONTRIB), **kw)
    z2, h2 = zkey_mpc.beacon(z1, BEACON, BEACON_EXP, name="beacon", **kw)
    return [(z1, h1), (z2, h2)]


def point_size(zkey: bytes) -> int:
    """Bytes of one G1 LEM point of the key's curve (2 * n8q)."""
    bf = BinFile(zkey, "zkey")
    return 2 * bf.reader(2).u32()


def with_section(zkey: bytes, sid: int, payload: bytes) -> bytes:
    """The key with section `sid` replaced by a payload of the same size."""
    bf = BinFile(zkey, "zkey")
    s = bf.section(sid)
    assert len(payload) == s.size
    return zkey[:s.pos] + payload + zkey[s.pos + s.size:]


def swap_points(zkey: bytes, sid: int) -> bytes:
    """The key with the first two points of a G1 section swapped."""
    sz = point_size(zkey)
    sec = bytearray(BinFile(zkey, "zkey").read_section(sid))
    sec[:sz], sec[sz:2 * sz] = sec[sz:2 * sz], sec[:sz]
    return with_section(zkey, sid, bytes(sec))


def edit_last_contribution(zkey_mpc, zkey: bytes, edit) -> bytes:
    """The key with `edit` applied to its last contribution record (the
    record keeps its size)."""
    bf = BinFile(zkey, "zkey")
    cv = zkey_mpc._parse(zkey)[1]
    mp = zkey_mpc.read_mpc_params(cv, bf.read_section(10))
    edit(mp.contributions[-1])
    return with_section(zkey, 10, zkey_mpc.write_mpc_params(cv, mp))


def flip_transcript(c):
    c.transcript = bytes([c.transcript[0] ^ 1]) + c.transcript[1:]


def flip_beacon_hash(c):
    c.beacon_hash = bytes([c.beacon_hash[0] ^ 1]) + c.beacon_hash[1:]
