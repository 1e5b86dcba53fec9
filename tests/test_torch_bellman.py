"""snarkjs_tpu_torch's Bellman interop (`ceremony/bellman.py`: export,
bellman_contribute, import) against snarkjs_tpu on the CPU.  Tolerance:
none; MPCParams bytes, responses, contribution hashes, zkey bytes, verdicts
and logger messages exactly.

Inputs: the final key of tests/_torch_phase2.py's contribute -> beacon chain
(made by the JAX package) on each case.  Also the reference's fact that an
export and a re-import with no new contribution keeps section 8 and changes
every point of section 9: the export drops the last tau-form H point and the
import puts a zero point in its place, and verify weights that point by 0.
"""

import functools
import struct

import numpy as np
import pytest

from snarkjs_tpu.ceremony import bellman as JB
from snarkjs_tpu.ceremony import zkey_mpc as J
from snarkjs_tpu.curves import host_curve as jhc
from snarkjs_tpu.formats import ptau as jptau
from snarkjs_tpu.utils.chacha import ChaCha as JChaCha
from snarkjs_tpu_torch import convert
from snarkjs_tpu_torch.ceremony import bellman as TB
from snarkjs_tpu_torch.ceremony import ptau_ops as TP
from snarkjs_tpu_torch.ceremony import zkey_mpc as T
from snarkjs_tpu_torch.curves import host_curve as thc
from snarkjs_tpu_torch.formats import ptau as tptau
from snarkjs_tpu_torch.formats.binfile import BinFile
from snarkjs_tpu_torch.formats.zkey import read_groth16_zkey
from snarkjs_tpu_torch.protocols import groth16 as tg
from snarkjs_tpu_torch.utils.chacha import ChaCha as TChaCha
from tests import _torch_phase2 as p2
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CASES = sorted(p2.CASES)


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The JAX package's final key, its export, one Bellman round on it
    (response, hash, logger lines) and the import of that response."""
    zk, pt, curve, _ = p2.CASES[case]
    z1, _ = J.contribute(p2.fixture(zk), name="first", rng=JChaCha(p2.SEED_CONTRIB))
    final, _ = J.beacon(z1, p2.BEACON, p2.BEACON_EXP, name="beacon")
    mpc = JB.export_mpc_params(final)
    log = p2.Log()
    resp, h = JB.bellman_contribute(jhc.get_curve(curve), mpc, rng=JChaCha(p2.SEED_BELLMAN),
                                    logger=log)
    imported = JB.import_mpc_params(final, resp, name="bellman")
    return {"final": final, "mpc": mpc, "response": resp, "hash": h, "log": log.lines,
            "imported": imported}


def _cs_hash_pos(zkey: bytes) -> int:
    """Offset of the csHash in the key's MPCParams (after the vk and the six
    point arrays)."""
    zk = read_groth16_zkey(zkey)
    sg1, sg2 = 2 * zk.n8q, 4 * zk.n8q
    return (sg1 * 3 + sg2 * 3 + 8 + sg1 * zk.n_vars + 4 + sg1 * (zk.domain_size - 1)
            + 4 + sg1 * zk.n_vars + 4 + sg1 * zk.n_vars + 4 + sg2 * zk.n_vars)


def _round(case, **kw):
    """The port's export, Bellman round and import on the JAX final key."""
    j = _jax(case)
    curve = p2.CASES[case][2]
    mpc = TB.export_mpc_params(j["final"], **kw)
    log = p2.Log()
    resp, h = TB.bellman_contribute(thc.get_curve(curve), j["mpc"], rng=TChaCha(p2.SEED_BELLMAN),
                                    logger=log, **kw)
    imported = TB.import_mpc_params(j["final"], j["response"], name="bellman", **kw)
    return {"final": j["final"], "mpc": mpc, "response": resp, "hash": h, "log": log.lines,
            "imported": imported}


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("case", CASES)
def test_export_contribute_import_equal_jax(case):
    got = _round(case, device="cpu")
    assert got == _jax(case)
    assert got["log"] == [("info", "Bellman contribution computed")]


def test_export_contribute_import_device_route_equal_jax(monkeypatch):
    """With the host cutovers at 0: the group iNTTs through the batched
    stages, the coset keys and delta^-1 through batched double-and-adds (H
    and L of the round in one)."""
    p2.force_device_route(monkeypatch, TP)
    parts = []
    apply_keys = TP._apply_keys
    monkeypatch.setattr(TP, "_apply_keys", lambda cv, g2, ps, dev: parts.append(
        [n for _, n, _, _ in ps]) or apply_keys(cv, g2, ps, dev))
    stages = []
    stage = TP._intt_stage
    monkeypatch.setattr(TP, "_intt_stage", lambda *a: stages.append(a[4]) or stage(*a))
    assert _round("bn128_d8", device="cpu") == _jax("bn128_d8")
    n_l = 3
    assert parts == [[8], [7, n_l], [8]]
    assert stages == [0, 1, 2, 0, 1, 2]


def test_export_device_route_equal_jax_bls12_381(monkeypatch):
    """The export on bls12-381 with the host cutovers at 0: its group iNTT
    (three batched stages) and coset key as on the card."""
    p2.force_device_route(monkeypatch, TP)
    j = _jax("bls12381_d8")
    assert TB.export_mpc_params(j["final"], device="cpu") == j["mpc"]


def test_imported_key_verifies():
    """The key imported after one Bellman round verifies from its init key,
    as the JAX package's does, with the same logger lines."""
    case = "bn128_d8"
    imported = _jax(case)["imported"]
    init = p2.fixture(p2.CASES[case][0])
    data = p2.fixture(p2.CASES[case][1])
    jl, tl = p2.Log(), p2.Log()
    jv = J.verify_from_init(init, jptau.read_ptau(data), imported, logger=jl,
                            rng=np.random.default_rng(p2.VERIFY_SEED))
    tv = T.verify_from_init(init, tptau.read_ptau(data), imported, logger=tl,
                            rng=np.random.default_rng(p2.VERIFY_SEED), device="cpu")
    assert (tv, tl.lines) == (jv, jl.lines) == (True, [])


def _tampered(case, what):
    j = _jax(case)
    resp = bytearray(j["response"])
    final = j["final"]
    if what == "cs_hash":
        resp[_cs_hash_pos(final)] ^= 1
    elif what == "previous_contribution":
        # the first contribution's transcript: its last 64 bytes
        zk = read_groth16_zkey(final)
        rec = 3 * 2 * zk.n8q + 4 * zk.n8q + 64
        first = _cs_hash_pos(final) + 64 + 4
        resp[first + rec - 1] ^= 1
    elif what == "no_new_contribution":
        return final, bytes(j["mpc"][:_cs_hash_pos(final) + 64]) + struct.pack(">I", 0)
    elif what == "ic_count":
        zk = read_groth16_zkey(final)
        off = 3 * 2 * zk.n8q + 3 * 4 * zk.n8q
        resp[off + 3] ^= 1
    return final, bytes(resp)


@pytest.mark.parametrize("what", ["cs_hash", "previous_contribution", "no_new_contribution",
                                  "ic_count"])
def test_import_rejections_equal_jax(what):
    final, resp = _tampered("bn128_d8", what)
    jl, tl = p2.Log(), p2.Log()
    jv = JB.import_mpc_params(final, resp, logger=jl)
    tv = TB.import_mpc_params(final, resp, logger=tl, device="cpu")
    assert (tv, tl.lines) == (jv, jl.lines)
    assert tv is False and len(tl.lines) == 1


def test_reimport_without_contribution_keeps_l_changes_h_and_verifies():
    """A reference fact, not a fault of the port: export then import with no
    new contribution gives section 8 back but every point of section 9
    differs (the dropped last tau-form point comes back as zero); the key
    still verifies in both packages, and a Groth16 proof made with it passes
    the pairing check."""
    case = "bn128_d8"
    final = _jax(case)["final"]
    init = p2.fixture(p2.CASES[case][0])
    mpc = TB.export_mpc_params(final, device="cpu")
    again = TB.import_mpc_params(final, mpc, device="cpu")
    assert again == JB.import_mpc_params(final, mpc)
    a, b = BinFile(final, "zkey"), BinFile(again, "zkey")
    assert a.read_section(8) == b.read_section(8)
    assert a.read_section(10) == b.read_section(10)
    sz = p2.point_size(final)
    h0, h1 = a.read_section(9), b.read_section(9)
    assert len(h0) == len(h1)
    assert all(h0[i:i + sz] != h1[i:i + sz] for i in range(0, len(h0), sz))
    data = p2.fixture(p2.CASES[case][1])
    jl, tl = p2.Log(), p2.Log()
    assert J.verify_from_init(init, jptau.read_ptau(data), again, logger=jl,
                              rng=np.random.default_rng(p2.VERIFY_SEED))
    assert T.verify_from_init(init, tptau.read_ptau(data), again, logger=tl,
                              rng=np.random.default_rng(p2.VERIFY_SEED), device="cpu")
    assert jl.lines == tl.lines == []

    _, _, wit = p2.graft()._tiny_circuit(p2.CASES[case][3], p2.CASES[case][2])
    zk = read_groth16_zkey(again)
    proof, publics = tg.prove(zk, convert.witness_from_numpy(wit), r=0x1234, s=0x5678,
                              device="cpu")
    vk = tg.export_verification_key(zk)
    assert tg.verify(vk, publics, proof)
    assert not tg.verify(vk, [str(int(publics[0]) + 1)] + publics[1:], proof)
