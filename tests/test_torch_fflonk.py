"""snarkjs_tpu_torch FFLONK (zkey reader, setup, prove, verify, calldata)
against snarkjs_tpu on the CPU.  Tolerance: none; zkey bytes, limbs and
proof JSON exactly.

Two bn128 circuits: the squaring chain `__graft_entry__._tiny_circuit(12)`
(domain 16, SRS 9n + 18 = 162 points) and `adds_circuit()`, whose wide linear
combinations make `process_constraints` emit additions that read earlier
additions (the prover's sequential additions loop).  Both are set up from
tau = TAU and proved with the blinders b = 1..10.

The JAX package's FFLONK setup and prove take minutes of XLA compiles on a
CPU, so its zkeys, proofs and calldata are stored in
snarkjs_tpu_torch/fixtures/ (tiny_fflonk_*), with `tiny_p7_bn128.ptau`, a
prepared power-7 .ptau of the same tau (255 tauG1 points) for
`setup_from_ptau`.  `test_fflonk_fixtures_regenerate` (marked slow)
rebuilds every file with the JAX package; `python -m tests.test_torch_fflonk`
rewrites them.  The JAX `verify` is host work and runs here live.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from snarkjs_tpu.curves import host_curve as jhc
from snarkjs_tpu.fields import fjnp
from snarkjs_tpu.formats import ptau as jptau
from snarkjs_tpu.formats import r1cs as jr1cs
from snarkjs_tpu.formats import wtns as jwtns
from snarkjs_tpu.formats import zkey as jzkey
from snarkjs_tpu.protocols import fflonk as jff
from snarkjs_tpu_torch import convert
from snarkjs_tpu_torch.curves import host_curve as thc
from snarkjs_tpu_torch.formats import ptau as tptau
from snarkjs_tpu_torch.formats import r1cs as tr1cs
from snarkjs_tpu_torch.formats import wtns as twtns
from snarkjs_tpu_torch.formats import zkey as tzkey
from snarkjs_tpu_torch.protocols import fflonk as tff
from snarkjs_tpu_torch.protocols import fflonk_setup as tfs
from snarkjs_tpu_torch.protocols import plonk_setup as tps
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
TAU, ALPHA, BETA = 0x1234567890ABCDEF, 0x55555, 0x77777   # the .ptau fixtures'
B = list(range(1, 11))
PTAU7 = "tiny_p7_bn128.ptau"
CIRCUITS = ("tiny_fflonk_bn128", "tiny_fflonk_adds_bn128")


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(ROOT, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    return g


def adds_circuit():
    """A bn128 r1cs of six constraints over wires 1, x (public), a..f with
    wide linear combinations, and its witness:
        x * x = a,  a * x = b,  (a + b) * (x + 1) = c,
        (a + b + c + x) * b = d,  1 * (a + 2b + 3c + 4d + 5x) = e,
        (x + a + b + c + d + e) * 1 = f."""
    fr = jhc.get_curve("bn128").fr
    p = fr.p
    cons = [({1: 1}, {1: 1}, {2: 1}), ({2: 1}, {1: 1}, {3: 1}),
            ({2: 1, 3: 1}, {1: 1, 0: 1}, {4: 1}), ({2: 1, 3: 1, 4: 1, 1: 1}, {3: 1}, {5: 1}),
            ({0: 1}, {2: 1, 3: 2, 4: 3, 5: 4, 1: 5}, {6: 1}),
            ({1: 1, 2: 1, 3: 1, 4: 1, 5: 1, 6: 1}, {0: 1}, {7: 1})]
    m, c, s, v = [], [], [], []
    for ci, lcs in enumerate(cons):
        for mi, lc in enumerate(lcs):
            for si, val in lc.items():
                m.append(mi), c.append(ci), s.append(si), v.append(val)
    x = 0xDEADBEEF
    a = x * x % p
    b_ = a * x % p
    c_ = (a + b_) * (x + 1) % p
    d = (a + b_ + c_ + x) * b_ % p
    e = (a + 2 * b_ + 3 * c_ + 4 * d + 5 * x) % p
    f = (x + a + b_ + c_ + d + e) % p
    w = [1, x, a, b_, c_, d, e, f]
    r1cs = jr1cs.R1cs(n8=fr.n8, prime=p, n_wires=8, n_pub_out=0, n_pub_in=1,
                      n_prv_in=0, n_labels=8, n_constraints=len(cons),
                      m=np.asarray(m, np.int32), c=np.asarray(c, np.int32),
                      s=np.asarray(s, np.int32), vals=fjnp.np_from_ints(fr, v))
    wit = jwtns.Witness(n8=fr.n8, q=p, n=8, values=fjnp.np_from_ints(fr, w))
    return r1cs, wit


def _circuit(name):
    if name == "tiny_fflonk_bn128":
        _, r1cs, wit = _graft()._tiny_circuit(12, "bn128")
        return r1cs, wit
    return adds_circuit()


def _torch_r1cs(r1cs):
    return tr1cs.R1cs(**{k: getattr(r1cs, k) for k in r1cs.__dataclass_fields__})


def ptau7_bytes() -> bytes:
    """The prepared power-7 .ptau that one contribution of (TAU, ALPHA, BETA)
    and preparePhase2 leave, written by the port: chip_smoke.py's scalars,
    their points by host scalar multiplication (at most 512 a call, so the
    port's host route), `PtauFile.tobytes`."""
    from snarkjs_tpu_torch.protocols import groth16_setup as tgs
    from snarkjs_tpu_torch.formats import points as tpc

    cs = _chip_smoke()
    cv = thc.get_curve("bn128")
    pt = tptau.PtauFile(cv, 7, 7)
    for sid, (ks, g2) in cs.ptau_scalars(cv, 7, TAU, ALPHA, BETA).items():
        enc = tpc.g2_lem_to_bytes if g2 else tpc.g1_lem_to_bytes
        pt.sections[sid] = b"".join(
            enc(cv.fq, *tgs._points_from_scalars(cv, ks[i:i + 512], g2))
            for i in range(0, len(ks), 512))
    return pt.tobytes()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def fixture_files() -> dict:
    """The stored JAX outputs: for each circuit the zkey of
    `fflonk_setup.setup_from_secrets(TAU)`, the witness, and the proof with
    B, its publics and its calldata."""
    from snarkjs_tpu.protocols import fflonk_setup as jfs

    out = {}
    for name in CIRCUITS:
        r1cs, wit = _circuit(name)
        zbytes = jfs.setup_from_secrets(r1cs, TAU)
        proof, publics = jff.prove(jzkey.read_fflonk_zkey(zbytes), wit, b=B)
        out[name + ".zkey"] = zbytes
        out[name + ".wtns"] = jwtns.write_wtns(jhc.get_curve("bn128").fr,
                                               np.asarray(wit.values))
        out[name + "_proof.json"] = (json.dumps(
            {"b": B, "proof": proof, "publicSignals": publics,
             "calldata": jff.export_solidity_calldata(proof, publics)},
            indent=1) + "\n").encode()
    return out


def _fixture(name) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _stored(name):
    return json.loads(_fixture(name + "_proof.json"))


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [y for x in t for y in _leaves(x)]
    return [t]


@pytest.fixture(scope="module")
def torch_proofs():
    """The port's proof of each stored key and witness, with B."""
    return {name: tff.prove_files(os.path.join(FIXTURES, name + ".zkey"),
                                  os.path.join(FIXTURES, name + ".wtns"),
                                  b=B, device="cpu")
            for name in CIRCUITS}


# ------------------------------------------------------------------- setup

def test_adds_circuit_chains_additions():
    """The additions circuit is satisfied, and its lowering has additions
    that read the output of an earlier addition."""
    r1cs, wit = adds_circuit()
    fr = jhc.get_curve("bn128").fr
    assert jr1cs.check_witness(r1cs, wit.values, fr)
    _, adds, n_vars = tps.process_constraints(thc.get_curve("bn128").fr, _torch_r1cs(r1cs))
    first = r1cs.n_wires
    assert len(adds) >= 4 and n_vars == first + len(adds)
    assert any(a >= first or b >= first for a, b, _, _ in adds)


@pytest.mark.parametrize("name", CIRCUITS)
def test_setup_from_secrets_bytes_equal_jax(name):
    r1cs, _ = _circuit(name)
    got = tfs.setup_from_secrets(_torch_r1cs(r1cs), TAU, device="cpu")
    assert got == _fixture(name + ".zkey")
    assert tzkey.zkey_protocol(got) == "fflonk"


def test_setup_from_ptau_bytes_equal_jax():
    """From the stored power-7 .ptau of the same tau: the zkey the JAX
    package's `setup_from_secrets` made (the slow test also holds the JAX
    `setup_from_ptau` to it)."""
    r1cs, _ = _circuit(CIRCUITS[0])
    got = tfs.setup_from_ptau(_torch_r1cs(r1cs), tptau.read_ptau(_fixture(PTAU7)),
                              device="cpu")
    assert got == _fixture(CIRCUITS[0] + ".zkey")


def test_ptau7_fixture_holds_tau_powers():
    pt = tptau.read_ptau(_fixture(PTAU7))
    cv = thc.get_curve("bn128")
    assert pt.power == 7 and 12 in pt.sections
    from snarkjs_tpu_torch.formats import points as tpc

    pts = tpc.g1_lem_to_ints(cv.fq, pt.sections[2], 255)
    for i in (0, 1, 161, 254):
        assert pts[i] == thc.g1_mul(cv, cv.g1, pow(TAU, i, cv.fr.p)), i
    assert tpc.g2_lem_to_ints(cv.fq, pt.sections[3], 2)[1] == thc.g2_mul(cv, cv.g2, TAU)


def test_setup_rejects_bls12_381_and_small_ptau():
    _, r1cs, _ = _graft()._tiny_circuit(3, "bls12-381")
    with pytest.raises(NotImplementedError, match="bn254-only"):
        tfs.setup_from_srs(_torch_r1cs(r1cs), b"", None, device="cpu")
    r1cs, _ = _circuit(CIRCUITS[0])
    with pytest.raises(ValueError, match="not big enough"):
        tfs.setup_from_srs(_torch_r1cs(r1cs), b"\0" * 64 * 161, None, device="cpu")


def test_sigma_and_combine_match_jax():
    """`_build_sigma_fflonk` (identity tail rows) and `combine_polys` against
    the JAX functions on the additions circuit's lowering."""
    from snarkjs_tpu.protocols import fflonk_setup as jfs

    fr = thc.get_curve("bn128").fr
    r1cs, _ = adds_circuit()
    con, _, _ = tps.process_constraints(fr, _torch_r1cs(r1cs))
    n = tfs._domain(len(con))
    assert n == 32 and tfs._domain(0) == 8
    assert list(tfs._build_sigma_fflonk(fr, con, n)) == \
        list(jfs._build_sigma_fflonk(jhc.get_curve("bn128").fr, con, n))
    rng = np.random.default_rng(3)
    polys = [rng.integers(0, 1 << 16, (16, k), dtype=np.uint32) for k in (5, 3, 5)]
    ctx = fjnp.get_ctx("bn254_fr")
    want = np.asarray(jfs.combine_polys(ctx, polys + [None], 5))
    got = tfs.combine_polys(ctx, [torch.from_numpy(p.astype(np.int32)) for p in polys]
                            + [None], 5)
    np.testing.assert_array_equal(want, got.numpy().astype(np.uint32))
    assert tfs.fflonk_roots(fr, 5) == jfs.fflonk_roots(jhc.get_curve("bn128").fr, 5)


# ------------------------------------------------------------------- codec

@pytest.mark.parametrize("name", CIRCUITS)
def test_read_fflonk_zkey_field_by_field(name):
    data = _fixture(name + ".zkey")
    a, b = jzkey.read_fflonk_zkey(data), tzkey.read_fflonk_zkey(data)
    assert a.curve.name == b.curve.name
    for f in ("n8q", "n8r", "n_vars", "n_public", "domain_size", "power",
              "n_additions", "n_constraints", "k1", "k2", "w3", "w4", "w8", "wr",
              "x_2", "c0"):
        assert getattr(a, f) == getattr(b, f), f
    for k in ("a", "b", "af", "bf"):
        np.testing.assert_array_equal(a.additions[k], b.additions[k])
    for f in ("a_map", "b_map", "c_map", "ql_p4", "qr_p4", "qm_p4", "qo_p4", "qc_p4",
              "sigma1_p4", "sigma2_p4", "sigma3_p4", "lagrange", "ptau", "c0_coefs"):
        fa, fb = _leaves(getattr(a, f)), _leaves(getattr(b, f))
        assert len(fa) == len(fb), f
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(np.asarray(x), y, err_msg=f)
    assert (b.n_additions > 0) == (name != CIRCUITS[0])
    assert json.dumps(tff.export_verification_key(b)) == \
        json.dumps(jff.export_verification_key(a))
    with pytest.raises(ValueError, match="not a fflonk zkey"):
        tzkey.read_fflonk_zkey(_fixture("tiny_plonk_bn128.zkey"))


# ------------------------------------------------- prove and verify, whole

@pytest.mark.parametrize("name", CIRCUITS)
def test_proof_and_calldata_equal_jax(name, torch_proofs):
    want = _stored(name)
    proof, publics = torch_proofs[name]
    assert json.dumps([proof, publics]) == json.dumps([want["proof"], want["publicSignals"]])
    assert tff.export_solidity_calldata(proof, publics) == want["calldata"] == \
        jff.export_solidity_calldata(proof, publics)


@pytest.mark.parametrize("name", CIRCUITS)
def test_each_verifies_the_other_and_rejects_tampering(name, torch_proofs):
    want = _stored(name)
    data = _fixture(name + ".zkey")
    vk_t = tff.export_verification_key(tzkey.read_fflonk_zkey(data))
    vk_j = jff.export_verification_key(jzkey.read_fflonk_zkey(data))
    proof, publics = torch_proofs[name]
    assert tff.verify(vk_t, want["publicSignals"], want["proof"])
    assert jff.verify(vk_j, publics, proof)
    tampered = [str(int(publics[0]) + 1)] + publics[1:]
    bad = json.loads(json.dumps(proof))
    bad["evaluations"]["a"] = str(int(bad["evaluations"]["a"]) + 1)
    for verify, vk in ((tff.verify, vk_t), (jff.verify, vk_j)):
        assert not verify(vk, tampered, proof)
        assert not verify(vk, publics, bad)


def test_prove_from_carried_key_and_blinders_drawn():
    """A key carried over from the JAX reader (`convert`) proves the same; with
    no blinders given they are drawn, and the JAX verifier accepts."""
    name = CIRCUITS[0]
    zk_j = jzkey.read_fflonk_zkey(_fixture(name + ".zkey"))
    zk = convert.fflonk_zkey_from_numpy(zk_j)
    wit = twtns.read_wtns(_fixture(name + ".wtns"))
    proof, publics = tff.prove(zk, wit, device="cpu")
    assert proof["polynomials"]["C1"] != _stored(name)["proof"]["polynomials"]["C1"]
    assert jff.verify(jff.export_verification_key(zk_j), publics, proof)


def test_prove_rejects_wrong_witness():
    """A witness of another length or curve raises, as in the JAX prover.  A
    witness with a wrong value still satisfies every copy constraint (the
    wires are gathered from it), so the prover's checks pass, as the JAX
    package's do; its proof is rejected by both verifiers."""
    data = _fixture(CIRCUITS[0] + ".zkey")
    zk = tzkey.read_fflonk_zkey(data)
    wit = twtns.read_wtns(_fixture(CIRCUITS[0] + ".wtns"))
    vals = wit.values.copy()
    short = type(wit)(n8=wit.n8, q=wit.q, n=wit.n - 1, values=vals[:, :-1])
    with pytest.raises(ValueError, match="Invalid witness length"):
        tff.prove(zk, short, b=B, device="cpu")
    other = type(wit)(n8=wit.n8, q=wit.q + 2, n=wit.n, values=vals)
    with pytest.raises(ValueError, match="Curve of the witness"):
        tff.prove(zk, other, b=B, device="cpu")
    vals[0, 7] ^= 1
    proof, publics = tff.prove(zk, type(wit)(n8=wit.n8, q=wit.q, n=wit.n, values=vals),
                               b=B, device="cpu")
    assert publics == _stored(CIRCUITS[0])["publicSignals"]
    assert not tff.verify(tff.export_verification_key(zk), publics, proof)
    assert not jff.verify(jff.export_verification_key(jzkey.read_fflonk_zkey(data)),
                          publics, proof)


# ---------------------------------------------------------- stored fixture

@pytest.mark.slow
def test_fflonk_fixtures_regenerate():
    """Marked slow: the JAX FFLONK setup and prove compile XLA programs for
    minutes on a CPU.  Also the JAX `setup_from_ptau` on the stored .ptau,
    and that .ptau against the JAX package's preparePhase2."""
    from snarkjs_tpu.protocols import fflonk_setup as jfs
    from tests.test_torch_groth16_setup import jax_ptau_bytes

    for name, data in fixture_files().items():
        assert _fixture(name) == data, name
    assert _fixture(PTAU7) == jax_ptau_bytes(7) == ptau7_bytes()
    r1cs, _ = _circuit(CIRCUITS[0])
    assert jfs.setup_from_ptau(r1cs, jptau.read_ptau(_fixture(PTAU7))) == \
        _fixture(CIRCUITS[0] + ".zkey")


if __name__ == "__main__":
    os.makedirs(FIXTURES, exist_ok=True)
    for name, data in {PTAU7: ptau7_bytes(), **fixture_files()}.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        print(name, len(data))
