"""snarkjs_tpu_torch's Groth16 setup (`protocols/groth16_setup.py`), the
.ptau codec (`formats/ptau.py`) and `ceremony/ptau_ops.lem_to_u` against
snarkjs_tpu on the CPU.  Tolerance: none; keys and files byte for byte.

The test .ptau (bn128, power 4, one above `_tiny_circuit(3)`'s domain of 8)
is made on the host from known secrets: sections 2-6 by host scalar
multiplication, sections 12-15 by the JAX package's
`ptau_ops.prepare_phase2` (host bigints at this size).  It is stored in
snarkjs_tpu_torch/fixtures/ with the JAX package's Groth16
`setup_from_ptau` of `_tiny_circuit(3)` from it, because that JAX run takes
minutes of XLA compiles on a CPU.  `test_setup_fixtures_regenerate` (marked
slow) rebuilds both with the JAX package; `python -m tests.test_torch_groth16`
rewrites them.  So does it for `tiny10_bn128_from_ptau.zkey`, the JAX key
of `_tiny_circuit(10)`, whose domain is the .ptau's own power
(`test_equal_power_fixture_regenerates`, also slow).
"""

import importlib.util
import os

import numpy as np
import pytest

from snarkjs_tpu.ceremony import ptau_ops as jptau_ops
from snarkjs_tpu.curves import host_curve as jhc
from snarkjs_tpu.formats import points as jpc
from snarkjs_tpu.formats import ptau as jptau
from snarkjs_tpu.protocols import groth16_setup as jgs
from snarkjs_tpu_torch.ceremony import ptau_ops as tptau_ops
from snarkjs_tpu_torch.curves import host_curve as thc
from snarkjs_tpu_torch.formats import ptau as tptau
from snarkjs_tpu_torch.formats import r1cs as tr1cs
from snarkjs_tpu_torch.formats.binfile import BinFile
from snarkjs_tpu_torch.protocols import groth16_setup as tgs
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
PTAU = "tiny_p4_bn128.ptau"
PTAU_ZKEY = "tiny3_bn128_from_ptau.zkey"
EQUAL_ZKEY = "tiny10_bn128_from_ptau.zkey"   # domain 16: the .ptau's own power
TAU, ALPHA, BETA = 0x1234567890ABCDEF, 0x55555, 0x77777
POWER = 4


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(ROOT, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    return g


def _circuit():
    """`_tiny_circuit(3)`: domain 8, one public input."""
    return _graft()._tiny_circuit(3, "bn128")


def _torch_r1cs(r1cs):
    return tr1cs.R1cs(**{k: getattr(r1cs, k) for k in r1cs.__dataclass_fields__})


def jax_ptau_bytes(power=POWER, curve="bn128") -> bytes:
    """The prepared .ptau one contribution of (TAU, ALPHA, BETA) leaves,
    built on host bigints with the JAX package."""
    cv = jhc.get_curve(curve)
    fr, fq = cv.fr, cv.fq
    n = 1 << power
    t = [pow(TAU, i, fr.p) for i in range(2 * n - 1)]
    g1 = lambda ks: jpc.g1_lem_from_ints(fq, [jhc.g1_mul(cv, cv.g1, k % fr.p) for k in ks])
    g2 = lambda ks: jpc.g2_lem_from_ints(fq, [jhc.g2_mul(cv, cv.g2, k % fr.p) for k in ks])
    pt = jptau.PtauFile(cv, power, power)
    pt.sections[2] = g1(t)
    pt.sections[3] = g2(t[:n])
    pt.sections[4] = g1([ALPHA * x for x in t[:n]])
    pt.sections[5] = g1([BETA * x for x in t[:n]])
    pt.sections[6] = g2([BETA])
    return jptau_ops.prepare_phase2(pt).tobytes()


def setup_fixture_files() -> dict:
    """The stored setup fixtures as the JAX package makes them."""
    data = jax_ptau_bytes()
    _, r1cs, _ = _circuit()
    return {PTAU: data, PTAU_ZKEY: jgs.setup_from_ptau(r1cs, jptau.read_ptau(data))}


def equal_power_fixture_files() -> dict:
    """The JAX package's Groth16 `setup_from_ptau` of `_tiny_circuit(10)`
    (domain 16, the power of the stored .ptau) from that .ptau."""
    _, r1cs, _ = _graft()._tiny_circuit(10, "bn128")
    return {EQUAL_ZKEY: jgs.setup_from_ptau(r1cs, jptau.read_ptau(_fixture(PTAU)))}


def _fixture(name) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _sections(data) -> dict:
    bf = BinFile(data, "zkey")
    return {sid: bf.read_section(sid) for sid in sorted(bf.sections)}


# ------------------------------------------------------------------- tests

@pytest.mark.slow
def test_setup_fixtures_regenerate():
    """Marked slow: the JAX `setup_from_ptau` compiles one XLA program per
    section shape (minutes on a CPU)."""
    for name, data in setup_fixture_files().items():
        assert _fixture(name) == data, name


def test_setup_from_ptau_bytes_equal_jax():
    """The JAX package's zkey for `_tiny_circuit(3)` from the stored .ptau."""
    _, r1cs, _ = _circuit()
    pt = tptau.read_ptau(_fixture(PTAU))
    assert tgs.setup_from_ptau(_torch_r1cs(r1cs), pt, device="cpu") == _fixture(PTAU_ZKEY)


@pytest.mark.slow
def test_equal_power_fixture_regenerates():
    """Marked slow for the JAX `setup_from_ptau`'s XLA compiles."""
    for name, data in equal_power_fixture_files().items():
        assert _fixture(name) == data, name


def test_setup_from_ptau_at_the_ptau_power_bytes_equal_jax():
    """A circuit whose domain is the .ptau's own power: its H points come from
    the top Lagrange block, the one preparePhase2 makes with a zero point in
    place of tau^(2n - 1).  The port's key equals the JAX package's; sections
    1-8 equal the exact key of `setup_from_secrets`, section 9 (H) does not."""
    _, r1cs, _ = _graft()._tiny_circuit(10, "bn128")
    tr = _torch_r1cs(r1cs)
    assert tgs.domain_size_for(tr) == 1 << POWER
    got = tgs.setup_from_ptau(tr, tptau.read_ptau(_fixture(PTAU)), device="cpu")
    assert got == _fixture(EQUAL_ZKEY)
    a = _sections(got)
    b = _sections(tgs.write_groth16_zkey(
        tgs.setup_from_secrets(tr, TAU, ALPHA, BETA, device="cpu")))
    for sid in range(1, 9):
        assert a[sid] == b[sid], sid
    assert a[9] != b[9]


def test_setup_from_ptau_logger_and_result():
    """`logger` gets one line a step; the key is the same as without it."""
    _, r1cs, _ = _circuit()
    msgs = []
    logger = type("L", (), {"debug": lambda self, m: msgs.append(m)})()
    got = tgs.setup_from_ptau(_torch_r1cs(r1cs), tptau.read_ptau(_fixture(PTAU)),
                              logger=logger, device="cpu")
    assert got == _fixture(PTAU_ZKEY)
    assert msgs == ["Computing A", "Computing B1", "Computing B2", "Computing C and IC",
                    "Circuit hash"]


def test_setup_from_ptau_equals_setup_from_secrets_in_sections_1_to_9():
    """What chip_smoke.py checks at 2^18: the same secrets give the same key;
    section 10 holds the circuit hash in one and zeros in the other."""
    _, r1cs, _ = _circuit()
    tr = _torch_r1cs(r1cs)
    a = _sections(_fixture(PTAU_ZKEY))
    b = _sections(tgs.write_groth16_zkey(
        tgs.setup_from_secrets(tr, TAU, ALPHA, BETA, device="cpu")))
    assert sorted(a) == sorted(b) == list(range(1, 11))
    for sid in range(1, 10):
        assert a[sid] == b[sid], sid
    assert b[10] == bytes(68) and a[10][:64] != bytes(64)


def test_points_from_scalars_device_route_g2():
    """513 scalars take the batched double-and-add (the JAX package's device
    route); the JAX host route over the same scalars, in two calls, gives the
    same points.  Scalars below 2^16 (the steps follow the largest scalar's
    bits), with 0 (infinity) and 1."""
    cvj, cvt = jhc.get_curve("bn128"), thc.get_curve("bn128")
    ks = [0, 1] + [int(k) for k in np.random.default_rng(5).integers(2, 1 << 16, 511)]
    got = tgs._points_from_scalars(cvt, ks, g2=True, device="cpu")
    want = [jgs._points_from_scalars(cvj, part, g2=True) for part in (ks[:512], ks[512:])]
    lem = lambda p: jpc.g2_lem_to_bytes(cvj.fq, *p)
    assert lem(got) == lem(want[0]) + lem(want[1])
    assert got[2][0] and not got[2][1:].any()


def test_lagrange_at_and_domain_match_jax():
    fr = jhc.get_curve("bn128").fr
    for n in (1, 2, 64):
        assert tgs.lagrange_at(thc.get_curve("bn128").fr, TAU, n) == \
            jgs.lagrange_at(fr, TAU, n)
    with pytest.raises(ValueError, match="evaluation domain"):
        tgs.lagrange_at(fr, fr.w[3], 8)
    _, r1cs, _ = _circuit()
    assert tgs.domain_size_for(_torch_r1cs(r1cs)) == jgs.domain_size_for(r1cs) == 8


def test_ptau_codec_matches_jax():
    """read_ptau / tobytes round trip against the JAX codec, with a
    contribution record (points, public key, hashes, name, beacon params)."""
    data = _fixture(PTAU)
    a, b = jptau.read_ptau(data), tptau.read_ptau(data)
    assert (a.power, a.ceremony_power, a.curve.name) == (b.power, b.ceremony_power,
                                                        b.curve.name)
    assert sorted(a.sections) == sorted(b.sections)
    for sid in a.sections:
        assert bytes(a.sections[sid]) == bytes(b.sections[sid]), sid
    assert b.tobytes() == data
    cvj, cvt = a.curve, b.curve
    key = {g: {n: (jhc.g2_mul(cvj, cvj.g2, 3 + i) if n == "g2_spx"
                   else jhc.g1_mul(cvj, cvj.g1, 5 + i))
               for i, n in enumerate(("g1_s", "g1_sx", "g2_spx"))}
           for g in ("tau", "alpha", "beta")}
    fields = dict(tau_g1=jhc.g1_mul(cvj, cvj.g1, 7), tau_g2=jhc.g2_mul(cvj, cvj.g2, 7),
                  alpha_g1=jhc.g1_mul(cvj, cvj.g1, 8), beta_g1=None,
                  beta_g2=jhc.g2_mul(cvj, cvj.g2, 9), key=key,
                  partial_hash=bytes(range(216)), next_challenge=bytes(range(64)),
                  type=jptau.CONTRIB_BEACON, name="port", num_iterations_exp=10,
                  beacon_hash=bytes(range(32)))
    for pt, mod in ((a, jptau), (b, tptau)):
        pt.contributions = [mod.Contribution(**fields)]
    assert b.tobytes() == a.tobytes()
    back = tptau.read_ptau(b.tobytes())
    c = back.contributions[0]
    assert (c.id, c.name, c.type, c.beacon_hash, c.key) == (1, "port", 1, bytes(range(32)),
                                                            key)
    assert tptau.contribution_to_bytes(cvt, c) == jptau.contribution_to_bytes(cvj, c)


def test_lem_to_u_matches_jax():
    for name in ("bn128", "bls12381"):
        cvj, cvt = jhc.get_curve(name), thc.get_curve(name)
        g1 = [jhc.g1_mul(cvj, cvj.g1, k) if k else None for k in (1, 2, 0, 12345)]
        g2 = [jhc.g2_mul(cvj, cvj.g2, k) if k else None for k in (1, 0, 777)]
        for pts, is_g2, enc in ((g1, False, jpc.g1_lem_from_ints),
                                (g2, True, jpc.g2_lem_from_ints)):
            lem = enc(cvj.fq, pts)
            assert tptau_ops.lem_to_u(cvt, lem, len(pts), is_g2, device="cpu") == \
                jptau_ops.lem_to_u(cvj, lem, len(pts), is_g2)


def test_chip_smoke_ptau_builder_matches_prepare_phase2():
    """chip_smoke.py builds its power-19 .ptau from the secrets' scalars (its
    section-12 top block from the tau points and one zero point); at power 4
    it must give the stored file, which prepare_phase2 made."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cv = thc.get_curve("bn128")
    pt = cs.build_ptau(cv, POWER, cs.ptau_scalars(cv, POWER, TAU, ALPHA, BETA), "cpu")
    assert pt.tobytes() == _fixture(PTAU)
