"""snarkjs_tpu_torch's powers-of-tau ceremony (`ceremony/ptau_ops.py`,
`ceremony/keypair.py`, `utils/blake2b.py`, `utils/chacha.py`,
`utils/spool.py`, `formats/ptau.py`) against snarkjs_tpu on the CPU.
Tolerance: none; files, hashes and points byte for byte.

The chain new -> contribute -> challenge -> challenge_contribute ->
import_response -> beacon -> prepare_phase2 -> truncate -> convert ->
export_json runs through the port here (bn128 at power 4, bls12-381 at power
3; ChaCha seeds fixed) and is held against the JAX package's run of the same
chain, stored in snarkjs_tpu_torch/fixtures/ (tests/_torch_ceremony.py).
The G1 module cases force the port's device routes (batched on CPU
tensors): apply-key on 127 points, the group iNTT at k = 2, verify's MSM and
Lagrange check.  The G2 cases are in test_torch_ceremony_g2.py, the
preparePhase2 of every block through the batched route in
test_torch_ceremony_phase2.py.
"""

import hashlib

import numpy as np
import pytest

from snarkjs_tpu.ceremony import keypair as jkeypair
from snarkjs_tpu.ceremony import ptau_ops as J
from snarkjs_tpu.curves import host_curve as jhc
from snarkjs_tpu.formats import points as jp
from snarkjs_tpu.formats import ptau as jptau
from snarkjs_tpu.utils.blake2b import Blake2b as JBlake2b
from snarkjs_tpu.utils.chacha import ChaCha as JChaCha
from snarkjs_tpu_torch.ceremony import keypair as tkeypair
from snarkjs_tpu_torch.ceremony import ptau_ops as T
from snarkjs_tpu_torch.curves import host_curve as thc
from snarkjs_tpu_torch.formats import ptau as tptau
from snarkjs_tpu_torch.utils.blake2b import Blake2b as TBlake2b
from snarkjs_tpu_torch.utils.chacha import ChaCha as TChaCha
from snarkjs_tpu_torch.utils.chacha import seed_from_hash_be
from snarkjs_tpu_torch.utils.spool import SpooledOut
from tests import _torch_ceremony as tc
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CPU = {"device": "cpu"}
CHAIN_ITEMS = (["sha256:" + k for k in ("new", "contributed", "challenge", "response",
                                         "imported", "beacon", "prepared", "truncated",
                                         "converted", "json")]
               + ["response_hash_1", "response_hash_3", "contributions",
                  "tampered_response", "verify_beacon", "verify_prepared",
                  "verify_tampered"])

_CHAINS = {}


def _port_chain(case):
    if case not in _CHAINS:
        curve, power = tc.CASES[case]
        _CHAINS[case] = tc.run_chain(T, tptau, TChaCha, getattr(thc, curve), power, CPU)
    return _CHAINS[case]


@pytest.mark.parametrize("item", CHAIN_ITEMS)
@pytest.mark.parametrize("case", sorted(tc.CASES))
def test_chain_equals_jax(case, item):
    """Every file, hash and verify result of the chain, against the JAX run
    stored from the same seeds."""
    got, _ = _port_chain(case)
    want = tc.stored()[case]
    if item.startswith("sha256:"):
        k = item.split(":")[1]
        assert got["sha256"][k] == want["sha256"][k], k
    else:
        assert got[item] == want[item], item


def test_chain_beacon_file_is_the_stored_one():
    """The port's bn128 file after the beacon is the stored JAX file (the
    input of the preparePhase2 case)."""
    _, files = _port_chain("bn128_p4")
    assert files["beacon"] == tc.stored_beacon_file()


# ------------------------------------------------------------ BLAKE2b

@pytest.mark.parametrize("n", [0, 127, 128, 129, 10 ** 5])
def test_blake2b_midstate_matches_jax(n):
    """to_partial bytes, the resumed digest and the digest itself against the
    JAX class (and hashlib), with the input in three uneven updates."""
    data = np.random.default_rng(n).bytes(n)
    a, b = TBlake2b(64), JBlake2b(64)
    for lo, hi in ((0, n // 3), (n // 3, n // 3 + 1), (n // 3 + 1, n)):
        a.update(data[lo:hi])
        b.update(data[lo:hi])
    assert a.to_partial() == b.to_partial()
    assert len(a.to_partial()) == 216
    assert a.digest() == b.digest() == hashlib.blake2b(data, digest_size=64).digest()
    tail = b"public key bytes" * 9
    assert (TBlake2b.from_partial(b.to_partial()).update(tail).digest()
            == JBlake2b.from_partial(a.to_partial()).update(tail).digest()
            == hashlib.blake2b(data + tail, digest_size=64).digest())


def test_blake2b_block_boundaries_match_jax():
    """Many update sizes around the 128-byte block, the state compared after
    each (a full buffer stays pending until more input comes)."""
    rng = np.random.default_rng(3)
    a, b = TBlake2b(32), JBlake2b(32)
    for size in [1, 127, 128, 256, 255, 129, 0, 384, 1000, 128, 5]:
        chunk = rng.bytes(size)
        a.update(chunk)
        b.update(chunk)
        assert a.to_partial() == b.to_partial(), size
        assert a.digest() == b.digest(), size


def test_blake2b_takes_memoryviews():
    data = bytes(range(256)) * 40
    assert (TBlake2b(64).update(memoryview(data)[100:]).digest()
            == hashlib.blake2b(data[100:], digest_size=64).digest())


# ------------------------------------------------------------ ChaCha, keys

def test_chacha_matches_jax():
    a, b = TChaCha([1, 2, 3, 4, 5, 6, 7, 0xFFFFFFFF]), JChaCha([1, 2, 3, 4, 5, 6, 7, 0xFFFFFFFF])
    assert [a.next_u32() for _ in range(50)] == [b.next_u32() for _ in range(50)]
    assert [a.next_u64() for _ in range(50)] == [b.next_u64() for _ in range(50)]
    assert [a.next_bool() for _ in range(50)] == [b.next_bool() for _ in range(50)]
    digest = hashlib.sha512(b"x").digest()
    assert seed_from_hash_be(digest) == T._seed_be(digest) == J._seed_be(digest)


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_ptau_key_matches_jax(curve):
    """create_ptau_key (private keys, G1 points, hash-to-G2 points) and
    create_delta_key on one ChaCha stream."""
    tcv, jcv = getattr(thc, curve), getattr(jhc, curve)
    challenge = hashlib.blake2b(curve.encode(), digest_size=64).digest()
    assert (tkeypair.create_ptau_key(tcv, challenge, TChaCha([9] * 8))
            == jkeypair.create_ptau_key(jcv, challenge, JChaCha([9] * 8)))
    assert (tkeypair.create_delta_key(tcv, challenge, TChaCha([4] * 8))
            == jkeypair.create_delta_key(jcv, challenge, JChaCha([4] * 8)))


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_sqrt_and_cofactors_match_jax(curve):
    tcv, jcv = getattr(thc, curve), getattr(jhc, curve)
    p = tcv.fq.p
    for a in (0, 1, 2, 3, 5, p - 1, 12345678901234567890):
        assert tkeypair._fq_sqrt(tcv.fq, a) == jkeypair._fq_sqrt(jcv.fq, a)
        for b in (0, 1, 7):
            assert tkeypair._f2_sqrt(tcv.fq, (a, b)) == jkeypair._f2_sqrt(jcv.fq, (a, b))
    assert tkeypair.g1_cofactor(tcv) == jkeypair.g1_cofactor(jcv)
    assert tkeypair.g2_cofactor(tcv) == jkeypair.g2_cofactor(jcv)


def test_beacon_randomness_matches_jax():
    beacon = T.parse_beacon_hash("0x" + "ab" * 32)
    assert beacon == J.parse_beacon_hash("ab" * 32)
    a, b = T.rng_from_beacon(beacon, 5), J.rng_from_beacon(beacon, 5)
    assert [a.next_u32() for _ in range(20)] == [b.next_u32() for _ in range(20)]
    with pytest.raises(ValueError):
        T.parse_beacon_hash("0xabc")
    r = T.random_rng("entropy")
    assert isinstance(r.next_u64(), int)


# ------------------------------------------------------------ .ptau format

@pytest.mark.parametrize("power", [0, 1, 4, 9])
def test_first_challenge_hash_matches_jax(power):
    for curve in ("BN254", "BLS12_381"):
        assert (tptau.first_challenge_hash(getattr(thc, curve), power)
                == jptau.first_challenge_hash(getattr(jhc, curve), power))


def test_ptau_file_helpers_match_jax(tmp_path):
    """save streams the bytes of tobytes (the JAX save's too), counts,
    n_tau_g1, last_challenge, each record's response hash, format_hash and
    the compressed point codecs."""
    data = tc.stored_beacon_file()
    tp, jp_ = tptau.read_ptau(data), jptau.read_ptau(data)
    path = str(tmp_path / "a.ptau")
    tp.save(path)
    jpath = str(tmp_path / "b.ptau")
    jp_.save(jpath)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read() == data
    assert tp.counts() == jp_.counts() and tp.n_tau_g1 == jp_.n_tau_g1 == 31
    assert tp.last_challenge() == jp_.last_challenge()
    fresh = T.new_accumulator(thc.BN254, 3)
    assert fresh.last_challenge() == jptau.first_challenge_hash(jhc.BN254, 3)
    for a, b in zip(tp.contributions, jp_.contributions):
        assert a.response_hash(tp.curve) == b.response_hash(jp_.curve)
    assert tptau.format_hash(data[:64], "cap") == jptau.format_hash(data[:64], "cap")
    cv = jhc.BN254
    for P in (None, cv.g1, jhc.g1_neg(cv, cv.g1)):
        assert tptau.g1_compressed_be(cv.fq, P) == jptau.g1_compressed_be(cv.fq, P)
    for P in (None, cv.g2, jhc.g2_neg(cv, cv.g2)):
        assert tptau.g2_compressed_be(cv.fq, P) == jptau.g2_compressed_be(cv.fq, P)


def test_spooled_out_spills_past_its_threshold():
    small = SpooledOut(threshold=100)
    small.write(b"a" * 60)
    assert small.finish() == b"a" * 60
    big = SpooledOut(threshold=100)
    for i in range(5):
        big.write(bytes([i]) * 60)
    view = big.finish()
    assert isinstance(view, memoryview)
    assert bytes(view) == b"".join(bytes([i]) * 60 for i in range(5))


def test_contribute_refuses_a_reduced_file_and_bad_beacons():
    pt = T.truncate(tptau.read_ptau(tc.stored_beacon_file()), 2)
    with pytest.raises(ValueError, match="reduced"):
        T.contribute(pt, rng=TChaCha([1] * 8), **CPU)
    with pytest.raises(ValueError, match="numIterationsExp"):
        T.beacon(pt, b"\x01" * 32, 0, **CPU)
    with pytest.raises(ValueError, match="Size of the contribution"):
        T.import_response(pt, b"\x00" * 100, **CPU)


# ------------------------------------------------------------ device routes, G1

def test_apply_key_g1_device_route_matches_jax():
    """127 points (one at infinity), above the host cutover of 64: the
    powers by one Montgomery product, the batched double-and-add."""
    lem1, _ = tc.module_inputs(jhc.BN254, jp, jhc)
    out = T.apply_key_g1(thc.BN254, lem1, tc.AK_G1, tc.AK_FIRST, tc.AK_INC, **CPU)
    assert tc.sha(out) == tc.stored()["modules"]["apply_key_g1"]


def test_group_lagrange_g1_device_route_matches_jax():
    """G1 at k = 2 through the batched group iNTT, against the JAX
    force_device=True output."""
    lem1, _ = tc.module_inputs(jhc.BN254, jp, jhc)
    out = T.group_lagrange_lem(thc.BN254, lem1, 4, False, force_device=True, **CPU)
    assert tc.sha(out) == tc.stored()["modules"]["group_lagrange_g1_k2"]
    assert out == J.group_lagrange_lem(jhc.BN254, lem1, 4, False)


def test_group_lagrange_rejects_sizes_past_the_two_adicity():
    with pytest.raises(ValueError, match="k <="):
        T.group_lagrange_lem(thc.BN254, b"", 1 << 29, False, **CPU)
    with pytest.raises(ValueError, match="k <="):
        T.group_lagrange_lem(thc.BN254, b"", 12, False, **CPU)


def test_msm_lem_g1_device_route_matches_jax():
    """verify's MSM through MSMContext.run on 100 points, against the JAX
    device route's result."""
    lem1, _ = tc.module_inputs(jhc.BN254, jp, jhc)
    got = T._msm_lem(thc.BN254, lem1[:tc.MSM_G1 * 64], tc.msm_scalars(thc.BN254, tc.MSM_G1),
                     False, **CPU)
    assert repr(got) == tc.stored()["modules"]["msm_g1"]


def test_verify_lagrange_device_route_matches_jax(monkeypatch):
    """The Lagrange check of section 12 (power 2: blocks of 1 .. 8 points)
    with every MSM on the device route (the Fr NTT of the random vector
    feeding the MSM as limbs): True as in the JAX package, and False for both
    on a tampered section 12."""
    jprep = J.truncate(J.prepare_phase2(jptau.read_ptau(tc.stored_beacon_file())), 2)
    tprep = tptau.read_ptau(jprep.tobytes())
    monkeypatch.setattr(T, "HOST_MAX", 0)
    assert T._verify_lagrange(thc.BN254, tprep, 2, 12, False, np.random.default_rng(3), **CPU)
    assert J._verify_lagrange(jhc.BN254, jprep, 2, 12, False, np.random.default_rng(3))
    sec = bytearray(tprep.sections[12])
    sec[64 * 5:64 * 6], sec[64 * 6:64 * 7] = sec[64 * 6:64 * 7], sec[64 * 5:64 * 6]
    tprep.sections[12] = jprep.sections[12] = bytes(sec)
    assert not T._verify_lagrange(thc.BN254, tprep, 2, 12, False,
                                  np.random.default_rng(3), **CPU)
    assert not J._verify_lagrange(jhc.BN254, jprep, 2, 12, False, np.random.default_rng(3))


def _g1_points(cv, hc):
    pts = [hc.g1_mul(cv, cv.g1, 3 + i) for i in range(20)] + [None]
    return pts + [hc.g1_neg(cv, P) for P in pts[:6]]


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_g1_codecs_match_jax(curve):
    """lem_to_c / c_to_lem / u_to_lem / lem_to_u on both sign flags and the
    point at infinity, as batches, against the JAX host codecs."""
    tcv, jcv = getattr(thc, curve), getattr(jhc, curve)
    pts = _g1_points(jcv, jhc)
    lem = jp.g1_lem_from_ints(jcv.fq, pts)
    n = len(pts)
    c = J.lem_to_c(jcv, lem, n, False)
    assert T.lem_to_c(tcv, lem, n, False, **CPU) == c
    assert {b[0] & 0xC0 for b in (c[i * jcv.fq.n8:] for i in range(n))} == {0, 0x40, 0x80}
    assert T.c_to_lem(tcv, c, n, False, **CPU) == J.c_to_lem(jcv, c, n, False) == lem
    u = J.lem_to_u(jcv, lem, n, False)
    assert T.lem_to_u(tcv, lem, n, False, **CPU) == u
    assert T.u_to_lem(tcv, u, n, False, **CPU) == J.u_to_lem(jcv, u, n, False) == lem


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_g1_decompress_raises_off_the_curve(curve):
    """An x whose x^3 + b is no square raises ValueError, as in the JAX
    package."""
    tcv, jcv = getattr(thc, curve), getattr(jhc, curve)
    p, n8 = jcv.fq.p, jcv.fq.n8
    x = next(x for x in range(2, 200) if pow((x ** 3 + jcv.b) % p, (p - 1) // 2, p) == p - 1)
    c = bytearray(J.lem_to_c(jcv, jp.g1_lem_from_ints(jcv.fq, _g1_points(jcv, jhc)), 27, False))
    c[3 * n8:4 * n8] = x.to_bytes(n8, "big")
    for call in (lambda: J.c_to_lem(jcv, bytes(c), 27, False),
                 lambda: T.c_to_lem(tcv, bytes(c), 27, False, **CPU)):
        with pytest.raises(ValueError, match="not on the curve"):
            call()


@pytest.mark.slow
def test_ceremony_fixtures_regenerate():
    """Marked slow: the JAX chains and the JAX device routes of the module
    cases (XLA compiles, minutes on a CPU)."""
    res, beacon_file = tc.jax_outputs()
    assert res == tc.stored()
    assert beacon_file == tc.stored_beacon_file()
