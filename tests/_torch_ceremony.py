"""Shared by tests/test_torch_ceremony*.py: the powers-of-tau chain run the
same way through either package, and the stored JAX outputs.

The JAX outputs live in snarkjs_tpu_torch/fixtures/ceremony_jax.json (SHA-256
of every file the chain writes, the response and partial hashes, the verify
results, and the module cases whose JAX device routes compile XLA programs)
and ceremony_p4_bn128.ptau (the bn128 power-4 file after the beacon, the
input of the forced-route preparePhase2 case).  `python -m
tests._torch_ceremony` rewrites both from the JAX package; the slow-marked
`test_ceremony_fixtures_regenerate` checks them.
"""

import hashlib
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
JSON_FIXTURE = os.path.join(FIXTURES, "ceremony_jax.json")
PTAU_FIXTURE = os.path.join(FIXTURES, "ceremony_p4_bn128.ptau")

CASES = {"bn128_p4": ("BN254", 4), "bls12381_p3": ("BLS12_381", 3)}
SEED_CONTRIB = [0x1111, 0x2222, 0x3333, 0x4444, 5, 6, 7, 8]
SEED_RESPONSE = [0xA1, 0xB2, 0xC3, 0xD4, 0xE5, 0xF6, 0x17, 0x28]
BEACON = bytes.fromhex("0123456789abcdef0123456789abcdef0123456789abcdef0123456789abcdef")
VERIFY_SEED = 7
# module cases (bn128): apply-key above the host cutover, the group iNTT,
# verify's MSMs
AK_FIRST, AK_INC = 7, 0x1F2E3D4C5B6A79880123456789ABCDEF
AK_G1, AK_G2 = 127, 65
MSM_G1, MSM_G2 = 100, 65


def sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def tamper_swap(ptau_mod, pt, sz):
    """A copy of pt with tauG1 points 1 and 2 swapped."""
    bad = ptau_mod.read_ptau(pt.tobytes())
    s2 = bytearray(bad.sections[2])
    s2[sz:2 * sz], s2[2 * sz:3 * sz] = s2[2 * sz:3 * sz], s2[sz:2 * sz]
    bad.sections[2] = bytes(s2)
    return bad


def flip_point_byte(response: bytes, n8: int) -> bytes:
    """A response with one byte of its third compressed tauG1 point's x
    flipped (64 bytes of previous hash come first)."""
    out = bytearray(response)
    out[64 + 2 * n8 + n8 // 2] ^= 0x01
    return bytes(out)


def run_chain(ops, ptau_mod, chacha, cv, power, kw=None):
    """new -> contribute -> export_challenge -> challenge_contribute ->
    import_response -> beacon -> prepare_phase2 -> truncate -> convert ->
    export_json, with verify of the beacon file, the prepared file and a
    tampered copy, and the import of a tampered response.  `kw` goes to the
    port's entry points (device="cpu").  Returns (outputs, files)."""
    kw = kw or {}
    out, files = {}, {}
    a = ops.new_accumulator(cv, power)
    files["new"] = a.tobytes()
    c1, rh1 = ops.contribute(a, name="first", rng=chacha(SEED_CONTRIB), **kw)
    files["contributed"] = c1.tobytes()
    out["response_hash_1"] = rh1.hex()
    ch = ops.export_challenge(c1, **kw)
    files["challenge"] = ch
    resp = ops.challenge_contribute(cv, ch, rng=chacha(SEED_RESPONSE), **kw)
    files["response"] = resp
    c2 = ops.import_response(c1, resp, name="second", **kw)
    files["imported"] = c2.tobytes()
    try:
        bad = ops.import_response(c1, flip_point_byte(resp, cv.fq.n8), name="bad", **kw)
        out["tampered_response"] = ("verify " + str(ops.verify(
            bad, rng=np.random.default_rng(VERIFY_SEED), **kw)))
    except ValueError as e:
        out["tampered_response"] = "raised " + str(e)
    c3, rh3 = ops.beacon(c2, BEACON, 10, name="beacon", **kw)
    files["beacon"] = c3.tobytes()
    out["response_hash_3"] = rh3.hex()
    out["contributions"] = [{"partial_hash": c.partial_hash.hex(),
                             "next_challenge": c.next_challenge.hex(),
                             "response_hash": c.response_hash(cv).hex()}
                            for c in c3.contributions]
    out["verify_beacon"] = ops.verify(c3, rng=np.random.default_rng(VERIFY_SEED), **kw)
    prep = ops.prepare_phase2(c3, **kw)
    files["prepared"] = prep.tobytes()
    out["verify_prepared"] = ops.verify(prep, rng=np.random.default_rng(VERIFY_SEED), **kw)
    out["verify_tampered"] = ops.verify(tamper_swap(ptau_mod, prep, 2 * cv.fq.n8),
                                        rng=np.random.default_rng(VERIFY_SEED), **kw)
    tr = ops.truncate(prep, power - 1)
    files["truncated"] = tr.tobytes()
    conv = ops.convert(tr, **kw)
    files["converted"] = conv.tobytes()
    files["json"] = json.dumps(ops.export_json(conv), sort_keys=True).encode()
    out["sha256"] = {k: sha(v) for k, v in files.items()}
    return out, files


def module_inputs(cv, points_mod, hc):
    """LEM inputs of the module cases: multiples of the generators, the
    last G1 point the point at infinity."""
    fq = cv.fq
    g1 = [hc.g1_mul(cv, cv.g1, 3 + 5 * i) for i in range(AK_G1 - 1)] + [None]
    g2 = [hc.g2_mul(cv, cv.g2, 5 + 7 * i) for i in range(AK_G2)]
    return points_mod.g1_lem_from_ints(fq, g1), points_mod.g2_lem_from_ints(fq, g2)


def msm_scalars(cv, n):
    rng = np.random.default_rng(n)
    return [int.from_bytes(rng.bytes(32), "little") % cv.fr.p for _ in range(n)]


def jax_outputs():
    """Every stored JAX output (runs the JAX package; minutes of XLA
    compiles for the module cases' device routes)."""
    from snarkjs_tpu.ceremony import ptau_ops as J
    from snarkjs_tpu.curves import host_curve as jhc
    from snarkjs_tpu.formats import points as jp
    from snarkjs_tpu.formats import ptau as jptau
    from snarkjs_tpu.utils.chacha import ChaCha

    res, beacon_file = {}, None
    for case, (curve, power) in CASES.items():
        out, files = run_chain(J, jptau, ChaCha, getattr(jhc, curve), power)
        res[case] = out
        if case == "bn128_p4":
            beacon_file = files["beacon"]
    cv = jhc.BN254
    lem1, lem2 = module_inputs(cv, jp, jhc)
    mods = {
        "apply_key_g1": sha(J.apply_key_g1(cv, lem1, AK_G1, AK_FIRST, AK_INC)),
        "apply_key_g2": sha(J.apply_key_g2(cv, lem2, AK_G2, AK_FIRST, AK_INC)),
        "group_lagrange_g1_k2": sha(J.group_lagrange_lem(cv, lem1, 4, False,
                                                          force_device=True)),
        "group_lagrange_g2_k1": sha(J.group_lagrange_lem(cv, lem2, 2, True,
                                                          force_device=True)),
        "msm_g1": repr(J._msm_lem(cv, lem1[:MSM_G1 * 64], msm_scalars(cv, MSM_G1), False)),
        "msm_g2": repr(J._msm_lem(cv, lem2[:MSM_G2 * 128], msm_scalars(cv, MSM_G2), True)),
    }
    res["modules"] = mods
    return res, beacon_file


def stored():
    with open(JSON_FIXTURE) as f:
        return json.load(f)


def stored_beacon_file() -> bytes:
    with open(PTAU_FIXTURE, "rb") as f:
        return f.read()


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    res, beacon_file = jax_outputs()
    with open(JSON_FIXTURE, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)
        f.write("\n")
    with open(PTAU_FIXTURE, "wb") as f:
        f.write(beacon_file)
    print(json.dumps(res, indent=1)[:2000])
