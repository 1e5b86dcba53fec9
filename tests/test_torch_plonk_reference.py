"""The benchmark's plain PLONK reference (`benchmark/reference/plonk.py`) and
its key writer (`benchmark/families/plonk_chain.py`) against the port and
the JAX package, on the CPU at small domains.

- The family's key equals what the port's `plonk setup` writer
  (`plonk_setup._write_plonk_zkey`, snarkjs's lowering and sigma) gives for
  the same squaring chain and SRS.
- The port's `plonk.prove` equals the reference on seeded chain keys at
  domains 2^5 to 2^8, with fresh seeds and blinders: every commitment,
  evaluation and public.
- The reference equals `snarkjs_tpu.protocols.plonk.prove` on the same key,
  witness and b, which holds it to snarkjs's PLONK apart from the port.
- The reference's Keccak-256 gives the published digests.
- A key changed under the port (sigma2's commitment moved, or the SRS moved
  by one point) gives proofs that `wrong` counts; with sigma2's
  coefficients shifted by one the port refuses to prove.
"""

import os
import random

import numpy as np
import pytest
import torch

from benchmark.families import plonk_chain
from benchmark.harness import spec, traffic
from benchmark.reference import plonk as ref
from benchmark.reference.field import Field
from benchmark.reference.ntt import ntt
from snarkjs_tpu_torch.curves import host_curve as hc
from snarkjs_tpu_torch.formats import points as pcodec
from snarkjs_tpu_torch.formats import r1cs as tr1cs
from snarkjs_tpu_torch.formats import zkey as tzkey
from snarkjs_tpu_torch.protocols import plonk_setup
from snarkjs_tpu_torch.utils import keccak as tkeccak
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = spec.config(ROOT, "plonk_bn128")[1]


def _mix(constraints):
    return {"callers": 1, "pool": 2, "warmup": 0, "constraints": constraints,
            "public_inputs": 1}


def _cell(constraints, seed):
    return plonk_chain.Cell(CONFIG, _mix(constraints), seed, "cpu")


def _requests(constraints, seed, k=2):
    return [r for _, r in zip(range(k), traffic.stream(_mix(constraints), seed))]


# ------------------------------------------------------------------ keccak

@pytest.mark.parametrize("msg,digest", [
    (b"", "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"),
    (b"abc", "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"),
])
def test_keccak_gives_the_published_digests(msg, digest):
    assert ref.keccak256(msg).hex() == digest


@pytest.mark.parametrize("n", [1, 135, 136, 137, 272, 500])
def test_keccak_equals_the_ports_on_every_block_boundary(n):
    msg = random.Random(n).randbytes(n)
    assert ref.keccak256(msg) == tkeccak.keccak256(msg)


# --------------------------------------------------------------- the key

def _chain_r1cs(nc):
    fr = hc.BN254.fr
    m = np.tile(np.array([0, 1, 2], dtype=np.int32), nc)
    c = np.repeat(np.arange(nc, dtype=np.int32), 3)
    s = np.stack([np.arange(1, nc + 1), np.arange(1, nc + 1), np.arange(2, nc + 2)],
                 axis=1).reshape(-1).astype(np.int32)
    vals = np.zeros((fr.nl, 3 * nc), dtype=np.uint32)
    vals[0] = 1
    return tr1cs.R1cs(n8=fr.n8, prime=fr.p, n_wires=nc + 2, n_pub_out=0, n_pub_in=1,
                      n_prv_in=0, n_labels=nc + 2, n_constraints=nc, m=m, c=c, s=s, vals=vals)


@pytest.mark.parametrize("nc", [20, 100])
def test_the_family_key_equals_the_ports_setup_writer(nc):
    """The port's writer lowers the chain's r1cs as snarkjs does and builds
    sigma its own way; given the family's SRS and closed-form commitments,
    its key is the family's, section by section."""
    cell = _cell(nc, 2**36 + nc)
    zk, key = cell.zkey, cell.key
    cv = hc.BN254
    F = ref.field(plonk_chain.CURVES["bn128"])

    def commit(values):
        c = ntt(F, F.to_mont(F.from_ints(values, "cpu")), inverse=True)
        s0, s1 = F.weighted_sums(F.from_mont(c), key.period)
        return hc.g1_mul(cv, cv.g1, (key.k0 * s0 + s1) % cv.fr.p)

    r1cs = _chain_r1cs(nc)
    zbytes = plonk_setup._write_plonk_zkey(
        cv, r1cs, plonk_setup.process_constraints(cv.fr, r1cs), commit,
        pcodec.g1_lem_to_bytes(cv.fq, *zk.ptau), zk.x_2, device="cpu")
    got = tzkey.read_plonk_zkey(zbytes)
    for f in ("n_vars", "n_public", "domain_size", "power", "n_additions", "n_constraints",
              "k1", "k2", "qm", "ql", "qr", "qo", "qc", "s1", "s2", "s3"):
        assert getattr(got, f) == getattr(zk, f), f
    assert got.x_2 == tuple(tuple(v) for v in zk.x_2)
    for f in ("a_map", "b_map", "c_map", "lagrange"):
        assert np.array_equal(getattr(got, f), getattr(zk, f)), f
    for f in ("qm_p4", "ql_p4", "qr_p4", "qo_p4", "qc_p4", "sigma1_p4", "sigma2_p4",
              "sigma3_p4"):
        assert all(np.array_equal(a, b) for a, b in zip(getattr(got, f), getattr(zk, f))), f
    assert all(np.array_equal(a, b) for a, b in zip(got.ptau, zk.ptau))


# ------------------------------------------------------------- the proofs

@pytest.mark.parametrize("nc", [20, 50, 100, 200])
def test_the_reference_equals_the_port(nc):
    """Domains 2^5 .. 2^8: two proofs each, each with its own blinders."""
    seed = random.Random(nc).randrange(2**40)
    cell = _cell(nc, seed)
    assert cell.key.domain == 1 << max(nc.bit_length(), 3)
    reqs = _requests(nc, seed + 1)
    got = [cell.op(r) for r in reqs]
    want = cell.reference(reqs)
    assert [cell.wrong(g, w) for g, w in zip(got, want)] == [0, 0]
    assert want[0]["A"] != want[1]["A"] and want[0]["publics"] == [cell.x0[0]]


def test_the_reference_equals_the_jax_prover():
    from snarkjs_tpu.curves import host_curve as jhc
    from snarkjs_tpu.formats import wtns as jwtns
    from snarkjs_tpu.formats import zkey as jzkey
    from snarkjs_tpu.protocols import plonk as jplonk

    nc, seed = 20, 2**41 + 3
    cell = _cell(nc, seed)
    zk = cell.zkey
    kw = {f: getattr(zk, f) for f in zk.__dataclass_fields__}
    jzk = jzkey.PlonkZkey(**dict(kw, curve=jhc.get_curve("bn128")))
    req = _requests(nc, seed)[0]
    w = cell.witnesses[req.item]
    got = jplonk.prove(jzk, jwtns.Witness(n8=w.n8, q=w.q, n=w.n, values=w.values),
                       b=cell.blinders(req))
    assert cell.wrong(got, cell.reference([req])[0]) == 0


def _move_s2(zk):
    """sigma2's commitment in the verification key moved by G1: every
    challenge changes, so all but A, B, C and the publics differ."""
    zk.s2 = hc.g1_add(zk.curve, zk.s2, zk.curve.g1)


def _shift_srs(zk):
    zk.ptau = tuple(np.roll(a, 1, axis=-1) for a in zk.ptau)


@pytest.mark.parametrize("fault,least", [(_move_s2, 12), (_shift_srs, 9)])
def test_a_key_changed_under_the_port_is_found_wrong(fault, least):
    nc, seed = 20, 2**42 + 9
    cell = _cell(nc, seed)
    req = _requests(nc, seed)[0]
    fault(cell.zkey)
    assert cell.wrong(cell.op(req), cell.reference([req])[0]) >= least


def test_sigma2_shifted_by_one_under_the_port_is_refused():
    """sigma2's coefficients no longer those of its evaluations: the
    opening at xi does not divide, and the port raises (a failed call)."""
    nc, seed = 20, 2**42 + 9
    cell = _cell(nc, seed)
    coefs, evals = cell.zkey.sigma2_p4
    cell.zkey.sigma2_p4 = (np.roll(coefs, 1, axis=1), evals)
    with pytest.raises(RuntimeError):
        cell.op(_requests(nc, seed)[0])


def test_the_reference_refuses_a_witness_that_breaks_a_gate():
    nc, seed = 20, 2**43 + 1
    cell = _cell(nc, seed)
    cell.wit_limbs[0] = cell.wit_limbs[0].copy()
    cell.wit_limbs[0][0, 7] ^= 1
    with pytest.raises(ValueError):
        cell.reference(_requests(nc, seed, 1))


@pytest.mark.parametrize("curve", ["bn128", "bls12381"])
def test_the_references_product_and_powers_equal_the_plain_fields(curve):
    """Fr's product (32-bit digits), sum and difference (carries over 32-bit
    digits), small-integer scaling and table of powers give the limbs of
    `reference.field.Field`'s, on random and edge inputs (0, 1, p - 1, and
    R - 1, which `mod_p` multiplies); `mod_p` gives Python's remainders."""
    cv = plonk_chain.CURVES[curve]
    F, G = ref.field(cv), Field(cv.r, cv.fr_bytes)
    rnd = random.Random(4)
    xs = [0, 1, F.p - 1, F.p - 2] + [rnd.randrange(F.p) for _ in range(500)]
    ys = [F.p - 1, F.p - 1, F.p - 1, 1] + [rnd.randrange(F.p) for _ in range(500)]
    a, b = F.from_ints(xs, "cpu"), F.from_ints(ys, "cpu")
    assert torch.equal(F.mont_mul(a, b), G.mont_mul(a, b))
    top = torch.full((F.L, 3), 0xFFFF, dtype=torch.int64)
    assert torch.equal(F.mont_mul(top, F.const(F.R, "cpu")), G.mont_mul(top, G.const(G.R, "cpu")))
    for v in (2, 3, 12345):
        assert torch.equal(F.scale(a, v), G.mont_mul(a, G.const(v * G.R, "cpu")))
    for op in ("add", "sub"):
        assert torch.equal(getattr(F, op)(a, b), getattr(G, op)(a, b))
        assert torch.equal(getattr(F, op)(b, a), getattr(G, op)(b, a))
    for x, n in ((12345, 1000), (F.w[10], 1024), (pow(F.w[10], -1, F.p), 512)):
        assert torch.equal(F.powers(x, n, "cpu"), G.powers(x, n, "cpu"))
    sums = torch.from_numpy(np.random.default_rng(5).integers(0, 2**36, (F.L, 40)))
    assert F.to_ints(F.mod_p(sums)) == [
        sum(int(v) << (16 * j) for j, v in enumerate(col)) % F.p for col in sums.T]


def test_the_scan_and_the_division_equal_python_integers():
    F = ref.field(plonk_chain.CURVES["bn128"])
    p = F.p
    rnd = random.Random(11)
    for n in (1, 5, 64, 65, 300):
        xs = [rnd.randrange(1, p) for _ in range(n)]
        t = F.to_mont(F.from_ints(xs, "cpu"))
        want, acc = [], 1
        for x in xs:
            acc = acc * x % p
            want.append(acc)
        assert F.to_ints(F.from_mont(ref.scan(F, t))) == want
        back = [1] * (n + 1)
        for i in range(n - 1, -1, -1):
            back[i] = back[i + 1] * xs[i] % p
        assert F.to_ints(F.from_mont(ref.scan(F, t, reverse=True))) == back[:n]
    x = rnd.randrange(p)
    q = [rnd.randrange(p) for _ in range(40)]
    c = [(-x * q[0]) % p] + [(q[i - 1] - x * q[i]) % p for i in range(1, 40)] + [q[39]]
    pw = (F.powers(x, 41, "cpu"), F.powers(pow(x, -1, p), 41, "cpu"))
    got = ref._divide(F, F.to_mont(F.from_ints(c, "cpu")), *pw, "c")
    assert F.to_ints(F.from_mont(got)) == q + [0]
    c[0] = (c[0] + 1) % p
    with pytest.raises(ValueError):
        ref._divide(F, F.to_mont(F.from_ints(c, "cpu")), *pw, "c")
