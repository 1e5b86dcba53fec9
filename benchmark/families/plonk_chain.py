"""PLONK proving of a squaring chain: the key writer, the input maker, the
call of the port's entry point and the reference hook, for the PLONK
configurations (configs/plonk_<curve>.py).

The circuit is groth16_chain's, lowered as snarkjs's `plonk setup` lowers
it (src/plonk_setup.js processConstraints): a gate for the public input
(a = w1, ql = 1), then for constraint i a multiplication gate a = b = w(i+1),
c = w(i+2), qm = 1, qo = -1; no additions, k1 = 2 and k2 = 3 as snarkjs
picks them, sigma from the wire ids (each wire's slots in one cycle, visited
gate by gate, a then b then c), n_vars = constraints + 2, and the domain the
least power of two above the gates.  The key is written here, vectorized, on
the reference's field and NTT: each selector's, sigma's and the public
input's Lagrange polynomial's coefficients and values on the 4n domain.
The SRS (n + 6 points) is tiled from `g1_table` consecutive multiples
(k0 + i) G1, k0 from the seed, so the verification key's points are closed
forms; x_2 is a multiple of G2.  The port's `PlonkZkey` holds it.  A pool of
witnesses, each the chain from its own x0, is drawn from the seed; each
request draws its own b[1..11] from its bits.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.families.groth16_chain import chain, point_table
from benchmark.families.limbs import limbs, tiled
from benchmark.harness import traffic as traffic_mod
from benchmark.reference import plonk as ref
from benchmark.reference.curve import CURVES, Group
from benchmark.reference.ntt import ntt

K1, K2 = 2, 3


def gates(constraints: int):
    """The wire ids (a, b, c) of each gate: the public input's, then one a
    constraint."""
    i = np.arange(1, constraints + 1, dtype=np.int32)
    return (np.concatenate([[1], i]).astype(np.int32), np.concatenate([[0], i]).astype(np.int32),
            np.concatenate([[0], i + 1]).astype(np.int32))


def sigma_slots(maps, n: int) -> np.ndarray:
    """For each of the 3n wire slots (a block, b block, c block of n), the
    slot it points to: the slots of one wire form a cycle in the order
    snarkjs visits them (gate by gate, a, b, c), each pointing at the one
    visited before it and the first at the last.  Unused rows carry wire 0."""
    vid = np.zeros(3 * n, dtype=np.int64)
    for col, m in enumerate(maps):
        vid[col:3 * len(m):3] = m
    q = np.arange(3 * n)
    pos = (q % 3) * n + q // 3
    order = np.argsort(vid, kind="stable")
    sv = vid[order]
    starts = np.flatnonzero(np.r_[True, sv[1:] != sv[:-1]])
    src = np.arange(3 * n) - 1
    src[starts] = np.r_[starts[1:], 3 * n] - 1
    out = np.empty(3 * n, dtype=np.int64)
    out[pos[order]] = pos[order[src]]
    return out


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.int32).cpu().numpy().view(np.uint32)


class Cell:
    """One cell's inputs on both sides, the timed call and its check."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from snarkjs_tpu_torch.curves import host_curve
        from snarkjs_tpu_torch.formats.wtns import Witness
        from snarkjs_tpu_torch.formats.zkey import PlonkZkey

        self.device = dev = torch.device(device)
        cv = CURVES[config["curve"]]
        self.curve = cv
        rng = traffic_mod.rng(seed, "inputs")
        nc, n_public = mix["constraints"], mix["public_inputs"]
        if n_public != 1:
            raise ValueError("the squaring chain has one public input")
        n_gates = nc + n_public
        power = max((n_gates - 1).bit_length(), 3)
        n = 1 << power
        n_vars = nc + 2
        period = config["g1_table"]
        k0 = rng.randrange(1, cv.r - period)
        tau = rng.randrange(1, cv.r)
        F = ref.field(cv)
        p = F.p

        maps = gates(nc)
        one, minus_one = F.mconst(1, dev), F.mconst(p - 1, dev)
        vals = {name: torch.zeros((F.L, n), dtype=torch.int64, device=dev)
                for name in ("qm", "ql", "qr", "qo", "qc")}
        vals["ql"][:, :1] = one
        vals["qm"][:, 1:n_gates] = one
        vals["qo"][:, 1:n_gates] = minus_one
        w = F.powers(F.w[power], n, dev)
        slots = torch.cat([w, F.scale(w, K1), F.scale(w, K2)], dim=1)
        sig = slots[:, torch.from_numpy(sigma_slots(maps, n)).to(dev)]
        for j, name in enumerate(("s1", "s2", "s3")):
            vals[name] = sig[:, j * n:(j + 1) * n]
        lag = torch.zeros((F.L, n), dtype=torch.int64, device=dev)
        lag[:, :1] = one
        vals["lagrange"] = lag
        del slots, sig, w

        g1 = Group(cv, 1)
        p4, coefs, vk = {}, {}, {}
        for name, v in vals.items():
            c = ntt(F, v, inverse=True)
            e = ntt(F, ref.pad(c, 4 * n)) if bool(c.any()) else torch.zeros(
                (F.L, 4 * n), dtype=torch.int64, device=dev)
            p4[name] = (_u32(c), _u32(e))
            if name in ref.POLYS:
                coefs[name] = p4[name][0]
                s0, s1 = F.weighted_sums(F.from_mont(c), period)
                vk[name] = g1.mul(cv.g1, k0 * s0 + s1)
        del vals

        t = point_table(g1, k0, period)
        mont = lambda vs: limbs([v * (1 << (8 * cv.fq_bytes)) % cv.q for v in vs], cv.fq_bytes)
        m = n + 6
        vk_pts = dict(zip(ref.VK, (vk[name] for name in ref.POLYS)))
        self.key = ref.Key(curve=cv.name, domain=n, n_public=n_public, k1=K1, k2=K2, k0=k0,
                           period=period, maps=maps, coefs=coefs, vk=vk_pts)
        empty = np.zeros((F.L, 0), dtype=np.uint32)
        self.zkey = PlonkZkey(
            curve=host_curve.get_curve(cv.name), n8q=cv.fq_bytes, n8r=cv.fr_bytes,
            n_vars=n_vars, n_public=n_public, domain_size=n, power=power, n_additions=0,
            n_constraints=n_gates, k1=K1, k2=K2,
            qm=vk["qm"], ql=vk["ql"], qr=vk["qr"], qo=vk["qo"], qc=vk["qc"],
            s1=vk["s1"], s2=vk["s2"], s3=vk["s3"], x_2=Group(cv, 2).mul(cv.g2, tau),
            additions={"a": np.zeros(0, np.int32), "b": np.zeros(0, np.int32),
                       "af": empty, "bf": empty},
            a_map=maps[0], b_map=maps[1], c_map=maps[2],
            qm_p4=p4["qm"], ql_p4=p4["ql"], qr_p4=p4["qr"], qo_p4=p4["qo"], qc_p4=p4["qc"],
            sigma1_p4=p4["s1"], sigma2_p4=p4["s2"], sigma3_p4=p4["s3"],
            lagrange=np.concatenate(p4["lagrange"], axis=1),
            ptau=(tiled(mont([P[0] for P in t]), m), tiled(mont([P[1] for P in t]), m),
                  np.zeros(m, dtype=bool)))
        self.x0 = [rng.randrange(2, cv.r) for _ in range(mix["pool"])]
        self.wit_limbs = [chain(F, x, n_vars, dev) for x in self.x0]
        self.witnesses = [Witness(n8=cv.fr_bytes, q=cv.r, n=n_vars, values=v)
                          for v in self.wit_limbs]
        self.tables = None
        self.wires = {}    # the reference's work on the witness alone, by pool item

    # ------------------------------------------------------------ the call
    def blinders(self, request) -> list:
        rng = traffic_mod.rng(request.bits, "blinders")
        return [0] + [rng.randrange(1, self.curve.r) for _ in range(11)]

    def op(self, request, logger=None):
        from snarkjs_tpu_torch.protocols import plonk

        return plonk.prove(self.zkey, self.witnesses[request.item], b=self.blinders(request),
                           device=self.device, logger=logger)

    @staticmethod
    def stage_of(line: str) -> str:
        """plonk.prove's logger lines: "Round N: ..." and "Multiexp X"."""
        head, _, rest = line.partition(" ")
        if head == "Round":
            return "round" + rest.split(":")[0].strip()
        if head == "Multiexp":
            return "msm_" + rest.strip()
        return head.lower()

    @staticmethod
    def counters() -> dict:
        from snarkjs_tpu_torch.fields import fcuda

        return {"field_launches": sum(fcuda.LAUNCHES.values())}

    def work(self) -> dict:
        """The sizes the metric readers count work from: the domain, the
        field sizes, and the nine commitments' lengths."""
        n, cv = self.key.domain, self.curve
        lengths = {"A": n + 2, "B": n + 2, "C": n + 2, "Z": n + 3, "T1": n + 1, "T2": n + 1,
                   "T3": n + 6, "Wxi": n + 6, "Wxiw": n + 3}
        return {"domain": n, "fr_bytes": cv.fr_bytes, "fq_bytes": cv.fq_bytes,
                "scalar_bits": cv.r.bit_length(),
                "msms": [{"name": k, "points": v, "group": 1} for k, v in lengths.items()]}

    def free(self):
        """Drop the program's state (the key's device copies go with it)."""
        self.zkey = None
        self.witnesses = None

    # ------------------------------------------------------- the reference
    def reference(self, requests, blind: bool = True) -> list:
        """The reference's proof and publics for each request (blind=False:
        b = 0, the control that leaves the blinding out)."""
        if self.tables is None:
            self.tables = ref.prepare(self.key, self.device)
        out = []
        for req in requests:
            if req.item not in self.wires:
                self.wires[req.item] = ref.wires(self.key, self.tables, self.wit_limbs[req.item])
            b = self.blinders(req) if blind else [0] * 12
            out.append(ref.prove(self.key, self.tables, self.wires[req.item], b))
        return out

    @staticmethod
    def wrong(output, want: dict) -> int:
        """How many of the nine points, the six evaluations and the publics
        differ (or do not parse)."""
        got = parse(output)
        return sum(got.get(k, "missing") != want[k]
                   for k in ref.POINTS + ref.EVALS + ("publics",))


def parse(output) -> dict:
    """(proof JSON, publics) as plonk.prove returns them -> points and ints;
    a part that does not parse is left out (and so counts as wrong)."""
    proof, publics = output
    got = {}
    for k in ref.POINTS:
        try:
            x, y, z = (int(v) for v in proof[k])
            got[k] = None if z == 0 else (x, y) if z == 1 else "not affine"
        except (KeyError, TypeError, ValueError):
            pass
    for k in ref.EVALS:
        try:
            got[k] = int(proof[k])
        except (KeyError, TypeError, ValueError):
            pass
    try:
        got["publics"] = [int(v) for v in publics]
    except (TypeError, ValueError):
        pass
    return got


def as_output(want: dict) -> tuple:
    """A reference answer in the form plonk.prove returns it."""
    g1 = lambda P: ["0", "1", "0"] if P is None else [str(P[0]), str(P[1]), "1"]
    proof = {k: g1(want[k]) for k in ref.POINTS}
    proof.update({k: str(want[k]) for k in ref.EVALS})
    proof.update(protocol="plonk", curve="bn128")
    return proof, [str(v) for v in want["publics"]]


def unblinded(make):
    """Wrap a configuration's `make`: the cell's op answers with the
    reference's proof for b = 0."""

    def make_control(config, mix, seed, device):
        cell = make(config, mix, seed, device)
        cell.op = lambda request, logger=None: as_output(cell.reference([request], blind=False)[0])
        return cell

    return make_control
