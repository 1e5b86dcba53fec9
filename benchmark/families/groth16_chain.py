"""Groth16 proving of a squaring chain: the input maker, the call of the
port's entry point and the reference hook, shared by the Groth16
configurations (configs/groth16_<curve>.py).

The circuit: constraint i says w[i+1] * w[i+1] = w[i+2] (coefficients 1),
one public input w[1] = x0, n_vars = constraints + 2; the domain is the
least power of two above constraints + public inputs.  Each of the five
point sections (A, B1, B2, C, H) is tiled from a table of its own, the
consecutive multiples (k0 + i) G with a k0 of its own: `g1_table` of G1,
`g2_table` of G2 (K-scan's complete formulas do the same work whatever the
points are).  So bases taken from the wrong section, or an index moved by
anything but a multiple of the table's length, change the proof; the
lengths are prime, so no power-of-two move is a multiple.  The
verification-key points are multiples of the generators; every k0 and
every multiple are drawn from the seed.  A pool of witnesses, each the
chain from its own x0, is drawn from the seed too.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import traffic as traffic_mod
from benchmark.reference import groth16 as ref
from benchmark.reference.curve import CURVES, Group
from benchmark.reference.field import Field

CHAIN_BLOCKS = 8192   # chains squared side by side when a witness is made
SECTIONS = ("a", "b1", "b2", "c", "h")   # the key's point sections; b2 is on G2


def _limbs(vals, nbytes: int) -> np.ndarray:
    """ints -> (nbytes / 2, len) uint32 16-bit limbs, little-endian."""
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in vals)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(vals), nbytes // 2)
    return np.ascontiguousarray(u16.T).astype(np.uint32)


def _tiled(t, n: int):
    if isinstance(t, tuple):
        return tuple(_tiled(x, n) for x in t)
    return np.ascontiguousarray(np.tile(t, (1, -(-n // t.shape[1])))[:, :n])


def point_table(group: Group, k0: int, count: int) -> list:
    """(k0 + i) G for i < count, affine."""
    out = [group.mul(group.gen, k0)]
    for _ in range(count - 1):
        out.append(group.add(out[-1], group.gen))
    return out


def chain(F: Field, x0: int, n_vars: int, device, blocks: int = CHAIN_BLOCKS) -> np.ndarray:
    """The witness [1, x0, x0^2, x0^4, ...] (w[i+1] = w[i]^2) as (L, n_vars)
    plain limbs, made on `device`: the chain after w[0] is cut into blocks
    whose first values x0^(2^(b k)) come from the host, and all blocks square
    their way along together."""
    k = -(-(n_vars - 1) // blocks)
    blocks = -(-(n_vars - 1) // k)
    starts = [pow(x0, pow(2, b * k, F.p - 1), F.p) for b in range(blocks)]
    cur = F.to_mont(F.from_ints(starts, device))
    steps = [cur]
    for _ in range(k - 1):
        cur = F.mont_mul(cur, cur)
        steps.append(cur)
    w = F.from_mont(torch.stack(steps, dim=2).reshape(F.L, -1)[:, :n_vars - 1])
    one = F.const(1, device)
    return torch.cat([one, w], dim=1).cpu().numpy().astype(np.uint32)


class Cell:
    """One cell's inputs on both sides, the timed call and its check."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from snarkjs_tpu_torch.curves import host_curve
        from snarkjs_tpu_torch.formats.wtns import Witness
        from snarkjs_tpu_torch.formats.zkey import Groth16Zkey

        self.device = torch.device(device)
        cv = CURVES[config["curve"]]
        self.curve = cv
        rng = traffic_mod.rng(seed, "inputs")
        nc, n_public = mix["constraints"], mix["public_inputs"]
        if n_public != 1:
            raise ValueError("the squaring chain has one public input")
        n_vars = nc + 2
        domain = 1 << (nc + n_public).bit_length()
        p1, p2 = config["g1_table"], config["g2_table"]
        period = {name: p2 if name == "b2" else p1 for name in SECTIONS}
        k0 = {name: rng.randrange(1, cv.r - period[name]) for name in SECTIONS}
        alpha, beta, gamma, delta = (rng.randrange(1, cv.r) for _ in range(4))
        ic = [rng.randrange(1, cv.r) for _ in range(n_public + 1)]

        i = np.arange(nc, dtype=np.int32)
        pub = np.arange(n_public + 1, dtype=np.int32)
        m = np.concatenate([np.tile([0, 1], nc), np.zeros(n_public + 1)]).astype(np.int32)
        c = np.concatenate([np.repeat(i, 2), nc + pub]).astype(np.int32)
        s = np.concatenate([np.repeat(i + 1, 2), pub]).astype(np.int32)
        r2 = (1 << (16 * cv.fr_bytes)) % cv.r
        val = np.tile(_limbs([r2], cv.fr_bytes), (1, len(m)))   # coefficient 1, stored as R^2
        self.key = ref.Key(curve=cv.name, n_vars=n_vars, n_public=n_public, domain=domain,
                           k0=k0, g1_period=p1, g2_period=p2, alpha=alpha, beta=beta,
                           delta=delta, m=m, c=c, s=s, val=val)

        g1, g2 = Group(cv, 1), Group(cv, 2)
        mont = lambda vs: _limbs([v * (1 << (8 * cv.fq_bytes)) % cv.q for v in vs], cv.fq_bytes)

        def g1_section(name, n):
            t = point_table(g1, k0[name], p1)
            return (_tiled(mont([P[0] for P in t]), n), _tiled(mont([P[1] for P in t]), n),
                    np.zeros(n, dtype=bool))

        t2 = point_table(g2, k0["b2"], p2)
        g2x = (mont([P[0][0] for P in t2]), mont([P[0][1] for P in t2]))
        g2y = (mont([P[1][0] for P in t2]), mont([P[1][1] for P in t2]))
        self.zkey = Groth16Zkey(
            curve=host_curve.get_curve(cv.name), n8q=cv.fq_bytes, n8r=cv.fr_bytes,
            n_vars=n_vars, n_public=n_public, domain_size=domain,
            power=domain.bit_length() - 1,
            vk_alpha_1=g1.mul(cv.g1, alpha), vk_beta_1=g1.mul(cv.g1, beta),
            vk_beta_2=g2.mul(cv.g2, beta), vk_gamma_2=g2.mul(cv.g2, gamma),
            vk_delta_1=g1.mul(cv.g1, delta), vk_delta_2=g2.mul(cv.g2, delta),
            ic=[g1.mul(cv.g1, k) for k in ic], coeffs={"m": m, "c": c, "s": s, "val": val},
            a_points=g1_section("a", n_vars), b1_points=g1_section("b1", n_vars),
            b2_points=(_tiled(g2x, n_vars), _tiled(g2y, n_vars), np.zeros(n_vars, dtype=bool)),
            c_points=g1_section("c", n_vars - n_public - 1), h_points=g1_section("h", domain))
        self.x0 = [rng.randrange(2, cv.r) for _ in range(mix["pool"])]
        fr = Field(cv.r, cv.fr_bytes)
        self.wit_limbs = [chain(fr, x, n_vars, self.device) for x in self.x0]
        self.witnesses = [Witness(n8=cv.fr_bytes, q=cv.r, n=n_vars, values=v)
                          for v in self.wit_limbs]
        self.terms = {}    # the reference's MSM scalars, by pool item

    # ------------------------------------------------------------ the call
    def blinders(self, request) -> tuple:
        rng = traffic_mod.rng(request.bits, "blinders")
        return rng.randrange(1, self.curve.r), rng.randrange(1, self.curve.r)

    def op(self, request, logger=None):
        from snarkjs_tpu_torch.protocols import groth16

        r, s = self.blinders(request)
        return groth16.prove(self.zkey, self.witnesses[request.item], r=r, s=s,
                             device=self.device, logger=logger)

    @staticmethod
    def stage_of(line: str) -> str:
        """groth16.prove's logger lines: "QAP: ..." and "Multiexp X"."""
        head, _, rest = line.partition(" ")
        if head.startswith("QAP"):
            return "qap"
        if head == "Multiexp":
            return "msm_" + rest.strip()
        return head.lower()

    @staticmethod
    def counters() -> dict:
        from snarkjs_tpu_torch.fields import fcuda

        return {"field_launches": sum(fcuda.LAUNCHES.values())}

    def work(self) -> dict:
        """The sizes the metric readers count work from."""
        k, cv = self.key, self.curve
        n_c = k.n_vars - k.n_public - 1
        return {"domain": k.domain, "n_vars": k.n_vars, "coefficients": len(k.m),
                "fr_bytes": cv.fr_bytes, "fq_bytes": cv.fq_bytes,
                "scalar_bits": cv.r.bit_length(),
                "msms": [{"name": "A", "points": k.n_vars, "group": 1},
                         {"name": "B1", "points": k.n_vars, "group": 1},
                         {"name": "B2", "points": k.n_vars, "group": 2},
                         {"name": "C", "points": n_c, "group": 1},
                         {"name": "H", "points": k.domain, "group": 1}]}

    def free(self):
        """Drop the program's state (the key's device copies go with it)."""
        self.zkey = None
        self.witnesses = None

    # ------------------------------------------------------- the reference
    def reference(self, requests, blind: bool = True) -> list:
        """The reference's proof and publics for each request (blind=False:
        r = s = 0, the control that leaves the blinding out)."""
        out = []
        for req in requests:
            if req.item not in self.terms:
                self.terms[req.item] = ref.terms(self.key, self.wit_limbs[req.item], self.device)
            r, s = self.blinders(req) if blind else (0, 0)
            want = ref.proof(self.key, self.terms[req.item], r, s)
            want["publics"] = [self.x0[req.item]]
            out.append(want)
        return out

    def wrong(self, output, want: dict) -> int:
        """How many of pi_a, pi_b, pi_c and the publics differ."""
        got = parse(output)
        return sum(got.get(k, "missing") != want[k] for k in ("pi_a", "pi_b", "pi_c", "publics"))


def _g1(o):
    x, y, z = (int(v) for v in o)
    if z == 0:
        return None
    return (x, y) if z == 1 else "not affine"


def _g2(o):
    (x0, x1), (y0, y1), (z0, z1) = ((int(a), int(b)) for a, b in o)
    if (z0, z1) == (0, 0):
        return None
    return ((x0, x1), (y0, y1)) if (z0, z1) == (1, 0) else "not affine"


def parse(output) -> dict:
    """(proof JSON, publics) as groth16.prove returns them -> points and
    ints; a part that does not parse is left out (and so counts as wrong)."""
    proof, publics = output
    got = {}
    for k, f in (("pi_a", _g1), ("pi_b", _g2), ("pi_c", _g1)):
        try:
            got[k] = f(proof[k])
        except (KeyError, TypeError, ValueError):
            pass
    try:
        got["publics"] = [int(v) for v in publics]
    except (TypeError, ValueError):
        pass
    return got
