"""Typed proof container (port of snarkjs_tpu/protocols/proof.py;
reference src/proof.js:20-96).  Host only.

The provers/verifiers exchange plain JSON-shaped dicts (the reference's
`toObject` form: decimal strings, G1 as [x, y, "1"]); this container
gives library users the typed counterpart: named point/evaluation access,
int coordinates, round-trip to the JSON form, and curve tagging.

The FFLONK layout reads its points and evaluations at the top level of the
object, as the JAX package's does; the FFLONK prover nests them under
"polynomials" and "evaluations", so `from_obj` of such a proof finds
neither.  The layout is kept as the JAX package has it, so the two agree.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def _g1_from_obj(o):
    x, y, z = int(o[0]), int(o[1]), int(o[2])
    return None if z == 0 else (x, y)


def _g1_to_obj(p):
    return ["0", "1", "0"] if p is None else [str(p[0]), str(p[1]), "1"]


def _g2_from_obj(o):
    z = (int(o[2][0]), int(o[2][1]))
    if z == (0, 0):
        return None
    return ((int(o[0][0]), int(o[0][1])), (int(o[1][0]), int(o[1][1])))


def _g2_to_obj(p):
    if p is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [[str(p[0][0]), str(p[0][1])],
            [str(p[1][0]), str(p[1][1])], ["1", "0"]]


# which JSON keys hold G1 / G2 points / Fr evaluations, per protocol
_LAYOUT = {
    "groth16": {"g1": ("pi_a", "pi_c"), "g2": ("pi_b",), "fr": ()},
    "plonk": {"g1": ("A", "B", "C", "Z", "T1", "T2", "T3", "Wxi", "Wxiw"),
              "g2": (),
              "fr": ("eval_a", "eval_b", "eval_c", "eval_s1", "eval_s2",
                     "eval_zw")},
    "fflonk": {"g1": ("C1", "C2", "W1", "W2"), "g2": (),
               "fr": ("ql", "qr", "qm", "qo", "qc", "s1", "s2", "s3", "a",
                      "b", "c", "z", "zw", "t1w", "t2w", "inv")},
}


@dataclass
class Proof:
    protocol: str
    curve: str
    points: dict = field(default_factory=dict)        # name -> affine ints
    evaluations: dict = field(default_factory=dict)   # name -> int

    @classmethod
    def from_obj(cls, obj: dict) -> "Proof":
        proto = obj["protocol"]
        lay = _LAYOUT[proto]
        pts = {k: _g1_from_obj(obj[k]) for k in lay["g1"] if k in obj}
        pts.update({k: _g2_from_obj(obj[k]) for k in lay["g2"] if k in obj})
        evs = {k: int(obj[k]) for k in lay["fr"] if k in obj}
        return cls(protocol=proto, curve=obj.get("curve", "bn128"),
                   points=pts, evaluations=evs)

    def to_obj(self) -> dict:
        lay = _LAYOUT[self.protocol]
        out = {}
        for k, v in self.points.items():
            out[k] = _g2_to_obj(v) if k in lay["g2"] else _g1_to_obj(v)
        for k, v in self.evaluations.items():
            out[k] = str(v)
        out["protocol"] = self.protocol
        out["curve"] = self.curve
        return out
