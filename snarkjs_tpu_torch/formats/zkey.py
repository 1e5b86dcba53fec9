""".zkey proving-key files, the Groth16 part (port of snarkjs_tpu/formats/zkey.py).

Layouts mirror reference src/zkey_utils.js (Groth16 sections :20-46, header
readers :229-339).  Points are LEM (LE Montgomery); Fr "P4"/coefficient
values are stored double-Montgomery (value*R^2, src/zkey_utils.js:174-179) so
that a Montgomery product against a plain-form witness lands in Montgomery
form directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..curves.host_curve import CurveParams, curve_from_q
from . import points
from .binfile import BinFile

GROTH16_PROTOCOL_ID = 1


@dataclass
class Groth16Zkey:
    curve: CurveParams
    n8q: int
    n8r: int
    n_vars: int
    n_public: int
    domain_size: int
    power: int
    # verification key points (host affine ints)
    vk_alpha_1: tuple
    vk_beta_1: tuple
    vk_beta_2: tuple
    vk_gamma_2: tuple
    vk_delta_1: tuple
    vk_delta_2: tuple
    # device-layout sections
    ic: list                      # host G1 affine ints, nPublic+1 entries
    coeffs: dict                  # {"m","c","s" int32 arrays, "val" (NL,nc)}
    a_points: tuple               # (x, y, inf) limb arrays, nVars
    b1_points: tuple
    b2_points: tuple              # ((x0,x1),(y0,y1),inf)
    c_points: tuple               # nVars - nPublic - 1 entries
    h_points: tuple               # domainSize entries
    raw: BinFile | None = None


def read_header(bf: BinFile):
    r = bf.reader(1)
    protocol_id = r.u32()
    return protocol_id


def read_groth16_zkey(path_or_bytes) -> Groth16Zkey:
    bf = (BinFile.load(path_or_bytes, "zkey")
          if isinstance(path_or_bytes, str) else BinFile(path_or_bytes, "zkey"))
    if read_header(bf) != GROTH16_PROTOCOL_ID:
        raise ValueError("not a groth16 zkey")
    r = bf.reader(2)
    n8q = r.u32()
    q = r.big(n8q)
    n8r = r.u32()
    rr = r.big(n8r)
    cv = curve_from_q(q)
    assert cv.fr.p == rr
    n_vars = r.u32()
    n_public = r.u32()
    domain_size = r.u32()
    power = domain_size.bit_length() - 1

    fq = cv.fq

    def g1():
        return points.g1_lem_to_ints(fq, r.raw(2 * n8q), 1)[0]

    def g2():
        return points.g2_lem_to_ints(fq, r.raw(4 * n8q), 1)[0]

    vk_alpha_1 = g1()
    vk_beta_1 = g1()
    vk_beta_2 = g2()
    vk_gamma_2 = g2()
    vk_delta_1 = g1()
    vk_delta_2 = g2()

    ic = points.g1_lem_to_ints(fq, bf.read_section(3), n_public + 1)

    # section 4: coefficients
    cr = bf.reader(4)
    n_coefs = cr.u32()
    s_coef = 12 + n8r
    raw = cr.raw(n_coefs * s_coef)
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(n_coefs, s_coef)
    head = arr[:, :12].copy().view("<u4").reshape(n_coefs, 3)
    vals = points.frs_from_bytes(cv.fr, np.ascontiguousarray(arr[:, 12:]).tobytes(),
                                 n_coefs)
    coeffs = {
        "m": head[:, 0].astype(np.int32),
        "c": head[:, 1].astype(np.int32),
        "s": head[:, 2].astype(np.int32),
        "val": vals,  # value * R^2 (mod r) — see module docstring
    }
    # the prover's segment sum (protocols/groth16.py) keeps the JAX
    # package's bound of < 2^16 terms per (matrix, constraint), so the top
    # carry of a sum stays one 16-bit limb
    if n_coefs:
        per_seg = np.bincount(
            coeffs["c"] * 2 + coeffs["m"],
            minlength=1)
        if per_seg.max() >= (1 << 16):
            raise ValueError(
                f"constraint with {per_seg.max()} coefficients exceeds the "
                "2^16 segment-sum bound")

    a_points = points.g1_lem_from_bytes(fq, bf.read_section(5), n_vars)
    b1_points = points.g1_lem_from_bytes(fq, bf.read_section(6), n_vars)
    b2_points = points.g2_lem_from_bytes(fq, bf.read_section(7), n_vars)
    c_points = points.g1_lem_from_bytes(fq, bf.read_section(8),
                                        n_vars - n_public - 1)
    h_points = points.g1_lem_from_bytes(fq, bf.read_section(9), domain_size)

    return Groth16Zkey(
        curve=cv, n8q=n8q, n8r=n8r, n_vars=n_vars, n_public=n_public,
        domain_size=domain_size, power=power,
        vk_alpha_1=vk_alpha_1, vk_beta_1=vk_beta_1, vk_beta_2=vk_beta_2,
        vk_gamma_2=vk_gamma_2, vk_delta_1=vk_delta_1, vk_delta_2=vk_delta_2,
        ic=ic, coeffs=coeffs, a_points=a_points, b1_points=b1_points,
        b2_points=b2_points, c_points=c_points, h_points=h_points, raw=bf,
    )
