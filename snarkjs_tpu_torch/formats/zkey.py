""".zkey proving-key files, Groth16, PLONK and FFLONK (port of
snarkjs_tpu/formats/zkey.py).

Layouts mirror reference src/zkey_utils.js (Groth16 sections :20-46, header
readers :229-339) and the PLONK and FFLONK setup writers (src/plonk_setup.js,
src/fflonk_setup.js).  Points are LEM (LE Montgomery); Fr "P4"/coefficient
values are stored double-Montgomery (value*R^2, src/zkey_utils.js:174-179) so
that a Montgomery product against a plain-form witness lands in Montgomery
form directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..curves.host_curve import CurveParams, curve_from_q
from . import points
from .binfile import BinFile

GROTH16_PROTOCOL_ID = 1
PLONK_PROTOCOL_ID = 2
FFLONK_PROTOCOL_ID = 10


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


def zkey_protocol(path_or_bytes) -> str:
    """Protocol name from the zkey header (reference src/zkey_utils.js:219)."""
    bf = BinFile(path_or_bytes, "zkey") if isinstance(path_or_bytes, bytes) \
        else BinFile.load(path_or_bytes, "zkey")
    pid = read_header(bf)
    return {GROTH16_PROTOCOL_ID: "groth16", PLONK_PROTOCOL_ID: "plonk",
            FFLONK_PROTOCOL_ID: "fflonk"}[pid]


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


@dataclass
class PlonkZkey:
    curve: CurveParams
    n8q: int
    n8r: int
    n_vars: int
    n_public: int
    domain_size: int
    power: int
    n_additions: int
    n_constraints: int
    k1: int
    k2: int
    qm: tuple
    ql: tuple
    qr: tuple
    qo: tuple
    qc: tuple
    s1: tuple
    s2: tuple
    s3: tuple
    x_2: tuple
    # sections (numpy limb arrays, uint32)
    additions: dict = field(default=None)        # signal indexes + factors
    a_map: np.ndarray = field(default=None)      # (n,) int32 wire ids
    b_map: np.ndarray = field(default=None)
    c_map: np.ndarray = field(default=None)
    qm_p4: tuple = field(default=None)           # (coefs (NL,n), evals (NL,4n))
    ql_p4: tuple = field(default=None)
    qr_p4: tuple = field(default=None)
    qo_p4: tuple = field(default=None)
    qc_p4: tuple = field(default=None)
    sigma1_p4: tuple = field(default=None)
    sigma2_p4: tuple = field(default=None)
    sigma3_p4: tuple = field(default=None)
    lagrange: np.ndarray = field(default=None)   # (nPublic, ...) L_i p4 blocks
    ptau: tuple = field(default=None)            # G1 powers (x, y, inf)


def _read_additions(bf: BinFile, sid: int, n_additions: int, fr) -> dict:
    """The additions section: n_additions x {u32 a, u32 b, Fr af, Fr bf}."""
    n8r = fr.n8
    s_add = 8 + 2 * n8r
    raw = bf.reader(sid).raw(n_additions * s_add)
    if not n_additions:
        return {"a": np.zeros(0, np.int32), "b": np.zeros(0, np.int32),
                "af": np.zeros((fr.nl, 0), np.uint32),
                "bf": np.zeros((fr.nl, 0), np.uint32)}
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(n_additions, s_add)
    head = arr[:, :8].copy().view("<u4").reshape(n_additions, 2)
    af = points.frs_from_bytes(fr, np.ascontiguousarray(arr[:, 8:8 + n8r]).tobytes(), n_additions)
    bfac = points.frs_from_bytes(fr, np.ascontiguousarray(arr[:, 8 + n8r:]).tobytes(), n_additions)
    return {"a": head[:, 0].astype(np.int32), "b": head[:, 1].astype(np.int32),
            "af": af, "bf": bfac}


def _idmap(bf: BinFile, sid: int) -> np.ndarray:
    return np.frombuffer(bf.read_section(sid), dtype="<u4").astype(np.int32)


# PLONK zkey section ids (reference src/plonk_constants.js)
PLONK_HEADER = 2
PLONK_ADDITIONS = 3
PLONK_A_MAP = 4
PLONK_B_MAP = 5
PLONK_C_MAP = 6
PLONK_QM = 7
PLONK_QL = 8
PLONK_QR = 9
PLONK_QO = 10
PLONK_QC = 11
PLONK_SIGMA = 12
PLONK_LAGRANGE = 13
PLONK_PTAU = 14


def read_plonk_zkey(path_or_bytes) -> PlonkZkey:
    bf = (BinFile.load(path_or_bytes, "zkey")
          if isinstance(path_or_bytes, str) else BinFile(path_or_bytes, "zkey"))
    if read_header(bf) != PLONK_PROTOCOL_ID:
        raise ValueError("not a plonk zkey")
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
    n_additions = r.u32()
    n_constraints = r.u32()
    fr, fq = cv.fr, cv.fq
    k1 = fr.from_mont(int.from_bytes(r.raw(n8r), "little"))
    k2 = fr.from_mont(int.from_bytes(r.raw(n8r), "little"))

    def g1():
        return points.g1_lem_to_ints(fq, r.raw(2 * n8q), 1)[0]

    def g2():
        return points.g2_lem_to_ints(fq, r.raw(4 * n8q), 1)[0]

    qm, ql, qr, qo, qc = g1(), g1(), g1(), g1(), g1()
    s1, s2, s3 = g1(), g1(), g1()
    x_2 = g2()

    zk = PlonkZkey(
        curve=cv, n8q=n8q, n8r=n8r, n_vars=n_vars, n_public=n_public,
        domain_size=domain_size, power=power, n_additions=n_additions,
        n_constraints=n_constraints, k1=k1, k2=k2,
        qm=qm, ql=ql, qr=qr, qo=qo, qc=qc, s1=s1, s2=s2, s3=s3, x_2=x_2,
    )

    n = domain_size
    zk.additions = _read_additions(bf, PLONK_ADDITIONS, n_additions, fr)
    zk.a_map = _idmap(bf, PLONK_A_MAP)
    zk.b_map = _idmap(bf, PLONK_B_MAP)
    zk.c_map = _idmap(bf, PLONK_C_MAP)

    def p4(sid, idx=0, off_elems=0):
        data = bf.read_section(sid)
        base = off_elems * n8r
        coefs = points.frs_from_bytes(fr, data[base: base + n * n8r], n)
        evals = points.frs_from_bytes(fr, data[base + n * n8r: base + 5 * n * n8r], 4 * n)
        return coefs, evals

    zk.qm_p4 = p4(PLONK_QM)
    zk.ql_p4 = p4(PLONK_QL)
    zk.qr_p4 = p4(PLONK_QR)
    zk.qo_p4 = p4(PLONK_QO)
    zk.qc_p4 = p4(PLONK_QC)
    zk.sigma1_p4 = p4(PLONK_SIGMA, 0, 0)
    zk.sigma2_p4 = p4(PLONK_SIGMA, 0, 5 * n)
    zk.sigma3_p4 = p4(PLONK_SIGMA, 0, 10 * n)

    lag = bf.read_section(PLONK_LAGRANGE)
    zk.lagrange = points.frs_from_bytes(fr, lag, len(lag) // n8r)

    ptau_data = bf.read_section(PLONK_PTAU)
    n_ptau = len(ptau_data) // (2 * n8q)
    zk.ptau = points.g1_lem_from_bytes(fq, ptau_data, n_ptau)
    return zk


# FFLONK zkey section ids (reference src/fflonk_constants.js:27-44)
FF_HEADER = 2
FF_ADDITIONS = 3
FF_A_MAP = 4
FF_B_MAP = 5
FF_C_MAP = 6
FF_QL = 7
FF_QR = 8
FF_QM = 9
FF_QO = 10
FF_QC = 11
FF_SIGMA1 = 12
FF_SIGMA2 = 13
FF_SIGMA3 = 14
FF_LAGRANGE = 15
FF_PTAU = 16
FF_C0 = 17


@dataclass
class FflonkZkey:
    """Parsed FFLONK proving key (reference src/zkey_utils.js:301-339 header;
    section layout src/fflonk_setup.js writeZkeyFile)."""

    curve: CurveParams
    n8q: int
    n8r: int
    n_vars: int
    n_public: int
    domain_size: int
    power: int
    n_additions: int
    n_constraints: int
    k1: int
    k2: int
    w3: int
    w4: int
    w8: int
    wr: int
    x_2: tuple
    c0: tuple                                    # C0 commitment (host ints)
    additions: dict = field(default=None)
    a_map: np.ndarray = field(default=None)
    b_map: np.ndarray = field(default=None)
    c_map: np.ndarray = field(default=None)
    ql_p4: tuple = field(default=None)
    qr_p4: tuple = field(default=None)
    qm_p4: tuple = field(default=None)
    qo_p4: tuple = field(default=None)
    qc_p4: tuple = field(default=None)
    sigma1_p4: tuple = field(default=None)
    sigma2_p4: tuple = field(default=None)
    sigma3_p4: tuple = field(default=None)
    lagrange: np.ndarray = field(default=None)
    ptau: tuple = field(default=None)            # G1 SRS (x, y, inf), 9n+18
    c0_coefs: np.ndarray = field(default=None)   # (NL, 8n) C0 coefficients


def read_fflonk_zkey(path_or_bytes) -> FflonkZkey:
    bf = (BinFile.load(path_or_bytes, "zkey")
          if isinstance(path_or_bytes, str) else BinFile(path_or_bytes, "zkey"))
    if read_header(bf) != FFLONK_PROTOCOL_ID:
        raise ValueError("not a fflonk zkey")
    r = bf.reader(FF_HEADER)
    n8q = r.u32()
    q = r.big(n8q)
    n8r = r.u32()
    rr = r.big(n8r)
    cv = curve_from_q(q)
    if cv.fr.p != rr:
        raise ValueError("zkey scalar field does not match its curve")
    n_vars = r.u32()
    n_public = r.u32()
    domain_size = r.u32()
    n_additions = r.u32()
    n_constraints = r.u32()
    fr, fq = cv.fr, cv.fq

    def frv():
        return fr.from_mont(int.from_bytes(r.raw(n8r), "little"))

    k1, k2 = frv(), frv()
    w3, w4, w8, wr = frv(), frv(), frv(), frv()
    x_2 = points.g2_lem_to_ints(fq, r.raw(4 * n8q), 1)[0]
    c0 = points.g1_lem_to_ints(fq, r.raw(2 * n8q), 1)[0]

    zk = FflonkZkey(
        curve=cv, n8q=n8q, n8r=n8r, n_vars=n_vars, n_public=n_public,
        domain_size=domain_size, power=domain_size.bit_length() - 1,
        n_additions=n_additions, n_constraints=n_constraints,
        k1=k1, k2=k2, w3=w3, w4=w4, w8=w8, wr=wr, x_2=x_2, c0=c0,
    )

    n = domain_size
    zk.additions = _read_additions(bf, FF_ADDITIONS, n_additions, fr)
    zk.a_map = _idmap(bf, FF_A_MAP)
    zk.b_map = _idmap(bf, FF_B_MAP)
    zk.c_map = _idmap(bf, FF_C_MAP)

    def p4(sid):
        data = bf.read_section(sid)
        coefs = points.frs_from_bytes(fr, data[:n * n8r], n)
        evals = points.frs_from_bytes(fr, data[n * n8r:5 * n * n8r], 4 * n)
        return coefs, evals

    zk.ql_p4 = p4(FF_QL)
    zk.qr_p4 = p4(FF_QR)
    zk.qm_p4 = p4(FF_QM)
    zk.qo_p4 = p4(FF_QO)
    zk.qc_p4 = p4(FF_QC)
    zk.sigma1_p4 = p4(FF_SIGMA1)
    zk.sigma2_p4 = p4(FF_SIGMA2)
    zk.sigma3_p4 = p4(FF_SIGMA3)

    lag = bf.read_section(FF_LAGRANGE)
    zk.lagrange = points.frs_from_bytes(fr, lag, len(lag) // n8r)

    ptau_data = bf.read_section(FF_PTAU)
    zk.ptau = points.g1_lem_from_bytes(fq, ptau_data, len(ptau_data) // (2 * n8q))
    zk.c0_coefs = points.frs_from_bytes(fr, bf.read_section(FF_C0), 8 * n)
    return zk
