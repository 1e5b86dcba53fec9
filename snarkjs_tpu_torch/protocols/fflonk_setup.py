"""FFLONK circuit-specific setup (port of snarkjs_tpu/protocols/fflonk_setup.py;
reference src/fflonk_setup.js).

Shares the r1cs -> plonkish lowering with the PLONK setup (gate column order
[a, b, c, qm, ql, qr, qo, qc], `plonk_setup.process_constraints`).  What
differs from PLONK:

  * the power covers nConstraints + 2 blinding rows, at least 3
    (FF_T_POL_DEG_MIN, fflonk_setup.js:124);
  * sigma: rows in [nConstraints, n-2) use wire 0; the last two rows carry
    identity values outside every permutation cycle (fflonk_setup.js:345-358);
  * the zkey embeds the monomial SRS (9n + 18 G1 points, .ptau section 2) and
    the commitment C0 to the 8 preprocessed polynomials interleaved with
    degree stride 8 (cpolynomial.js:53-73).

The P4 blocks go through the port's NTT on the card (K-mm-norm from 2^12),
the C0 commitment through `MSMContext.run` (K-scan), and the SRS of
`setup_from_secrets` through the batched double-and-add of
`groth16_setup._points_from_scalars` (K-field).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as devmod
from ..curves import host_curve as hc
from ..curves import msm as msm_mod
from ..fields import ftorch
from ..formats import points as pcodec
from ..formats import zkey as zkey_fmt
from ..formats.binfile import BinFileWriter, SectionWriter
from ..formats.r1cs import R1cs
from .groth16_setup import _points_from_scalars
from .plonk_setup import K1, K2, _p4_blocks, process_constraints

# w3 generator and the hardcoded cubic root of w[28] (fflonk_setup.js:510-537)
_W3_GEN = 31624
_ORDER_R_SUB1_BN254 = 3648040478639879203707734290876212514758060733402672390616367364429301415936
_WR_ROOT_BN254 = 467799165886069610036046866799264026481344299079011762026774533774345988080


def fflonk_roots(fr, power: int):
    """(w3, w4, w8, wr) for the circuit power (bn254 constants,
    fflonk_setup.js:510-537)."""
    p = fr.p
    w3 = pow(_W3_GEN, _ORDER_R_SUB1_BN254 // 3, p)
    wr = pow(_WR_ROOT_BN254, 1 << (28 - power), p)
    return w3, fr.w[2], fr.w[3], wr


def _build_sigma_fflonk(fr, con, domain):
    """Sigma slot values (plain ints) with the two-row identity tail."""
    p = fr.p
    n = domain
    w = fr.w[n.bit_length() - 1]

    ws = np.empty(n, dtype=object)
    wi = 1
    for i in range(n):
        ws[i] = wi
        wi = wi * w % p
    val_at = np.concatenate([ws, [x * K1 % p for x in ws],
                             [x * K2 % p for x in ws]])

    n_vis = n - 2  # rows in the permutation
    vid = np.zeros(3 * n_vis, dtype=np.int64)
    m = min(len(con), n_vis)
    if m:
        vid[:3 * m] = np.asarray([g[:3] for g in con[:m]], dtype=np.int64).reshape(-1)
    q = np.arange(3 * n_vis)
    pos = (q % 3) * n + q // 3

    order = np.argsort(vid, kind="stable")
    sv = vid[order]
    starts = np.flatnonzero(np.r_[True, sv[1:] != sv[:-1]])
    ends = np.r_[starts[1:], len(sv)] - 1
    src = np.arange(len(sv)) - 1
    src[starts] = ends                      # cyclic shift within each run
    sigma = np.empty(3 * n, dtype=object)
    sigma[pos[order]] = val_at[pos[order[src]]]
    for i in (n - 2, n - 1):                # identity tail rows
        for blk in range(3):
            sigma[blk * n + i] = val_at[blk * n + i]
    return sigma


def combine_polys(frctx, polys, m: int):
    """CPolynomial.getPolynomial: C(X) = sum_i X^i P_i(X^m) by interleaving
    coefficients (cpolynomial.js:53-73).  Each input is zero-padded to the
    longest; a missing one (None, or fewer than m) is zero."""
    ref = next(P for P in polys if P is not None)
    n = max(P.shape[1] for P in polys if P is not None)
    zero = torch.zeros((frctx.nl, n), dtype=ref.dtype, device=ref.device)
    full = [zero if P is None else torch.nn.functional.pad(P, (0, n - P.shape[1]))
            for P in polys]
    full += [zero] * (m - len(full))
    return torch.stack(full, dim=2).reshape(frctx.nl, n * m)


def _domain(n_con: int) -> int:
    return 1 << max(3, (n_con + 1).bit_length())


def setup_from_srs(r1cs: R1cs, srs_lem: bytes, x_2, logger=None, device=None) -> bytes:
    """FFLONK zkey bytes from a monomial G1 SRS (LEM bytes, at least 9n + 18
    points) and X_2 = tau*G2 (reference fflonk_setup.js writeZkeyFile).
    device: None means the card ("cuda"); raises without one."""
    device = devmod.resolve(device)
    cv = hc.BN254 if r1cs.prime == hc.BN254.fr.p else hc.BLS12_381
    if r1cs.prime != cv.fr.p:
        raise ValueError("unknown curve for r1cs prime")
    if cv is not hc.BN254:
        raise NotImplementedError("fflonk root constants are bn254-only "
                                  "(as in the reference)")
    log = logger.debug if logger else (lambda msg: None)
    log("plonkish lowering")
    return _write_fflonk_zkey(cv, r1cs, process_constraints(cv.fr, r1cs), srs_lem,
                              x_2, log, device)


def _write_fflonk_zkey(cv, r1cs: R1cs, lowered, srs_lem: bytes, x_2, log,
                       device) -> bytes:
    """The zkey bytes of `setup_from_srs`, from the plonkish lowering
    `lowered` = (constraints, additions, n_vars) of `process_constraints`."""
    fr, fq = cv.fr, cv.fq
    p = fr.p
    frctx = ftorch.get_ctx(fr.name)
    n_public = r1cs.n_public
    con, adds, n_vars = lowered
    domain = _domain(len(con))
    cir_power = domain.bit_length() - 1
    n_srs = domain * 9 + 18
    if len(srs_lem) < n_srs * 2 * fq.n8:
        raise ValueError("Powers of Tau is not big enough for this circuit "
                         "size. Section 2 too small.")
    srs_lem = srs_lem[:n_srs * 2 * fq.n8]
    w3, w4, w8, wr = fflonk_roots(fr, cir_power)

    w = BinFileWriter("zkey", 1)
    s1 = SectionWriter()
    s1.u32(zkey_fmt.FFLONK_PROTOCOL_ID)
    w.add_section(1, s1.tobytes())

    # additions (sec 3)
    sa = SectionWriter()
    for a, b, afv, bfv in adds:
        sa.u32(a)
        sa.u32(b)
        sa.big(fr.to_mont(afv), fr.n8)
        sa.big(fr.to_mont(bfv), fr.n8)
    w.add_section(zkey_fmt.FF_ADDITIONS, sa.tobytes())

    # witness maps (secs 4-6)
    for col in range(3):
        w.add_section(zkey_fmt.FF_A_MAP + col,
                      np.asarray([g[col] for g in con], dtype="<u4").tobytes())

    # Q polynomials (secs 7-11) in FFLONK order QL, QR, QM, QO, QC
    log("P4 blocks")
    polys = {}
    q_sections = [("QL", 4, zkey_fmt.FF_QL), ("QR", 5, zkey_fmt.FF_QR),
                  ("QM", 3, zkey_fmt.FF_QM), ("QO", 6, zkey_fmt.FF_QO),
                  ("QC", 7, zkey_fmt.FF_QC)]
    for name, col, sec in q_sections:
        mont = ftorch.np_from_ints(fr, [fr.to_mont(g[col] % p) for g in con])
        cb, eb, coefs = _p4_blocks(fr, frctx, mont, domain, device)
        w.add_section(sec, cb + eb)
        polys[name] = coefs

    # sigma (secs 12-14)
    sigma = _build_sigma_fflonk(fr, con, domain)
    for blk in range(3):
        vals = sigma[blk * domain:(blk + 1) * domain]
        mont = ftorch.np_from_ints(fr, [fr.to_mont(int(v)) for v in vals])
        cb, eb, coefs = _p4_blocks(fr, frctx, mont, domain, device)
        w.add_section(zkey_fmt.FF_SIGMA1 + blk, cb + eb)
        polys[f"S{blk + 1}"] = coefs

    # Lagrange (sec 15)
    lag_payload = b""
    for i in range(max(n_public, 1)):
        mont = np.zeros((fr.nl, domain), dtype=np.uint32)
        mont[:, i:i + 1] = ftorch.np_from_ints(fr, [fr.to_mont(1)])
        cb, eb, _ = _p4_blocks(fr, frctx, mont, domain, device)
        lag_payload += cb + eb
    w.add_section(zkey_fmt.FF_LAGRANGE, lag_payload)

    # PTau (sec 16)
    w.add_section(zkey_fmt.FF_PTAU, srs_lem)

    # C0 (sec 17): QL, QR, QO, QM, QC, S1, S2, S3 interleaved with stride 8,
    # and its commitment over the first 8n SRS points
    log("C0 commitment")
    c0 = combine_polys(frctx, [ftorch.to_tensor(polys[k], device) for k in
                               ("QL", "QR", "QO", "QM", "QC", "S1", "S2", "S3")], 8)
    w.add_section(zkey_fmt.FF_C0, pcodec.frs_to_bytes(fr, ftorch.to_numpy(c0)))
    px, py, pinf = pcodec.g1_lem_from_bytes(fq, srs_lem, 8 * domain)
    g1m = msm_mod.MSMContext(ftorch.get_ctx(fq.name), fq, extension=1)
    res = g1m.run(ftorch.to_tensor(px, device), ftorch.to_tensor(py, device),
                  torch.from_numpy(pinf).to(device), ftorch.from_mont(frctx, c0))
    commit_c0 = msm_mod.host_jac_to_affine(fq, res, 1)

    # header (sec 2)
    log("header")
    h = SectionWriter()
    h.u32(fq.n8)
    h.big(fq.p, fq.n8)
    h.u32(fr.n8)
    h.big(fr.p, fr.n8)
    h.u32(n_vars)
    h.u32(n_public)
    h.u32(domain)
    h.u32(len(adds))
    h.u32(len(con))
    for v in (K1, K2, w3, w4, w8, wr):
        h.big(fr.to_mont(v), fr.n8)
    h.raw(pcodec.g2_lem_from_ints(fq, [x_2]))
    h.raw(pcodec.g1_lem_from_ints(fq, [commit_c0]))
    w.add_section(zkey_fmt.FF_HEADER, h.tobytes())
    return w.tobytes()


def setup_from_ptau(r1cs: R1cs, ptau, logger=None, device=None) -> bytes:
    """`fflonk setup` from a prepared .ptau (reference fflonk_setup.js:36):
    the SRS is the .ptau's section 2, X_2 its second tauG2 point.  device:
    None means the card ("cuda")."""
    if 12 not in ptau.sections:
        raise ValueError("Powers of Tau is not well prepared. "
                         "Section 12 missing.")
    fq = ptau.curve.fq
    x_2 = pcodec.g2_lem_to_ints(fq, ptau.sections[3][4 * fq.n8:8 * fq.n8], 1)[0]
    return setup_from_srs(r1cs, bytes(ptau.sections[2]), x_2, logger=logger,
                          device=device)


def setup_from_secrets(r1cs: R1cs, tau: int, logger=None, device=None) -> bytes:
    """The zkey of a one-participant ceremony with secret `tau`: the SRS
    [tau^i]G1, i < 9n + 18, from tau powers taken on the host by running
    products and turned into points by the batched double-and-add on
    `device` (None: the card)."""
    device = devmod.resolve(device)
    cv = hc.BN254
    if r1cs.prime != cv.fr.p:
        raise NotImplementedError("fflonk root constants are bn254-only "
                                  "(as in the reference)")
    fr, fq = cv.fr, cv.fq
    log = logger.debug if logger else (lambda msg: None)
    log("plonkish lowering")
    lowered = process_constraints(fr, r1cs)
    log("tau powers on the host")
    taui, t = [], 1
    for _ in range(_domain(len(lowered[0])) * 9 + 18):
        taui.append(t)
        t = t * tau % fr.p
    log("SRS points")
    srs_lem = pcodec.g1_lem_to_bytes(fq, *_points_from_scalars(cv, taui, device=device))
    return _write_fflonk_zkey(cv, r1cs, lowered, srs_lem, hc.g2_mul(cv, cv.g2, tau),
                              log, device)
