"""PLONK circuit-specific setup (port of snarkjs_tpu/protocols/plonk_setup.py;
reference src/plonk_setup.js).

r1cs -> plonkish lowering (reference processConstraints, src/plonk_setup.js
:143-302): every r1cs constraint A*B=C becomes either one multiplication gate
(both sides non-constant) or one addition ("sum") gate, with wide linear
combinations split into chained addition gates that introduce fresh internal
wires; each public signal gets a binding row up front.  The sigma permutation
is built over the 3*domainSize wire slots with coset tags (1, k1, k2) and
per-wire cyclic shifts (src/plonk_setup.js:354-422) — vectorized here as a
stable argsort + run-rotation instead of the reference's serial two-pass.

Q/sigma/Lagrange polynomials are emitted as "P4" blocks (n coefficients +
4n-domain evaluations, src/plonk_setup.js:326-333) computed with the port's
NTT on the card (or the CPU when asked); commitments use a same-base
scalar-mul when setting up from a secret tau (test path, equivalent to a
1-participant ceremony).  Setting up from a prepared .ptau waits for the
.ptau codec (ROADMAP A4).

Note the reference's getK1K2 (src/plonk_setup.js:484-504) discards the
Fr.add results, so k1 = 2 and k2 = 3 always; we keep those constants for
byte-compatibility (both lie outside H and k1*H for all practical domains).
"""

from __future__ import annotations

import numpy as np

from .. import device as devmod
from ..curves import host_curve as hc
from ..fields import ftorch
from ..formats import points as pcodec
from ..formats import zkey as zkey_fmt
from ..formats.binfile import BinFileWriter, SectionWriter
from ..formats.r1cs import R1cs
from ..ntt import ntt as nttmod
from .groth16_setup import _points_from_scalars, lagrange_at

K1 = 2
K2 = 3


def process_constraints(fr, r1cs: R1cs):
    """r1cs -> (constraints, additions, n_vars).

    constraints: list of [sl, sr, so, qm, ql, qr, qo, qc] (ints, coefs mod r);
    additions:   list of (a_signal, b_signal, a_factor, b_factor).
    Semantics mirror reference src/plonk_setup.js:143-302.
    """
    p = fr.p
    n_public = r1cs.n_public
    constraints = []
    additions = []
    n_vars = r1cs.n_wires

    # regroup the flat (m, c, s, val) entries into per-constraint LC dicts
    vals = ftorch.np_to_ints(fr, r1cs.vals)
    lcs = [[{}, {}, {}] for _ in range(r1cs.n_constraints)]
    for mi, ci, si, v in zip(r1cs.m, r1cs.c, r1cs.s, vals):
        d = lcs[int(ci)][int(mi)]
        d[int(si)] = (d.get(int(si), 0) + v) % p

    def normalize(lc):
        for s in [s for s, v in lc.items() if v % p == 0]:
            del lc[s]

    def join(lc1, k, lc2):
        res = {}
        for s, v in lc1.items():
            res[s] = k * v % p
        for s, v in lc2.items():
            res[s] = (res.get(s, 0) - v) % p
        normalize(res)
        return res

    def reduce_coefs(lc, max_c):
        nonlocal n_vars
        k = 0
        cs = []
        for s in sorted(lc.keys()):
            if s == 0:
                k = (k + lc[s]) % p
            elif lc[s] % p != 0:
                cs.append([s, lc[s] % p])
        while len(cs) > max_c:
            c1 = cs.pop(0)
            c2 = cs.pop(0)
            so = n_vars
            n_vars += 1
            constraints.append([c1[0], c2[0], so,
                                0, (-c1[1]) % p, (-c2[1]) % p, 1, 0])
            additions.append((c1[0], c2[0], c1[1], c2[1]))
            cs.append([so, 1])
        ss = [c[0] for c in cs] + [0] * (max_c - len(cs))
        coefs = [c[1] for c in cs] + [0] * (max_c - len(cs))
        return k, ss, coefs

    def lc_type(lc):
        k = 0
        n = 0
        for s in list(lc.keys()):
            if lc[s] % p == 0:
                del lc[s]
            elif s == 0:
                k = (k + lc[s]) % p
            else:
                n += 1
        if n > 0:
            return n
        return "k" if k != 0 else "0"

    def add_sum(lc):
        k, ss, coefs = reduce_coefs(lc, 3)
        constraints.append([ss[0], ss[1], ss[2],
                            0, coefs[0], coefs[1], coefs[2], k])

    def add_mul(lca, lcb, lcc):
        ak, as_, ac = reduce_coefs(lca, 1)
        bk, bs_, bc = reduce_coefs(lcb, 1)
        ck, cs_, cc = reduce_coefs(lcc, 1)
        constraints.append([as_[0], bs_[0], cs_[0],
                            ac[0] * bc[0] % p,
                            ac[0] * bk % p,
                            ak * bc[0] % p,
                            (-cc[0]) % p,
                            (ak * bk - ck) % p])

    for s in range(1, n_public + 1):
        constraints.append([s, 0, 0, 0, 1, 0, 0, 0])

    for lca, lcb, lcc in lcs:
        ta, tb = lc_type(lca), lc_type(lcb)
        if ta == "0" or tb == "0":
            normalize(lcc)
            add_sum(lcc)
        elif ta == "k":
            add_sum(join(lcb, lca[0], lcc))
        elif tb == "k":
            add_sum(join(lca, lcb[0], lcc))
        else:
            add_mul(lca, lcb, lcc)

    return constraints, additions, n_vars


def _build_sigma(fr, con, n_vars, domain):
    """sigma values over the 3n slots (plain ints), vectorized run-rotation."""
    p = fr.p
    n = domain
    k = n.bit_length() - 1
    w = fr.w[k]

    # slot values: block 0 -> w^i, block 1 -> k1*w^i, block 2 -> k2*w^i
    ws = np.empty(n, dtype=object)
    wi = 1
    for i in range(n):
        ws[i] = wi
        wi = wi * w % p
    val_at = np.concatenate([ws, [x * K1 % p for x in ws],
                             [x * K2 % p for x in ws]])

    # wire ids in reference visit order q = (i, block)
    vid = np.zeros(3 * n, dtype=np.int64)
    nc = len(con)
    for i in range(nc):
        vid[3 * i + 0] = con[i][0]
        vid[3 * i + 1] = con[i][1]
        vid[3 * i + 2] = con[i][2]
    # padding rows use wire 0 (already zero)
    q = np.arange(3 * n)
    pos = (q % 3) * n + q // 3     # slot position for visit q

    order = np.argsort(vid, kind="stable")
    sv = vid[order]
    starts = np.flatnonzero(np.r_[True, sv[1:] != sv[:-1]])
    ends = np.r_[starts[1:], len(sv)] - 1
    src = np.arange(len(sv)) - 1
    src[starts] = ends                      # cyclic shift within each run
    sigma = np.empty(3 * n, dtype=object)
    sigma[pos[order]] = val_at[pos[order[src]]]
    return sigma


def _p4_blocks(fr, frctx, values_mont, domain, device):
    """values (Montgomery limbs, len <= n) -> (coefs bytes, evals4 bytes,
    coefs limbs)."""
    arr = np.zeros((fr.nl, domain), dtype=np.uint32)
    arr[:, :values_mont.shape[1]] = values_mont
    coefs = nttmod.intt(frctx, ftorch.to_tensor(arr, device))
    ev4 = nttmod.extend_evaluations(frctx, coefs, 4)
    coefs_np = ftorch.to_numpy(coefs)
    return (pcodec.frs_to_bytes(fr, coefs_np),
            pcodec.frs_to_bytes(fr, ftorch.to_numpy(ev4)), coefs_np)


def setup_from_secrets(r1cs: R1cs, tau: int, device=None) -> bytes:
    """PLONK .zkey bytes from a secret tau (1-participant ceremony).

    device: None means the card ("cuda"); raises without one."""
    device = devmod.resolve(device)
    from ..curves.host_curve import BLS12_381, BN254

    cv = BN254 if r1cs.prime == BN254.fr.p else BLS12_381
    if r1cs.prime != cv.fr.p:
        raise ValueError("unknown curve for r1cs prime")
    fr, fq = cv.fr, cv.fq
    p = fr.p

    con, _, _ = process_constraints(fr, r1cs)
    cir_power = max((len(con) - 1).bit_length(), 3)
    domain = 1 << cir_power
    if tau % p == 0 or pow(tau, domain, p) == 1:
        raise ValueError("tau in evaluation domain")

    L_tau = lagrange_at(fr, tau, domain)

    def commit(vals_plain):
        e = 0
        for i, v in enumerate(vals_plain):
            e = (e + v * L_tau[i]) % p
        return hc.g1_mul(cv, cv.g1, e)

    taui, t = [], 1
    for _ in range(domain + 6):
        taui.append(t)
        t = t * tau % p
    pt = _points_from_scalars(cv, taui)
    ptau_lem = pcodec.g1_lem_to_bytes(fq, *pt)
    return _write_plonk_zkey(cv, r1cs, commit, ptau_lem,
                             hc.g2_mul(cv, cv.g2, tau), device)


def setup_from_ptau(r1cs: R1cs, ptau):
    """`plonk setup` from a prepared .ptau (reference src/plonk_setup.js:36)."""
    raise NotImplementedError(
        "plonk setup from a .ptau file needs the .ptau codec and the ceremony "
        "(ROADMAP A4), not ported yet; use setup_from_secrets")


def _write_plonk_zkey(cv, r1cs: R1cs, commit, ptau_lem: bytes,
                      x_2, device=None) -> bytes:
    """The zkey bytes for `r1cs`: `commit(values)` gives the commitment to a
    polynomial from its n domain values (plain ints), `ptau_lem` is the SRS
    section (n + 6 G1 points, LEM bytes), `x_2` = [tau]G2."""
    device = devmod.resolve(device)
    fr, fq = cv.fr, cv.fq
    p = fr.p
    frctx = ftorch.get_ctx(fr.name)
    n_public = r1cs.n_public

    con, adds, n_vars = process_constraints(fr, r1cs)
    cir_power = max((len(con) - 1).bit_length(), 3)
    domain = 1 << cir_power

    w = BinFileWriter("zkey", 1)
    s1 = SectionWriter()
    s1.u32(zkey_fmt.PLONK_PROTOCOL_ID)
    w.add_section(1, s1.tobytes())

    # additions (sec 3)
    sa = SectionWriter()
    for a, b, afv, bfv in adds:
        sa.u32(a)
        sa.u32(b)
        sa.big(fr.to_mont(afv), fr.n8)
        sa.big(fr.to_mont(bfv), fr.n8)
    w.add_section(zkey_fmt.PLONK_ADDITIONS, sa.tobytes())

    # witness maps (secs 4-6)
    for col in range(3):
        sm = SectionWriter()
        for g in con:
            sm.u32(g[col])
        w.add_section(zkey_fmt.PLONK_A_MAP + col, sm.tobytes())

    # Q polynomials (secs 7-11) + commitments
    vk = {}
    q_sections = [("Qm", 3, zkey_fmt.PLONK_QM), ("Ql", 4, zkey_fmt.PLONK_QL),
                  ("Qr", 5, zkey_fmt.PLONK_QR), ("Qo", 6, zkey_fmt.PLONK_QO),
                  ("Qc", 7, zkey_fmt.PLONK_QC)]
    for name, col, sec in q_sections:
        plain = [g[col] % p for g in con]
        mont = ftorch.np_from_ints(fr, [fr.to_mont(v) for v in plain])
        cb, eb, _ = _p4_blocks(fr, frctx, mont, domain, device)
        w.add_section(sec, cb + eb)
        vk[name] = commit(plain + [0] * (domain - len(plain)))

    # sigma (sec 12): three P4 blocks
    sigma = _build_sigma(fr, con, n_vars, domain)
    sig_payload = b""
    for blk in range(3):
        vals = sigma[blk * domain:(blk + 1) * domain]
        mont = ftorch.np_from_ints(fr, [fr.to_mont(int(v)) for v in vals])
        cb, eb, _ = _p4_blocks(fr, frctx, mont, domain, device)
        sig_payload += cb + eb
        vk[f"S{blk + 1}"] = commit(list(vals))
    w.add_section(zkey_fmt.PLONK_SIGMA, sig_payload)

    # Lagrange polys (sec 13)
    lag_payload = b""
    for i in range(max(n_public, 1)):
        mont = np.zeros((fr.nl, domain), dtype=np.uint32)
        mont[:, i:i + 1] = ftorch.np_from_ints(fr, [fr.to_mont(1)])
        cb, eb, _ = _p4_blocks(fr, frctx, mont, domain, device)
        lag_payload += cb + eb
    w.add_section(zkey_fmt.PLONK_LAGRANGE, lag_payload)

    # PTau monomial powers (sec 14): tau^i G for i < n+6
    w.add_section(zkey_fmt.PLONK_PTAU, ptau_lem)

    # header (sec 2)
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
    h.big(fr.to_mont(K1), fr.n8)
    h.big(fr.to_mont(K2), fr.n8)
    h.raw(pcodec.g1_lem_from_ints(
        fq, [vk["Qm"], vk["Ql"], vk["Qr"], vk["Qo"], vk["Qc"],
             vk["S1"], vk["S2"], vk["S3"]]))
    h.raw(pcodec.g2_lem_from_ints(fq, [x_2]))
    w.add_section(zkey_fmt.PLONK_HEADER, h.tobytes())

    return w.tobytes()


def setup_files(r1cs_path: str, zkey_path: str, tau: int, device=None):
    """Read an .r1cs, write the PLONK .zkey for the secret `tau`."""
    from ..formats.r1cs import read_r1cs

    data = setup_from_secrets(read_r1cs(r1cs_path), tau, device)
    with open(zkey_path, "wb") as f:
        f.write(data)
    return data
