"""Groth16 circuit-specific setup (port of snarkjs_tpu/protocols/groth16_setup.py;
reference src/zkey_new.js:36-181).

Two entry points:

* ``setup_from_secrets(r1cs, tau, alpha, beta, ...)`` makes the key from the
  toxic-waste secrets: the Lagrange values L_c(tau) on host bigints (one
  batch inversion), every point section by one batched same-base scalar
  multiplication on the card (`jac.batch_scalar_mul_limbs`, K-field).  It is
  what a one-participant ceremony followed by ``zkey new`` gives.
* ``setup_from_ptau(r1cs, ptau)`` composes the key from a prepared
  powers-of-tau file's Lagrange sections as the reference does (A_s = sum
  coef * [L_c(tau)]G1 per signal, H_i = odd Lagrange points of the 2n
  domain, src/zkey_new.js:182-201), each section as one segmented MSM on the
  card (`msm.segmented_msm`), with the circuit hash (csHash) in section 10.

Facts of the format mirrored from the reference:
  - gamma = delta = 1 in a fresh zkey (vk gamma2/delta2 are the generators,
    src/zkey_new.js:127-129); phase-2 contributions later rescale delta.
  - Extra rows nConstraints+s bind each public signal s: A gets +L_{nCon+s},
    IC gets +beta*L_{nCon+s} (src/zkey_new.js:290-300), and the coefficient
    list gains [0, nCon+s, s, 1].
  - Coefficient section values are stored as value*R^2.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import device as devmod
from ..ceremony.ptau_ops import lem_to_u
from ..curves import host_curve as hc
from ..curves import jac
from ..curves import msm as msm_mod
from ..curves.gops import field_ops
from ..fields import ftorch
from ..formats import points as pcodec
from ..formats import zkey as zkey_fmt
from ..formats.binfile import BinFileWriter, SectionWriter
from ..formats.r1cs import R1cs

HOST_ROUTE_MAX = 512     # up to this many scalars, host bigints


def domain_size_for(r1cs: R1cs) -> int:
    """reference src/zkey_new.js:59: log2(nCon + nPub + 1 - 1) + 1."""
    return 2 ** ((r1cs.n_constraints + r1cs.n_public).bit_length())


def _batch_inverse_ints(vals, p: int, scale: int = 1) -> list:
    """[scale / v mod p] for nonzero ints by Montgomery's trick: one modular
    exponentiation and three products an element."""
    pref, acc = [], 1
    for v in vals:
        pref.append(acc)
        acc = acc * v % p
    inv = pow(acc, p - 2, p) * scale % p
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = pref[i] * inv % p
        inv = inv * vals[i] % p
    return out


def lagrange_at(fr, tau: int, n: int):
    """[L_i(tau)]_{i<n} over the 2^k domain, ffjavascript root convention:
    L_i(tau) = (tau^n - 1) w^i / (n (tau - w^i)) = ((tau^n - 1) / n) /
    (tau w^-i - 1), one batch inversion for all i."""
    k = n.bit_length() - 1
    p = fr.p
    zn = (pow(tau, n, p) - 1) % p
    if zn == 0:
        raise ValueError("tau lies in the evaluation domain")
    winv = fr.winv[k]
    es, t = [], tau % p
    for _ in range(n):
        es.append((t - 1) % p)
        t = t * winv % p
    return _batch_inverse_ints(es, p, zn * pow(n, p - 2, p) % p)


def _points_from_scalars(cv, scalars, g2=False, device=None):
    """[k_i]G as (x, y, inf) Montgomery limb arrays (numpy).

    Up to HOST_ROUTE_MAX scalars on host bigints, as the JAX package does;
    more go to a batched double-and-add on `device` (None: the card), in
    batches of jac.DEVICE_BATCH points, as many steps as the batch's largest
    scalar has bits, each batch turned affine with one batched inversion."""
    fr, fq = cv.fr, cv.fq
    n = len(scalars)
    if n <= HOST_ROUTE_MAX:
        gen = cv.g2 if g2 else cv.g1
        mul = hc.g2_mul if g2 else hc.g1_mul
        pts = [mul(cv, gen, int(k) % fr.p) for k in scalars]
        if g2:
            id_pt = ((0, 0), (1, 0))
            xs = tuple(ftorch.np_from_ints(
                fq, [fq.to_mont((id_pt if p is None else p)[0][i]) for p in pts])
                for i in (0, 1))
            ys = tuple(ftorch.np_from_ints(
                fq, [fq.to_mont((id_pt if p is None else p)[1][i]) for p in pts])
                for i in (0, 1))
        else:
            xs = ftorch.np_from_ints(
                fq, [fq.to_mont(0 if p is None else p[0]) for p in pts])
            ys = ftorch.np_from_ints(
                fq, [fq.to_mont(1 if p is None else p[1]) for p in pts])
        inf = np.array([p is None for p in pts], dtype=bool)
        return xs, ys, inf
    device = devmod.resolve(device)
    f = field_ops(ftorch.get_ctx(fq.name), 2 if g2 else 1, device)
    gen = cv.g2 if g2 else cv.g1
    sl = ftorch.np_from_ints(fr, scalars)
    parts = []
    for lo in range(0, n, jac.DEVICE_BATCH):
        m = min(n, lo + jac.DEVICE_BATCH) - lo
        coord = lambda v: ftorch.to_tensor(ftorch.np_from_int(fq, fq.to_mont(v)),
                                           device)[:, None].expand(fq.nl, m).contiguous()
        if g2:
            x, y = tuple(coord(v) for v in gen[0]), tuple(coord(v) for v in gen[1])
        else:
            x, y = coord(gen[0]), coord(gen[1])
        k = ftorch.to_tensor(sl[:, lo:lo + m], device)
        parts.append(_to_numpy(jac.scalar_mul_affine(f, x, y, None, k)))
    if len(parts) == 1:
        return parts[0]
    return tuple(_cat_np([p[i] for p in parts]) for i in range(3))


def _to_numpy(t):
    if isinstance(t, tuple):
        return tuple(_to_numpy(x) for x in t)
    return t.cpu().numpy() if t.dtype == torch.bool else ftorch.to_numpy(t)


def _cat_np(parts):
    if isinstance(parts[0], tuple):
        return tuple(_cat_np([p[i] for p in parts]) for i in range(len(parts[0])))
    return np.concatenate(parts, axis=-1)


def _r2_form(fr, limbs, device) -> np.ndarray:
    """(NL, n) plain limbs -> (NL, n) limbs of value * R^2 mod p (the
    coefficient section's storage): two Montgomery products by R^2."""
    ctx = ftorch.get_ctx(fr.name)
    t = ftorch.to_tensor(limbs, device)
    return ftorch.to_numpy(ftorch.to_mont(ctx, ftorch.to_mont(ctx, t)))


def _curve_of(r1cs: R1cs):
    for cv in (hc.BN254, hc.BLS12_381):
        if r1cs.prime == cv.fr.p:
            return cv
    raise ValueError("unknown curve for r1cs prime")


def setup_from_secrets(r1cs: R1cs, tau: int, alpha: int, beta: int,
                       gamma: int = 1, delta: int = 1,
                       device=None) -> zkey_fmt.Groth16Zkey:
    """The Groth16 key of `r1cs` for the given secrets.  device: None means
    the card ("cuda"); raises without one."""
    device = devmod.resolve(device)
    cv = _curve_of(r1cs)
    fr, fq = cv.fr, cv.fq
    p = fr.p

    n_public = r1cs.n_public
    n_vars = r1cs.n_wires
    domain = domain_size_for(r1cs)
    power = domain.bit_length() - 1

    L = lagrange_at(fr, tau, domain)
    L2 = lagrange_at(fr, tau, 2 * domain)

    vals = ftorch.np_to_ints(fr, r1cs.vals)

    u = [0] * n_vars
    v = [0] * n_vars
    wv = [0] * n_vars
    for mi, ci, si, val in zip(r1cs.m, r1cs.c, r1cs.s, vals):
        t = val * L[int(ci)] % p
        if mi == 0:
            u[int(si)] = (u[int(si)] + t) % p
        elif mi == 1:
            v[int(si)] = (v[int(si)] + t) % p
        else:
            wv[int(si)] = (wv[int(si)] + t) % p
    for s in range(n_public + 1):
        u[s] = (u[s] + L[r1cs.n_constraints + s]) % p

    gamma_inv = pow(gamma, p - 2, p)
    delta_inv = pow(delta, p - 2, p)

    ic_scal, c_scal = [], []
    for s in range(n_vars):
        comp = (beta * u[s] + alpha * v[s] + wv[s]) % p
        if s <= n_public:
            ic_scal.append(comp * gamma_inv % p)
        else:
            c_scal.append(comp * delta_inv % p)

    h_scal = [L2[2 * i + 1] * delta_inv % p for i in range(domain)]

    pts = lambda ks, g2=False: _points_from_scalars(cv, ks, g2, device)
    a_pts = pts(u)
    b1_pts = pts(v)
    b2_pts = pts(v, True)
    c_pts = pts(c_scal)
    h_pts = pts(h_scal)
    ic_bytes = pcodec.g1_lem_to_bytes(fq, *pts(ic_scal))
    ic = pcodec.g1_lem_to_ints(fq, ic_bytes, n_public + 1)

    # coefficient list: m<2 entries + the public-binding rows
    keep = r1cs.m < 2
    ms = np.concatenate([r1cs.m[keep], np.zeros(n_public + 1, dtype=np.int32)])
    cs = np.concatenate([r1cs.c[keep],
                         (r1cs.n_constraints + np.arange(n_public + 1)).astype(np.int32)])
    ss = np.concatenate([r1cs.s[keep], np.arange(n_public + 1).astype(np.int32)])
    plain = np.concatenate([r1cs.vals[:, keep], _ones(fr, n_public + 1)], axis=1)
    order = np.argsort(cs, kind="stable")
    coeffs = {"m": ms[order], "c": cs[order], "s": ss[order],
              "val": _r2_form(fr, plain[:, order], device)}

    g1, g2 = cv.g1, cv.g2
    return zkey_fmt.Groth16Zkey(
        curve=cv, n8q=fq.n8, n8r=fr.n8, n_vars=n_vars, n_public=n_public,
        domain_size=domain, power=power,
        vk_alpha_1=hc.g1_mul(cv, g1, alpha),
        vk_beta_1=hc.g1_mul(cv, g1, beta),
        vk_beta_2=hc.g2_mul(cv, g2, beta),
        vk_gamma_2=hc.g2_mul(cv, g2, gamma),
        vk_delta_1=hc.g1_mul(cv, g1, delta),
        vk_delta_2=hc.g2_mul(cv, g2, delta),
        ic=ic, coeffs=coeffs,
        a_points=a_pts, b1_points=b1_pts, b2_points=b2_pts,
        c_points=c_pts, h_points=h_pts, raw=None,
    )


def _ones(fr, n) -> np.ndarray:
    return np.tile(np.array(fr.limbs(1), dtype=np.uint32)[:, None], (1, n))


def _coeff_section(fr, m, c, s, val) -> bytes:
    """u32 count, then per entry u32 m, c, s and the n8-byte value limbs."""
    rec = np.zeros(len(m), dtype=[("m", "<u4"), ("c", "<u4"), ("s", "<u4"),
                                  ("v", "u1", (fr.n8,))])
    rec["m"], rec["c"], rec["s"] = m, c, s
    rec["v"] = np.frombuffer(pcodec.frs_to_bytes(fr, val), dtype=np.uint8).reshape(
        len(m), fr.n8)
    return np.uint32(len(m)).astype("<u4").tobytes() + rec.tobytes()


def _write_zkey(cv, n_vars, n_public, domain, vk_lem, sections, cs_hash) -> bytes:
    """The Groth16 .zkey container: header (1, 2), the sections 3-9 given
    as bytes, and the circuit hash with no contribution (10)."""
    fq, fr = cv.fq, cv.fr
    w = BinFileWriter("zkey", 1)
    s1 = SectionWriter()
    s1.u32(zkey_fmt.GROTH16_PROTOCOL_ID)
    w.add_section(1, s1.tobytes())
    h = SectionWriter()
    h.u32(fq.n8)
    h.big(fq.p, fq.n8)
    h.u32(fr.n8)
    h.big(fr.p, fr.n8)
    h.u32(n_vars)
    h.u32(n_public)
    h.u32(domain)
    h.raw(vk_lem)
    w.add_section(2, h.tobytes())
    for sid in range(3, 10):
        w.add_section(sid, sections[sid])
    s10 = SectionWriter()
    s10.raw(cs_hash)
    s10.u32(0)
    w.add_section(10, s10.tobytes())
    return w.tobytes()


def write_groth16_zkey(zk: zkey_fmt.Groth16Zkey) -> bytes:
    """Serialize to the reference .zkey byte format (sections 1-10), the
    circuit hash left zero."""
    cv = zk.curve
    fq, fr = cv.fq, cv.fr
    vk = (pcodec.g1_lem_from_ints(fq, [zk.vk_alpha_1, zk.vk_beta_1])
          + pcodec.g2_lem_from_ints(fq, [zk.vk_beta_2, zk.vk_gamma_2])
          + pcodec.g1_lem_from_ints(fq, [zk.vk_delta_1])
          + pcodec.g2_lem_from_ints(fq, [zk.vk_delta_2]))
    co = zk.coeffs
    sections = {
        3: pcodec.g1_lem_from_ints(fq, zk.ic),
        4: _coeff_section(fr, co["m"], co["c"], co["s"], co["val"]),
        5: pcodec.g1_lem_to_bytes(fq, *zk.a_points),
        6: pcodec.g1_lem_to_bytes(fq, *zk.b1_points),
        7: pcodec.g2_lem_to_bytes(fq, *zk.b2_points),
        8: pcodec.g1_lem_to_bytes(fq, *zk.c_points),
        9: pcodec.g1_lem_to_bytes(fq, *zk.h_points),
    }
    return _write_zkey(cv, zk.n_vars, zk.n_public, zk.domain_size, vk, sections,
                       b"\0" * 64)


# ------------------------------------------------------------ from a .ptau

def _compose(cv, g2, sources, src, base, seg, scal, n_out, device) -> bytes:
    """LEM bytes of out[k] = sum_{seg[i] == k} scal_i * sources[src_i][base_i]
    for k < n_out: one segmented MSM on `device`.  sources: LEM buffers of
    equal length; src, base, seg: (E,) int arrays; scal: (NL, E) plain limbs."""
    fq, fr = cv.fq, cv.fr
    k = 4 if g2 else 2
    size = k * fq.n8
    if len(seg) == 0:
        return b"\0" * (n_out * size)
    table = np.concatenate([np.frombuffer(s, dtype="<u2").reshape(-1, k, fq.nl)
                            for s in sources])
    per = len(table) // len(sources)
    order = np.argsort(seg, kind="stable")
    rows = table[(src * per + base)[order]]                       # (E, k, NL)
    coord = lambda i: ftorch.to_tensor(rows[:, i, :].T, device)
    inf = torch.from_numpy(~rows.any(axis=(1, 2))).to(device)
    if g2:
        px, py = (coord(0), coord(1)), (coord(2), coord(3))
    else:
        px, py = coord(0), coord(1)
    f = field_ops(ftorch.get_ctx(fq.name), 2 if g2 else 1, device)
    P = msm_mod.segmented_msm(
        f, px, py, inf, ftorch.to_tensor(scal[:, order], device),
        torch.from_numpy(np.asarray(seg, dtype=np.int64)[order]).to(device),
        n_out, fr.p.bit_length())
    x, y, pinf = _to_numpy(jac.to_affine_batch(f, P, f.batch_inv))
    to_bytes = pcodec.g2_lem_to_bytes if g2 else pcodec.g1_lem_to_bytes
    return to_bytes(fq, x, y, pinf)


def _h_chain_u(cv, sec2, domain: int, device) -> bytes:
    """The csHash's H part (reference :504-577): [tau^(n+i)]G1 - [tau^i]G1
    for i < n - 1, uncompressed big-endian, computed as one batch."""
    fq = cv.fq
    s_g1 = 2 * fq.n8
    m = domain - 1
    f = field_ops(ftorch.get_ctx(fq.name), 1, device)

    def pts(lo):
        x, y, inf = pcodec.g1_lem_from_bytes(fq, sec2[lo * s_g1:(lo + m) * s_g1], m)
        return jac.from_affine(f, ftorch.to_tensor(x, device), ftorch.to_tensor(y, device),
                               torch.from_numpy(inf).to(device))

    d = jac.jac_add(f, pts(domain), jac.jac_neg(f, pts(0)))
    x, y, inf = _to_numpy(jac.to_affine_batch(f, d, f.batch_inv))
    return lem_to_u(cv, pcodec.g1_lem_to_bytes(fq, x, y, inf), m, False, device)


def setup_from_ptau(r1cs: R1cs, ptau, logger=None, device=None) -> bytes:
    """`zkey new`: the Groth16 .zkey bytes composed from a prepared
    powers-of-tau file (reference src/zkey_new.js:36-181).

    Each point section is one segmented MSM over the Lagrange points of the
    circuit's power (reference :203-336 composes them per signal on worker
    threads, :338-501).  The blake2b circuit hash (csHash, :166-173) lands in
    section 10.  logger: gets a `debug` line before each step.  device: None
    means the card ("cuda"); raises without one."""
    device = devmod.resolve(device)
    log = logger.debug if logger else (lambda msg: None)
    cv = ptau.curve
    fr, fq = cv.fr, cv.fq
    if r1cs.prime != fr.p:
        raise ValueError("r1cs curve does not match powers of tau ceremony "
                         "curve")
    n_public = r1cs.n_public
    n_vars = r1cs.n_wires
    n_con = r1cs.n_constraints
    domain = domain_size_for(r1cs)
    power = domain.bit_length() - 1
    if power > ptau.power:
        raise ValueError(
            f"circuit too big for this power of tau ceremony. "
            f"{n_con}*2 > 2**{ptau.power}")
    if 12 not in ptau.sections:
        raise ValueError("Powers of tau is not prepared.")

    s_g1, s_g2 = 2 * fq.n8, 4 * fq.n8
    # the Lagrange block of a power starts at point (domain - 1)
    off1 = (domain - 1) * s_g1
    off2 = (domain - 1) * s_g2
    ltau1 = ptau.sections[12][off1:off1 + domain * s_g1]
    ltau2 = ptau.sections[13][off2:off2 + domain * s_g2]
    lalpha = ptau.sections[14][off1:off1 + domain * s_g1]
    lbeta = ptau.sections[15][off1:off1 + domain * s_g1]

    alpha1 = bytes(ptau.sections[4][:s_g1])
    beta1 = bytes(ptau.sections[5][:s_g1])
    beta2 = bytes(ptau.sections[6][:s_g2])
    g1b = pcodec.g1_lem_from_ints(fq, [cv.g1])
    g2b = pcodec.g2_lem_from_ints(fq, [cv.g2])
    cs = hashlib.blake2b(digest_size=64)
    for b, g2_ in ((alpha1, False), (beta1, False), (beta2, True),
                   (g2b, True), (g1b, False), (g2b, True)):
        cs.update(lem_to_u(cv, b, 1, g2_, device))

    # entries (reference :203-300): per r1cs entry a source block, a base
    # point (its constraint), a segment (its signal) and a scalar (its value)
    m, c, s = (np.asarray(a, dtype=np.int64) for a in (r1cs.m, r1cs.c, r1cs.s))
    vals = np.asarray(r1cs.vals, dtype=np.uint32)
    pub = np.arange(n_public + 1, dtype=np.int64)
    ones = _ones(fr, n_public + 1)
    zeros = np.zeros(n_public + 1, dtype=np.int64)

    def compose(g2, sources, mask, src, seg, n_out, extra_src=None):
        """Entries of `mask` (+ the public binding rows when extra_src is the
        index of their source)."""
        src_, base, seg_, scal = src[mask], c[mask], seg[mask], vals[:, mask]
        if extra_src is not None:
            src_ = np.concatenate([src_, zeros + extra_src])
            base = np.concatenate([base, n_con + pub])
            seg_ = np.concatenate([seg_, pub])
            scal = np.concatenate([scal, ones], axis=1)
        return _compose(cv, g2, sources, src_, base, seg_, scal, n_out, device)

    log("Computing A")
    A_lem = compose(False, [ltau1], m == 0, 0 * m, s, n_vars, extra_src=0)
    log("Computing B1")
    B1_lem = compose(False, [ltau1], m == 1, 0 * m, s, n_vars)
    log("Computing B2")
    B2_lem = compose(True, [ltau2], m == 1, 0 * m, s, n_vars)
    # C (s > nPublic) and IC (s <= nPublic): the source follows m (A side ->
    # beta, B side -> alpha, C side -> tau); IC adds beta * L_{nCon+s}
    log("Computing C and IC")
    C_lem = compose(False, [lbeta, lalpha, ltau1], s > n_public, m,
                    s - n_public - 1, n_vars - n_public - 1)
    IC_lem = compose(False, [lbeta, lalpha, ltau1], s <= n_public, m, s,
                     n_public + 1, extra_src=0)

    # H points: odd Lagrange points of the 2n domain (writeHs, :182-201)
    off_h = (2 * domain - 1) * s_g1
    block2n = np.frombuffer(ptau.sections[12][off_h:off_h + 2 * domain * s_g1],
                            dtype=np.uint8).reshape(2 * domain, s_g1)
    H_lem = np.ascontiguousarray(block2n[1::2]).tobytes()

    # csHash: section hashes in write order (:338-343, :504-577)
    log("Circuit hash")
    def hash_section(count, u):
        cs.update(int(count).to_bytes(4, "big"))
        cs.update(u)

    hash_section(n_public + 1, lem_to_u(cv, IC_lem, n_public + 1, False, device))
    hash_section(domain - 1, _h_chain_u(cv, ptau.sections[2], domain, device))
    hash_section(n_vars - n_public - 1,
                 lem_to_u(cv, C_lem, n_vars - n_public - 1, False, device))
    hash_section(n_vars, lem_to_u(cv, A_lem, n_vars, False, device))
    hash_section(n_vars, lem_to_u(cv, B1_lem, n_vars, False, device))
    hash_section(n_vars, lem_to_u(cv, B2_lem, n_vars, True, device))

    # coefficient section: m < 2 entries in r1cs order, then the public rows
    keep = m < 2
    coef = _coeff_section(
        fr, np.concatenate([m[keep], zeros]), np.concatenate([c[keep], n_con + pub]),
        np.concatenate([s[keep], pub]),
        _r2_form(fr, np.concatenate([vals[:, keep], ones], axis=1), device))

    vk = alpha1 + beta1 + beta2 + g2b + g1b + g2b   # gamma2 = delta2 = G2, delta1 = G1
    sections = {3: IC_lem, 4: coef, 5: A_lem, 6: B1_lem, 7: B2_lem, 8: C_lem, 9: H_lem}
    return _write_zkey(cv, n_vars, n_public, domain, vk, sections, cs.digest())
