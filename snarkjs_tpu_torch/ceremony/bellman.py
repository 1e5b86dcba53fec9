"""Bellman / kobi-gross phase2 (MPCParams) interop for Groth16 zkeys (port
of snarkjs_tpu/ceremony/bellman.py; reference src/zkey_export_bellman.js:7-139,
src/zkey_import_bellman.js:26-189, src/zkey_bellman_contribute.js:46-199).

* export: zkey -> MPCParams file (big-endian uncompressed points).  The H
  section changes basis from the zkey's odd-coset Lagrange form to Bellman's
  tau-power form via a forward group FFT + coset key; the forward FFT is
  computed with the group INTT engine using NTT(a)[k] = n*INTT(a)[(n-k)%n],
  folding the n into the coset key's constant factor.
* import: MPCParams -> new zkey.  Validates the circuit hash and that prior
  contributions are a prefix, converts H back (inverse coset key + group
  INTT), installs the new delta and contribution list.
* contribute: one MPC round over the *challenge* file format — scales the
  H and L sections by delta^-1, delta_1/2 by delta, and appends the
  contribution with its blake2b transcript chain.

On the card the group iNTT is `ptau_ops.group_lagrange_lem` (the batched
stages, K-field), the coset keys and the delta^-1 scaling are batched
double-and-adds (`ptau_ops._apply_keys`: H and L of a contribution in one
batch), the codecs one Montgomery conversion a section.  The (n - k) mod n
reorder is one index over the point array.

MPCParams layout (all points uncompressed BE):
  vk (alpha1 beta1 beta2 gamma2 delta1 delta2) | u32-len + IC | H | L | A |
  B1 | B2 | csHash(64) | u32 nContribs | per-contrib (deltaAfter, g1_s,
  g1_sx, g2_spx, transcript(64)).

The export drops the last tau-form H point and the import puts a zero point
in its place, as the reference does (the quotient has degree n - 2), so a
round trip with no new contribution keeps section 8 and changes every point
of section 9; `zkey_mpc.verify_from_init` weights that point by 0.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import device as devmod
from ..curves import host_curve as hc
from ..formats import points as pcodec
from ..utils.blake2b import Blake2b
from . import keypair, ptau_ops
from .zkey_mpc import (MPCParams, ZkeyContribution, _parse, _rebuild,
                       hash_pubkey, read_mpc_params)


def _g1_u(fq, p) -> bytes:
    return pcodec.g1_uncompressed_be(fq, p)


def _g2_u(fq, p) -> bytes:
    return pcodec.g2_uncompressed_be(fq, p)


def _read_g1_u(fq, b: bytes, off: int):
    x = int.from_bytes(b[off:off + fq.n8], "big")
    y = int.from_bytes(b[off + fq.n8:off + 2 * fq.n8], "big")
    return None if x == 0 and y == 0 else (x, y), off + 2 * fq.n8


def _read_g2_u(fq, b: bytes, off: int):
    n8 = fq.n8
    x1 = int.from_bytes(b[off:off + n8], "big")
    x0 = int.from_bytes(b[off + n8:off + 2 * n8], "big")
    y1 = int.from_bytes(b[off + 2 * n8:off + 3 * n8], "big")
    y0 = int.from_bytes(b[off + 3 * n8:off + 4 * n8], "big")
    p = None if (x0 | x1 | y0 | y1) == 0 else ((x0, x1), (y0, y1))
    return p, off + 4 * n8


def _h_lagrange_to_tau(cv, sec9: bytes, domain: int, device) -> bytes:
    """zkey H basis (odd-coset Lagrange) -> Bellman tau basis, minus the last
    point (reference src/zkey_export_bellman.js:44-52)."""
    fr = cv.fr
    power = domain.bit_length() - 1
    sg1 = 2 * cv.fq.n8
    # forward group FFT via INTT: NTT[k] = n * INTT[(n-k) % n]
    b = ptau_ops.group_lagrange_lem(cv, sec9, domain, False, device=device)
    pts = np.frombuffer(b, dtype=np.uint8).reshape(domain, sg1)
    reorder = pts[(domain - np.arange(domain)) % domain]
    first = (fr.p - 2) * domain % fr.p          # Fr.neg(2), n folded in
    out = ptau_ops.apply_key_g1(cv, reorder.tobytes(), domain, first,
                                fr.w[power + 1], device)
    return out[: (domain - 1) * sg1]


def _h_tau_to_lagrange(cv, h_lem: bytes, domain: int, device) -> bytes:
    """Inverse of _h_lagrange_to_tau (reference
    src/zkey_import_bellman.js:131-146)."""
    fr = cv.fr
    power = domain.bit_length() - 1
    sg1 = 2 * cv.fq.n8
    h_lem = h_lem + b"\0" * sg1                 # degree m-2: last is zero
    n2_inv = (fr.p - 1) * pow(2, fr.p - 2, fr.p) % fr.p
    keyed = ptau_ops.apply_key_g1(cv, h_lem, domain, n2_inv,
                                  fr.winv[power + 1], device)
    return ptau_ops.group_lagrange_lem(cv, keyed, domain, False, device=device)


def export_mpc_params(zkey_bytes: bytes, device=None) -> bytes:
    """Groth16 zkey -> Bellman MPCParams bytes.  device: None means the
    card; raises without one."""
    device = devmod.resolve(device)
    bf, cv, meta, vk = _parse(zkey_bytes)
    fq = cv.fq
    domain = meta["domain"]
    n_vars = meta["n_vars"]
    mp = read_mpc_params(cv, bf.read_section(10))

    out = bytearray()
    out += _g1_u(fq, vk["alpha_1"])
    out += _g1_u(fq, vk["beta_1"])
    out += _g2_u(fq, vk["beta_2"])
    out += _g2_u(fq, vk["gamma_2"])
    out += _g1_u(fq, vk["delta_1"])
    out += _g2_u(fq, vk["delta_2"])

    def arr(lem: bytes, n: int, g2: bool):
        out.extend(struct.pack(">I", n))
        out.extend(ptau_ops.lem_to_u(cv, lem, n, g2, device))

    arr(bf.read_section(3), meta["n_public"] + 1, False)        # IC
    arr(_h_lagrange_to_tau(cv, bf.read_section(9), domain, device),
        domain - 1, False)                                       # H
    n_l = n_vars - meta["n_public"] - 1
    arr(bf.read_section(8), n_l, False)                          # L
    arr(bf.read_section(5), n_vars, False)                       # A
    arr(bf.read_section(6), n_vars, False)                       # B1
    arr(bf.read_section(7), n_vars, True)                        # B2

    out += mp.cs_hash
    out += struct.pack(">I", len(mp.contributions))
    for c in mp.contributions:
        out += _g1_u(fq, c.delta_after)
        out += _g1_u(fq, c.g1_s)
        out += _g1_u(fq, c.g1_sx)
        out += _g2_u(fq, c.g2_spx)
        out += c.transcript
    return bytes(out)


def import_mpc_params(old_zkey_bytes: bytes, mpc_bytes: bytes,
                      name: str = "", logger=None, device=None):
    """MPCParams -> new zkey bytes, or False on validation failure.
    device: None means the card; raises without one."""
    device = devmod.resolve(device)
    bf, cv, meta, vk = _parse(old_zkey_bytes)
    fq = cv.fq
    sg1, sg2 = 2 * fq.n8, 4 * fq.n8
    domain = meta["domain"]
    n_vars = meta["n_vars"]
    n_pub = meta["n_public"]
    old_mp = read_mpc_params(cv, bf.read_section(10))

    def err(msg):
        if logger:
            logger.error(msg)
        return False

    pos = (sg1 * 3 + sg2 * 3 + 8 + sg1 * n_vars + 4 + sg1 * (domain - 1)
           + 4 + sg1 * n_vars + 4 + sg1 * n_vars + 4 + sg2 * n_vars)
    cs_hash = mpc_bytes[pos:pos + 64]
    pos += 64
    (n_contribs,) = struct.unpack(">I", mpc_bytes[pos:pos + 4])
    pos += 4
    new_mp = MPCParams(cs_hash=cs_hash)
    for i in range(n_contribs):
        c = ZkeyContribution()
        c.delta_after, pos = _read_g1_u(fq, mpc_bytes, pos)
        c.g1_s, pos = _read_g1_u(fq, mpc_bytes, pos)
        c.g1_sx, pos = _read_g1_u(fq, mpc_bytes, pos)
        c.g2_spx, pos = _read_g2_u(fq, mpc_bytes, pos)
        c.transcript = mpc_bytes[pos:pos + 64]
        pos += 64
        if i < len(old_mp.contributions):
            oc = old_mp.contributions[i]
            c.type = oc.type
            c.name = oc.name
            if c.type == 1:
                c.beacon_hash = oc.beacon_hash
                c.num_iterations_exp = oc.num_iterations_exp
        elif name:
            c.name = name
        new_mp.contributions.append(c)

    if cs_hash != old_mp.cs_hash:
        return err("Hash of the original circuit does not match with the "
                   "MPC one")
    if len(old_mp.contributions) > len(new_mp.contributions):
        return err("The imported file does not include new contributions")
    for i, oc in enumerate(old_mp.contributions):
        nc = new_mp.contributions[i]
        same = (oc.delta_after == nc.delta_after and oc.g1_s == nc.g1_s
                and oc.g1_sx == nc.g1_sx and oc.g2_spx == nc.g2_spx
                and oc.transcript == nc.transcript)
        if not same:
            return err(f"Previous contribution {i} does not match")

    # new delta from the MPCParams vk block: alpha1, beta1 (G1) then
    # beta2, gamma2 (G2) precede it (reference src/zkey_import_bellman.js)
    off = sg1 * 2 + sg2 * 2
    vk["delta_1"], off = _read_g1_u(fq, mpc_bytes, off)
    vk["delta_2"], off = _read_g2_u(fq, mpc_bytes, off)

    # section sizes sanity (reference :117-186)
    off = sg1 * 3 + sg2 * 3
    (n_ic,) = struct.unpack(">I", mpc_bytes[off:off + 4])
    if n_ic != n_pub + 1:
        return err("Invalid number of points in IC")
    off += 4 + sg1 * n_ic
    (n_h,) = struct.unpack(">I", mpc_bytes[off:off + 4])
    if n_h != domain - 1:
        return err("Invalid number of points in H")
    off += 4
    h_u = mpc_bytes[off:off + sg1 * n_h]
    off += sg1 * n_h
    (n_l,) = struct.unpack(">I", mpc_bytes[off:off + 4])
    if n_l != n_vars - n_pub - 1:
        return err("Invalid number of points in L")
    off += 4
    l_u = mpc_bytes[off:off + sg1 * n_l]
    off += sg1 * n_l
    for nm, g2f in (("A", False), ("B1", False), ("B2", True)):
        (cnt,) = struct.unpack(">I", mpc_bytes[off:off + 4])
        if cnt != n_vars:
            return err(f"Invalid number of points in {nm}")
        off += 4 + (sg2 if g2f else sg1) * cnt

    sec9 = _h_tau_to_lagrange(
        cv, ptau_ops.u_to_lem(cv, h_u, n_h, False, device), domain, device)
    sec8 = ptau_ops.u_to_lem(cv, l_u, n_l, False, device)
    return _rebuild(bf, cv, meta, vk, sec8, sec9, new_mp)


# ---------------------------------------------------------------- contribute


def bellman_contribute(cv, challenge: bytes, entropy=None, rng=None,
                       logger=None, device=None):
    """One MPC round over the Bellman challenge/response (= MPCParams)
    format.  Returns (response_bytes, contribution_hash).  device: None
    means the card; raises without one."""
    device = devmod.resolve(device)
    fq, fr = cv.fq, cv.fr
    sg1, sg2 = 2 * fq.n8, 4 * fq.n8
    if rng is None:
        rng = ptau_ops.random_rng(entropy)
    delta = keypair.field_from_rng(fr, rng)
    inv_delta = pow(delta, fr.p - 2, fr.p)

    out = bytearray()
    pos = 0

    def copy(n):
        nonlocal pos
        out.extend(challenge[pos:pos + n])
        pos += n

    def read_g1():
        nonlocal pos
        p, pos2 = _read_g1_u(fq, challenge, pos)
        pos = pos2
        return p

    def read_g2():
        nonlocal pos
        p, pos2 = _read_g2_u(fq, challenge, pos)
        pos = pos2
        return p

    def read_section():
        """A u32 count and that many uncompressed G1 points."""
        nonlocal pos
        (n,) = struct.unpack(">I", challenge[pos:pos + 4])
        u = challenge[pos + 4:pos + 4 + n * sg1]
        pos += 4 + n * sg1
        return n, ptau_ops.u_to_lem(cv, u, n, False, device)

    copy(sg1 * 2 + sg2 * 2)                     # alpha1 beta1 beta2 gamma2
    delta1 = hc.g1_mul(cv, read_g1(), delta)
    out += _g1_u(fq, delta1)
    delta2 = hc.g2_mul_any(cv, read_g2(), delta)
    out += _g2_u(fq, delta2)

    (n_ic,) = struct.unpack(">I", challenge[pos:pos + 4])
    copy(4 + n_ic * sg1)

    # H and L times delta^-1 in one batch
    n_h, h_lem = read_section()
    n_l, l_lem = read_section()
    scaled = ptau_ops._apply_keys(cv, False, [(h_lem, n_h, inv_delta, 1),
                                              (l_lem, n_l, inv_delta, 1)], device)
    for n, lem in zip((n_h, n_l), scaled):
        out += struct.pack(">I", n)
        out += ptau_ops.lem_to_u(cv, lem, n, False, device)
    for g2f in (False, False, True):
        (cnt,) = struct.unpack(">I", challenge[pos:pos + 4])
        copy(4 + cnt * (sg2 if g2f else sg1))

    # contribution chain
    th = Blake2b(64)
    cs_hash = challenge[pos:pos + 64]
    pos += 64
    th.update(cs_hash)
    (n_contribs,) = struct.unpack(">I", challenge[pos:pos + 4])
    pos += 4
    contribs = []
    for _ in range(n_contribs):
        c = ZkeyContribution()
        c.delta_after = read_g1()
        c.g1_s = read_g1()
        c.g1_sx = read_g1()
        c.g2_spx = read_g2()
        c.transcript = challenge[pos:pos + 64]
        pos += 64
        contribs.append(c)
        hash_pubkey(th, cv, c)

    cur = ZkeyContribution()
    cur.g1_s = keypair.g1_from_rng(cv, rng)
    cur.g1_sx = hc.g1_mul(cv, cur.g1_s, delta)
    th.update(_g1_u(fq, cur.g1_s))
    th.update(_g1_u(fq, cur.g1_sx))
    cur.transcript = th.digest()
    g2_sp = keypair.hash_to_g2(cv, cur.transcript)
    cur.g2_spx = hc.g2_mul_any(cv, g2_sp, delta)
    cur.delta_after = delta1
    cur.type = 0
    contribs.append(cur)

    out += cs_hash
    out += struct.pack(">I", len(contribs))
    for c in contribs:
        out += _g1_u(fq, c.delta_after)
        out += _g1_u(fq, c.g1_s)
        out += _g1_u(fq, c.g1_sx)
        out += _g2_u(fq, c.g2_spx)
        out += c.transcript

    ch = Blake2b(64)
    hash_pubkey(ch, cv, cur)
    if logger:
        logger.info("Bellman contribution computed")
    return bytes(out), ch.digest()
