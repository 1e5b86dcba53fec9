"""Phase-2 (circuit-specific) MPC over Groth16 zkeys (port of
snarkjs_tpu/ceremony/zkey_mpc.py).

Byte-level operations on the .zkey container, mirroring:
  contribute        reference src/zkey_contribute.js:29-108
  beacon            reference src/zkey_beacon.js:30-115
  verify_from_init  reference src/zkey_verify_frominit.js:32-418
  verify_from_r1cs  reference src/zkey_verify_fromr1cs.js:31
  MPC params serde  reference src/zkey_utils.js:451-544 (section 10)

On the card:
* a contribution scales the L (section 8) and H (section 9) points by
  delta^-1 (reference src/mpc_applykey.js:29-51) in one batched
  double-and-add of both sections (`ptau_ops._apply_keys`, K-field);
* verify's four MSMs go to `ptau_ops._msm_lem` (K-scan), the H check's Fr
  NTT to `ntt.ntt` (K-mm-norm from 2^12), and its tau^(n+i) - tau^i points
  come from one batched Jacobian add (`jac.jac_add`, K-field).
The key, the transcript and the pairings stay on host bigints.  Outputs are
file bytes, hashes and verdicts, equal to the JAX package's.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field

import numpy as np

from .. import device as devmod
from ..curves import host_curve as hc
from ..curves import jac
from ..fields import ftorch
from ..formats import points as pcodec
from ..formats import zkey as zkey_fmt
from ..formats.binfile import BinFile, BinFileWriter, SectionWriter
from ..ntt import ntt as nttmod
from ..protocols import groth16_setup
from ..utils.blake2b import Blake2b
from . import keypair
from . import ptau_ops


@dataclass
class ZkeyContribution:
    delta_after: tuple = None
    g1_s: tuple = None
    g1_sx: tuple = None
    g2_spx: tuple = None
    transcript: bytes = b""
    type: int = 0
    name: str = ""
    num_iterations_exp: int = 0
    beacon_hash: bytes = b""


@dataclass
class MPCParams:
    cs_hash: bytes = b"\0" * 64
    contributions: list = field(default_factory=list)


def read_mpc_params(cv, section10: bytes) -> MPCParams:
    """reference src/zkey_utils.js:518-530 (readMPCParams)."""
    fq = cv.fq

    class R:
        def __init__(self, b):
            self.b, self.pos = b, 0

        def raw(self, n):
            out = self.b[self.pos:self.pos + n]
            self.pos += n
            return out

        def u32(self):
            return int.from_bytes(self.raw(4), "little")

    r = R(section10)
    mp = MPCParams(cs_hash=r.raw(64))
    n = r.u32()
    for _ in range(n):
        c = ZkeyContribution()
        c.delta_after = pcodec.g1_lem_to_ints(fq, r.raw(2 * fq.n8), 1)[0]
        c.g1_s = pcodec.g1_lem_to_ints(fq, r.raw(2 * fq.n8), 1)[0]
        c.g1_sx = pcodec.g1_lem_to_ints(fq, r.raw(2 * fq.n8), 1)[0]
        c.g2_spx = pcodec.g2_lem_to_ints(fq, r.raw(4 * fq.n8), 1)[0]
        c.transcript = r.raw(64)
        c.type = r.u32()
        plen = r.u32()
        buf = r.raw(plen)
        pos, last = 0, 0
        while pos < plen:
            t = buf[pos]; pos += 1
            if t <= last:
                raise ValueError("Parameters in the contribution must be sorted")
            last = t
            if t == 1:
                ln = buf[pos]; pos += 1
                c.name = buf[pos:pos + ln].decode(); pos += ln
            elif t == 2:
                c.num_iterations_exp = buf[pos]; pos += 1
            elif t == 3:
                ln = buf[pos]; pos += 1
                c.beacon_hash = bytes(buf[pos:pos + ln]); pos += ln
            else:
                raise ValueError("Parameter not recognized")
        mp.contributions.append(c)
    return mp


def write_mpc_params(cv, mp: MPCParams) -> bytes:
    fq = cv.fq
    w = SectionWriter()
    w.raw(mp.cs_hash)
    w.u32(len(mp.contributions))
    for c in mp.contributions:
        w.raw(pcodec.g1_lem_from_ints(fq, [c.delta_after, c.g1_s, c.g1_sx]))
        w.raw(pcodec.g2_lem_from_ints(fq, [c.g2_spx]))
        w.raw(c.transcript)
        w.u32(c.type)
        params = bytearray()
        if c.name:
            nd = c.name[:64].encode()
            params += bytes([1, len(nd)]) + nd
        if c.type == 1:
            params += bytes([2, c.num_iterations_exp])
            params += bytes([3, len(c.beacon_hash)]) + c.beacon_hash
        w.u32(len(params))
        w.raw(bytes(params))
    return w.tobytes()


def hash_pubkey(hasher, cv, c: ZkeyContribution):
    """reference src/zkey_utils.js:558-564."""
    fq = cv.fq
    hasher.update(pcodec.g1_uncompressed_be(fq, c.delta_after))
    hasher.update(pcodec.g1_uncompressed_be(fq, c.g1_s))
    hasher.update(pcodec.g1_uncompressed_be(fq, c.g1_sx))
    hasher.update(pcodec.g2_uncompressed_be(fq, c.g2_spx))
    hasher.update(c.transcript)


# ---------------------------------------------------------------------------

def _parse(zkey_bytes: bytes):
    bf = BinFile(zkey_bytes, "zkey")
    r = bf.reader(1)
    if r.u32() != zkey_fmt.GROTH16_PROTOCOL_ID:
        raise ValueError("zkey file is not groth16")
    hdr = bf.reader(2)
    n8q = hdr.u32()
    q = hdr.big(n8q)
    cv = hc.curve_from_q(q)
    n8r = hdr.u32()
    hdr.big(n8r)
    n_vars, n_public, domain = hdr.u32(), hdr.u32(), hdr.u32()
    vk = {}
    fq = cv.fq
    vk["alpha_1"] = pcodec.g1_lem_to_ints(fq, hdr.raw(2 * n8q), 1)[0]
    vk["beta_1"] = pcodec.g1_lem_to_ints(fq, hdr.raw(2 * n8q), 1)[0]
    vk["beta_2"] = pcodec.g2_lem_to_ints(fq, hdr.raw(4 * n8q), 1)[0]
    vk["gamma_2"] = pcodec.g2_lem_to_ints(fq, hdr.raw(4 * n8q), 1)[0]
    vk["delta_1"] = pcodec.g1_lem_to_ints(fq, hdr.raw(2 * n8q), 1)[0]
    vk["delta_2"] = pcodec.g2_lem_to_ints(fq, hdr.raw(4 * n8q), 1)[0]
    return bf, cv, dict(n8q=n8q, n8r=n8r, n_vars=n_vars, n_public=n_public,
                        domain=domain), vk


def _write_header_section(cv, meta, vk) -> bytes:
    fq, fr = cv.fq, cv.fr
    h = SectionWriter()
    h.u32(fq.n8)
    h.big(fq.p, fq.n8)
    h.u32(fr.n8)
    h.big(fr.p, fr.n8)
    h.u32(meta["n_vars"])
    h.u32(meta["n_public"])
    h.u32(meta["domain"])
    h.raw(pcodec.g1_lem_from_ints(fq, [vk["alpha_1"], vk["beta_1"]]))
    h.raw(pcodec.g2_lem_from_ints(fq, [vk["beta_2"], vk["gamma_2"]]))
    h.raw(pcodec.g1_lem_from_ints(fq, [vk["delta_1"]]))
    h.raw(pcodec.g2_lem_from_ints(fq, [vk["delta_2"]]))
    return h.tobytes()


def _rebuild(bf: BinFile, cv, meta, vk, sec8: bytes, sec9: bytes,
             mp: MPCParams) -> bytes:
    w = BinFileWriter("zkey", 1)
    s1 = SectionWriter()
    s1.u32(zkey_fmt.GROTH16_PROTOCOL_ID)
    w.add_section(1, s1.tobytes())
    w.add_section(2, _write_header_section(cv, meta, vk))
    for sid in (3, 4, 5, 6, 7):
        w.add_section(sid, bf.read_section(sid))
    w.add_section(8, sec8)
    w.add_section(9, sec9)
    w.add_section(10, write_mpc_params(cv, mp))
    return w.tobytes()


def _transcript_and_key(cv, mp: MPCParams, delta_prv: int, g1_s):
    """Build the transcript hash chain and the delta pubkey
    (reference src/zkey_contribute.js:46-61)."""
    th = Blake2b(64)
    th.update(mp.cs_hash)
    for c in mp.contributions:
        hash_pubkey(th, cv, c)
    g1_sx = hc.g1_mul(cv, g1_s, delta_prv)
    th.update(pcodec.g1_uncompressed_be(cv.fq, g1_s))
    th.update(pcodec.g1_uncompressed_be(cv.fq, g1_sx))
    transcript = th.digest()
    g2_sp = keypair.hash_to_g2(cv, transcript)
    g2_spx = hc.g2_mul_any(cv, g2_sp, delta_prv)
    return transcript, g1_sx, g2_sp, g2_spx


def _apply_delta(zkey_bytes: bytes, delta_prv: int, g1_s,
                 contribution: ZkeyContribution, device):
    bf, cv, meta, vk = _parse(zkey_bytes)
    fr = cv.fr
    mp = read_mpc_params(cv, bf.read_section(10))

    transcript, g1_sx, g2_sp, g2_spx = _transcript_and_key(
        cv, mp, delta_prv, g1_s)

    vk["delta_1"] = hc.g1_mul(cv, vk["delta_1"], delta_prv)
    vk["delta_2"] = hc.g2_mul_any(cv, vk["delta_2"], delta_prv)

    c = contribution
    c.g1_s, c.g1_sx, c.g2_spx = g1_s, g1_sx, g2_spx
    c.transcript = transcript
    c.delta_after = vk["delta_1"]
    mp.contributions.append(c)

    inv_delta = pow(delta_prv, fr.p - 2, fr.p)
    n_l = meta["n_vars"] - meta["n_public"] - 1
    sec8, sec9 = ptau_ops._apply_keys(
        cv, False, [(bf.read_section(8), n_l, inv_delta, 1),
                    (bf.read_section(9), meta["domain"], inv_delta, 1)], device)
    out = _rebuild(bf, cv, meta, vk, sec8, sec9, mp)

    ch = Blake2b(64)
    hash_pubkey(ch, cv, c)
    return out, ch.digest()


def contribute(zkey_bytes: bytes, name: str = "", entropy=None,
               rng=None, device=None) -> tuple[bytes, bytes]:
    """Random delta contribution.  Returns (new zkey bytes, contributionHash).
    device: None means the card; raises without one."""
    device = devmod.resolve(device)
    _, cv, _, _ = _parse(zkey_bytes)
    if rng is None:
        rng = ptau_ops.random_rng(entropy)
    delta_prv = keypair.field_from_rng(cv.fr, rng)
    g1_s = keypair.g1_from_rng(cv, rng)
    return _apply_delta(zkey_bytes, delta_prv, g1_s,
                        ZkeyContribution(name=name, type=0), device)


def beacon(zkey_bytes: bytes, beacon_hash: bytes, num_iterations_exp: int,
           name: str = "", device=None) -> tuple[bytes, bytes]:
    """Beacon contribution (reference src/zkey_beacon.js)."""
    device = devmod.resolve(device)
    _, cv, _, _ = _parse(zkey_bytes)
    if not (0 < num_iterations_exp < 64):
        raise ValueError("Invalid numIterationsExp")
    rng = ptau_ops.rng_from_beacon(beacon_hash, num_iterations_exp)
    delta_prv = keypair.field_from_rng(cv.fr, rng)
    g1_s = keypair.g1_from_rng(cv, rng)
    return _apply_delta(zkey_bytes, delta_prv, g1_s,
                        ZkeyContribution(name=name, type=1,
                                         num_iterations_exp=num_iterations_exp,
                                         beacon_hash=beacon_hash), device)


# ---------------------------------------------------------------------------
# verification

def _section_same_ratio(cv, lem1: bytes, lem2: bytes, n: int, g2sp, g2spx,
                        rng, device) -> bool:
    """Random-linear-combination equality of two G1 sections up to the ratio
    attested by (g2sp, g2spx) (verify_frominit.js:234-269): two MSMs with
    one draw of n scalars below 2^32."""
    if n == 0:
        return True
    scalars = ptau_ops._u64_limbs(cv.fr, rng.integers(0, 1 << 32, n, dtype=np.uint64),
                                  device)
    R1 = ptau_ops._msm_lem(cv, lem1, scalars, False, device)
    R2 = ptau_ops._msm_lem(cv, lem2, scalars, False, device)
    return hc.same_ratio(cv, R1, R2, g2sp, g2spx)


def _tau_differences(cv, tau_lem, domain: int, device) -> bytes:
    """LEM points tau^(n+i) G - tau^i G for i < n = domain from the .ptau's
    tauG1 section: one batched Jacobian add and one batched inversion."""
    f = ptau_ops._f(cv, False, device)
    sz = 2 * cv.fq.n8
    hi = jac.from_affine(f, *ptau_ops._lem_points(cv, memoryview(tau_lem)[domain * sz:],
                                                  domain, False, device))
    lo = jac.from_affine(f, *ptau_ops._lem_points(cv, tau_lem, domain, False, device))
    diff = jac.jac_add(f, hi, jac.jac_neg(f, lo))
    return ptau_ops._lem_bytes(cv, False, *jac.to_affine_batch(f, diff, f.batch_inv))


def verify_from_init(init_bytes: bytes, ptau, zkey_bytes: bytes,
                     logger=None, rng=None, device=None) -> bool:
    """reference src/zkey_verify_frominit.js:32-418.  rng: a numpy Generator
    (its draws, in the JAX package's order, weight the section checks).
    device: None means the card; raises without one."""
    device = devmod.resolve(device)

    def err(msg):
        if logger:
            logger.error(msg)
        return False

    bf, cv, meta, vk = _parse(zkey_bytes)
    fq, fr = cv.fq, cv.fr
    mp = read_mpc_params(cv, bf.read_section(10))
    if rng is None:
        rng = np.random.default_rng(secrets.randbits(64))

    # delta chain
    acc = Blake2b(64)
    acc.update(mp.cs_hash)
    cur_delta = cv.g1
    for i, c in enumerate(mp.contributions):
        ours = Blake2b.from_partial(acc.to_partial())
        ours.update(pcodec.g1_uncompressed_be(fq, c.g1_s))
        ours.update(pcodec.g1_uncompressed_be(fq, c.g1_sx))
        if ours.digest() != c.transcript:
            return err(f"INVALID({i}): Inconsistent transcript")
        g2_sp = keypair.hash_to_g2(cv, c.transcript)
        if not hc.same_ratio(cv, c.g1_s, c.g1_sx, g2_sp, c.g2_spx):
            return err(f"INVALID({i}): public key G1 and G2 do not have the "
                       "same ratio")
        if not hc.same_ratio(cv, cur_delta, c.delta_after, g2_sp, c.g2_spx):
            return err(f"INVALID({i}): deltaAfter does not follow the "
                       "public key")
        if c.type == 1:
            brng = ptau_ops.rng_from_beacon(c.beacon_hash,
                                            c.num_iterations_exp)
            prv = keypair.field_from_rng(fr, brng)
            g1_s = keypair.g1_from_rng(cv, brng)
            if g1_s != c.g1_s:
                return err(f"INVALID({i}): Key of the beacon does not "
                           "match. g1_s")
            if hc.g1_mul(cv, g1_s, prv) != c.g1_sx:
                return err(f"INVALID({i}): Key of the beacon does not "
                           "match. g1_sx")
        hash_pubkey(acc, cv, c)
        cur_delta = c.delta_after

    bfi, cvi, metai, vki = _parse(init_bytes)
    if cvi is not cv:
        return err("INVALID: Different curves")
    if (metai["n_vars"] != meta["n_vars"]
            or metai["n_public"] != meta["n_public"]
            or metai["domain"] != meta["domain"]):
        return err("INVALID: Different circuit parameters")
    if vk["alpha_1"] != vki["alpha_1"]:
        return err("INVALID: Invalid alpha1")
    if vk["beta_1"] != vki["beta_1"]:
        return err("INVALID: Invalid beta1")
    if vk["beta_2"] != vki["beta_2"]:
        return err("INVALID: Invalid beta2")
    if vk["gamma_2"] != vki["gamma_2"]:
        return err("INVALID: Invalid gamma2")
    if vk["delta_1"] != cur_delta:
        return err("INVALID: Invalid delta1")
    if not hc.same_ratio(cv, cv.g1, cur_delta, cv.g2, vk["delta_2"]):
        return err("INVALID: Invalid delta2")

    mpi = read_mpc_params(cv, bfi.read_section(10))
    if mp.cs_hash != mpi.cs_hash:
        return err("INVALID: Circuit does not match")

    s_g1 = 2 * fq.n8
    n_l = meta["n_vars"] - meta["n_public"] - 1
    if len(bf.read_section(8)) != s_g1 * n_l:
        return err("INVALID: Invalid L section size")
    if len(bf.read_section(9)) != s_g1 * meta["domain"]:
        return err("INVALID: Invalid H section size")
    for sid, nm in ((3, "IC"), (4, "Coeffs"), (5, "A"), (6, "B1"), (7, "B2")):
        if bf.read_section(sid) != bfi.read_section(sid):
            return err(f"INVALID: {nm} section is not identical")

    # L section ratio check: init/delta2_init vs new/delta2_new
    if not _section_same_ratio(cv, bfi.read_section(8), bf.read_section(8),
                               n_l, vk["delta_2"], vki["delta_2"], rng, device):
        return err("L section does not match")

    # H section check (sameRatioH, verify_frominit.js:271-351): weights r_i
    # below 2^62 but the last, which is 0
    domain = meta["domain"]
    power = domain.bit_length() - 1
    rs = np.append(rng.integers(0, 1 << 62, domain - 1, dtype=np.uint64), np.uint64(0))
    rs = ptau_ops._u64_limbs(fr, rs, device)

    # R1 = sum r_i (tau^{n+i} - tau^i) G from the ptau tau section
    diff_lem = _tau_differences(cv, ptau.sections[2], domain, device)
    R1 = ptau_ops._msm_lem(cv, diff_lem, rs, False, device)

    # R2 = sum fft(applyKey(r, first, inc))_i H_i
    frctx = ftorch.get_ctx(fr.name)
    first = (fr.p - 2) if power < fr.s else (
        pow(fr.shift, 1 << fr.s, fr.p) - 1) % fr.p
    inc = fr.w[power + 1] if power < fr.s else fr.shift
    shifted = nttmod.apply_powers(frctx, ftorch.to_mont(frctx, rs), first, inc)
    ev = ftorch.from_mont(frctx, nttmod.ntt(frctx, shifted))
    R2 = ptau_ops._msm_lem(cv, bf.read_section(9), ev, False, device)

    if not hc.same_ratio(cv, R1, R2, vk["delta_2"], vki["delta_2"]):
        return err("H section does not match")
    return True


def verify_from_r1cs(r1cs, ptau, zkey_bytes: bytes, logger=None,
                     rng=None, device=None) -> bool:
    """Regenerate the init zkey then verify (src/zkey_verify_fromr1cs.js)."""
    device = devmod.resolve(device)
    init = groth16_setup.setup_from_ptau(r1cs, ptau, device=device)
    return verify_from_init(init, ptau, zkey_bytes, logger=logger, rng=rng,
                            device=device)
