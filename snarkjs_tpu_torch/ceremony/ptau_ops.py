"""Powers-of-tau ceremony operations (port of snarkjs_tpu/ceremony/ptau_ops.py;
reference src/powersoftau_*.js).

Whole sections go to the card as batches of limb tensors, and every field op
of a batch is a K-field launch (through `ftorch`):

* batchApplyKey (`apply_key_g1/g2`, `contribute`, `beacon`,
  `challenge_contribute`): the powers first * inc^i from two host tables of
  about sqrt(n) entries and one Montgomery product, then one batched
  double-and-add of jac.DEVICE_BATCH points for every G1 section of a
  contribution together (2, 4, 5) and one for the G2 sections (3, 6).
* the point codecs (`lem_to_c`, `c_to_lem`, `u_to_lem`, `lem_to_u`): one
  Montgomery conversion a batch; decompression takes its square roots by
  exponentiation on the card (Fq: a^((p+1)/4); Fq2: the steps of
  `keypair._f2_sqrt`), and a point off the curve raises ValueError.
* preparePhase2's group iNTT (`prepare_phase2`, `convert`,
  `group_lagrange_lem`): the JAX package runs one size of one section at a
  time, k + 1 full scalar multiplications for a 2^k block.  Here every
  block of a group (sections 12, 14 and 15 on G1, 13 on G2) goes through
  the radix-2 stages together: the stage-i twiddle of lane `off` is
  w_{2^(i+1)}^-off whatever the block's size, so stage i is one batched
  scalar multiplication over all blocks still that wide.  Each block's 1/n
  rides in the batch of its last stage (the lo lanes by 1/n, the hi lanes by
  the twiddle times 1/n), and stage 0 multiplies nothing.  A group of
  largest block 2^K costs K - 1 batches, not the JAX structure's sum of
  k + 1 over every block.
* verification MSMs go to `MSMContext.run` (K-scan), the Fr NTTs of the
  Lagrange check to `ntt.ntt` (K-mm-norm from 2^12).

The outputs are affine points, hashes and file bytes, so a different order
of work gives the same bytes as the JAX package.  On the card every size
goes through the kernels.  On a CPU device an apply-key or MSM of up to
HOST_MAX points, and a group iNTT block of up to HOST_IFFT_MAX_CPU points,
runs on host bigints instead, which keeps the tests fast.

Operations:
  new_accumulator      src/powersoftau_new.js:73-144
  contribute           src/powersoftau_contribute.js:33-117
  beacon               src/powersoftau_beacon.js:25+
  export_challenge     src/powersoftau_export_challenge.js:45-115
  challenge_contribute src/powersoftau_challenge_contribute.js:46-115
  import_response      src/powersoftau_import.js:28-95
  verify               src/powersoftau_verify.js:129-289,340-491
  prepare_phase2       src/powersoftau_preparephase2.js:24-49
  truncate             src/powersoftau_truncate.js:23-58
  convert              src/powersoftau_convert.js:25-45
  export_json          src/powersoftau_export_json.js
"""

from __future__ import annotations

import hashlib
import secrets

import numpy as np
import torch

from .. import device as devmod
from ..curves import host_curve as hc
from ..curves import jac
from ..curves import msm as msm_mod
from ..curves.gops import field_ops
from ..fields import ftorch
from ..formats import points as pcodec
from ..formats import ptau as ptau_fmt
from ..formats.ptau import (
    CONTRIB_BEACON, CONTRIB_MPC, Contribution, PtauFile, first_challenge_hash,
    pubkey_from_bytes, pubkey_size, pubkey_to_bytes,
)
from ..ntt import ntt as nttmod
from ..utils.blake2b import Blake2b
from ..utils.chacha import ChaCha
from . import keypair

HOST_MAX = 64             # apply-key and MSM: up to this many points on host bigints
HOST_IFFT_MAX_CPU = 256   # group iNTT blocks up to this size on host bigints (CPU only)


# ---------------------------------------------------------------------------
# RNGs (reference src/misc.js:182-228)

def random_rng(entropy: str | bytes | None = None) -> ChaCha:
    """blake2b(64 random bytes || entropy) -> BE u32 seed (misc.getRandomRng)."""
    h = hashlib.blake2b(digest_size=64)
    h.update(secrets.token_bytes(64))
    if entropy:
        h.update(entropy.encode() if isinstance(entropy, str) else entropy)
    return ChaCha(_seed_be(h.digest()))


def rng_from_beacon(beacon_hash: bytes, num_iterations_exp: int) -> ChaCha:
    """iterated sha256 (misc.rngFromBeaconParams, src/misc.js:201-228)."""
    cur = beacon_hash
    for _ in range(1 << num_iterations_exp):
        cur = hashlib.sha256(cur).digest()
    return ChaCha(_seed_be(cur))


def key_from_beacon(cv, challenge: bytes, beacon_hash: bytes,
                    num_iterations_exp: int) -> dict:
    """src/powersoftau_utils.js:361-368."""
    rng = rng_from_beacon(beacon_hash, num_iterations_exp)
    return keypair.create_ptau_key(cv, challenge, rng)


def _seed_be(h: bytes):
    return [int.from_bytes(h[4 * i:4 * i + 4], "big") for i in range(8)]


def parse_beacon_hash(s: str) -> bytes:
    b = bytes.fromhex(s[2:] if s.startswith("0x") else s)
    if len(b) == 0 or len(b) % 2 != 0:
        raise ValueError("Invalid beacon hash")
    return b


# ---------------------------------------------------------------------------
# limbs on the card

def _sz(cv, g2: bool) -> int:
    return (4 if g2 else 2) * cv.fq.n8


def _f(cv, g2: bool, device):
    return field_ops(ftorch.get_ctx(cv.fq.name), 2 if g2 else 1, device)


def _tree(fn, a):
    return tuple(_tree(fn, x) for x in a) if isinstance(a, tuple) else fn(a)


def _lem_points(cv, lem, n: int, g2: bool, device):
    """n LEM points -> (x, y, inf) Montgomery limb tensors on `device`."""
    conv = pcodec.g2_lem_from_bytes if g2 else pcodec.g1_lem_from_bytes
    x, y, inf = conv(cv.fq, lem, n)
    put = lambda a: ftorch.to_tensor(a, device)
    return _tree(put, x), _tree(put, y), torch.from_numpy(inf).to(device)


def _lem_bytes(cv, g2: bool, x, y, inf) -> bytes:
    """(x, y, inf) limb tensors -> LEM bytes (infinity all zeros)."""
    conv = pcodec.g2_lem_to_bytes if g2 else pcodec.g1_lem_to_bytes
    return conv(cv.fq, _tree(ftorch.to_numpy, x), _tree(ftorch.to_numpy, y),
                inf.cpu().numpy())


def _powers(fr, first: int, inc: int, n: int, device):
    """first * inc^i for i < n as plain (NL, n) limbs on `device`: a host
    table of b ~ sqrt(n) powers (Montgomery form) times one of n / b stride
    powers (plain form), one Montgomery product."""
    b = 1 << (max(n - 1, 1).bit_length() + 1) // 2
    lo, cur = [], first % fr.p
    for _ in range(b):
        lo.append(fr.to_mont(cur))
        cur = cur * inc % fr.p
    inc_b, hi, cur = pow(inc, b, fr.p), [], 1
    for _ in range(-(-n // b)):
        hi.append(cur)
        cur = cur * inc_b % fr.p
    ctx = ftorch.get_ctx(fr.name)
    lo_t = ftorch.to_tensor(ftorch.np_from_ints(fr, lo), device)
    hi_t = ftorch.to_tensor(ftorch.np_from_ints(fr, hi), device)
    prod = ftorch.mont_mul(ctx, lo_t[:, None, :], hi_t[:, :, None])
    return prod.reshape(fr.nl, -1)[:, :n]


def _const(fp, v: int, device):
    """(NL, 1) limbs of the int v."""
    return ftorch.to_tensor(ftorch.np_from_int(fp, v), device)[:, None]


# ---------------------------------------------------------------------------
# batchApplyKey — points[i] *= first * inc^i

def _g_mul(cv, g2, P, k):
    return hc.g2_mul_any(cv, P, k) if g2 else hc.g1_mul(cv, P, k)


def _g_add(cv, g2, P, Q):
    return hc.g2_add(cv, P, Q) if g2 else hc.g1_add(cv, P, Q)


def _g_neg(cv, g2, P):
    return hc.g2_neg(cv, P) if g2 else hc.g1_neg(cv, P)


def _apply_keys(cv, g2: bool, parts, device=None) -> list:
    """batchApplyKey over several LEM sections of one group at once.

    parts: [(lem, n, first, inc)]; returns the LEM output of each.  In
    batched double-and-adds of jac.DEVICE_BATCH points on `device` (None:
    the card); on a CPU device up to HOST_MAX points in all on host bigints."""
    fq, fr = cv.fq, cv.fr
    device = devmod.resolve(device)
    total = sum(n for _, n, _, _ in parts)
    if device.type == "cpu" and total <= HOST_MAX:
        to_ints = pcodec.g2_lem_to_ints if g2 else pcodec.g1_lem_to_ints
        from_ints = pcodec.g2_lem_from_ints if g2 else pcodec.g1_lem_from_ints
        outs = []
        for lem, n, first, inc in parts:
            out, t = [], first % fr.p
            for P in to_ints(fq, lem, n):
                out.append(None if P is None else _g_mul(cv, g2, P, t))
                t = t * inc % fr.p
            outs.append(from_ints(fq, out))
        return outs
    f = _f(cv, g2, device)
    sz = _sz(cv, g2)
    lem = b"".join(bytes(memoryview(l)[:n * sz]) for l, n, _, _ in parts)
    ks = torch.cat([_powers(fr, first, inc, n, device) for _, n, first, inc in parts], dim=1)
    out = bytearray()
    for lo in range(0, total, jac.DEVICE_BATCH):
        m = min(total, lo + jac.DEVICE_BATCH) - lo
        x, y, inf = _lem_points(cv, memoryview(lem)[lo * sz:], m, g2, device)
        out += _lem_bytes(cv, g2, *jac.scalar_mul_affine(f, x, y, inf, ks[:, lo:lo + m]))
    outs, pos = [], 0
    for _, n, _, _ in parts:
        outs.append(bytes(out[pos * sz:(pos + n) * sz]))
        pos += n
    return outs


def apply_key_g1(cv, lem, n: int, first: int, inc: int, device=None) -> bytes:
    """G1.batchApplyKey on a LEM section: point i times first * inc^i."""
    return _apply_keys(cv, False, [(lem, n, first, inc)], device)[0]


def apply_key_g2(cv, lem, n: int, first: int, inc: int, device=None) -> bytes:
    return _apply_keys(cv, True, [(lem, n, first, inc)], device)[0]


# ---------------------------------------------------------------------------
# section wire-format conversions (LEM <-> U / C)

def _coords(cv, data, n: int, g2: bool, device, big_endian: bool):
    """n points' coordinates as one (NL, n * k) limb tensor on `device`, k = 2
    (G1) or 4 (G2), in LEM order (G2: x0 x1 y0 y1) whatever the input's."""
    fq = cv.fq
    k = 4 if g2 else 2
    raw = np.frombuffer(data, dtype=np.uint8, count=n * k * fq.n8).reshape(n, k, fq.n8)
    if big_endian:
        raw = raw[:, :, ::-1]
        if g2:
            raw = raw.reshape(n, 2, 2, fq.n8)[:, :, ::-1].reshape(n, k, fq.n8)
    u16 = np.ascontiguousarray(raw).view("<u2").reshape(n * k, fq.nl)
    return ftorch.to_tensor(u16.T, device)


def _be_bytes(cv, plain, n: int, g2: bool):
    """(NL, n * k) plain limbs in LEM order -> (n, k * n8) big-endian bytes,
    F2 components swapped (c1 || c0)."""
    fq = cv.fq
    k = 4 if g2 else 2
    le = np.ascontiguousarray(ftorch.to_numpy(plain).T.astype("<u2")).view(np.uint8)
    be = le.reshape(n, k, fq.n8)[:, :, ::-1]
    if g2:
        be = be.reshape(n, 2, 2, fq.n8)[:, :, ::-1]
    return np.ascontiguousarray(be).reshape(n, k * fq.n8)


def _gt_half(fp, a):
    """a > (p - 1) / 2 for plain (NL, *batch) limbs, decided by the most
    significant limb where a and (p - 1) / 2 differ."""
    c = _const(fp, fp.p >> 1, a.device).reshape((fp.nl,) + (1,) * (a.dim() - 1))
    ne = a != c
    weight = torch.arange(1, fp.nl + 1, device=a.device).reshape(c.shape)
    top = (ne * weight).argmax(dim=0, keepdim=True)
    return (a > c).gather(0, top)[0]


def _sign(fp, y, g2: bool):
    """The C encoding's 0x80 flag of plain y: y > (p - 1) / 2, on Fq2 ordered
    by c1 first, then c0 (keypair._f2_gt against -y)."""
    if not g2:
        return _gt_half(fp, y)
    return _gt_half(fp, y[1]) | (ftorch.is_zero(None, y[1]) & _gt_half(fp, y[0]))


def lem_to_u(cv, lem, n: int, g2: bool, device=None) -> bytes:
    """batchLEMtoU: n LEM points -> big-endian standard affine coordinates,
    F2 components swapped (c1 || c0); infinity stays all zeros.  The
    Montgomery reduction of every coordinate runs as one batch on `device`
    (None: the card)."""
    device = devmod.resolve(device)
    ctx = ftorch.get_ctx(cv.fq.name)
    plain = ftorch.from_mont(ctx, _coords(cv, lem, n, g2, device, False))
    return _be_bytes(cv, plain, n, g2).tobytes()


def lem_to_c(cv, lem, n: int, g2: bool, device=None) -> bytes:
    """batchLEMtoC: compressed big-endian x with the 0x80 sign and 0x40
    infinity flags in its first byte; one batch on `device`."""
    device = devmod.resolve(device)
    fq = cv.fq
    k = 4 if g2 else 2
    ctx = ftorch.get_ctx(fq.name)
    mont = _coords(cv, lem, n, g2, device, False)
    inf = (mont == 0).reshape(fq.nl, n, k).all(dim=2).all(dim=0)
    plain = ftorch.from_mont(ctx, mont)
    c = plain.reshape(fq.nl, n, k)
    sign = _sign(fq, (c[:, :, 2], c[:, :, 3]) if g2 else c[:, :, 1], g2)
    out = _be_bytes(cv, plain, n, g2)[:, :k // 2 * fq.n8].copy()
    inf, sign = inf.cpu().numpy(), sign.cpu().numpy()
    out[sign & ~inf, 0] |= 0x80
    out[inf] = 0
    out[inf, 0] = 0x40
    return out.tobytes()


def u_to_lem(cv, data, n: int, g2: bool, device=None) -> bytes:
    """batchUtoLEM: big-endian standard coordinates -> LEM, one Montgomery
    conversion on `device` (all zeros, infinity, stays all zeros)."""
    device = devmod.resolve(device)
    fq = cv.fq
    ctx = ftorch.get_ctx(fq.name)
    mont = ftorch.to_mont(ctx, _coords(cv, data, n, g2, device, True))
    le = np.ascontiguousarray(ftorch.to_numpy(mont).T.astype("<u2"))
    return le.tobytes()


def _f2_exp(f, a, e: int):
    """a^e on Fq2 (Montgomery), square and multiply from the top bit; e > 0."""
    r = None
    for bit in bin(e)[2:]:
        if r is not None:
            r = f.sqr(r)
        if bit == "1":
            r = a if r is None else f.mul(r, a)
    return r


def _sqrt(cv, g2: bool, a, device):
    """Square roots of Montgomery a (batched) and whether each is one.  Fq:
    a^((p+1)/4); Fq2: keypair._f2_sqrt's steps with its branch as a select."""
    fq = cv.fq
    p = fq.p
    f = _f(cv, g2, device)
    if not g2:
        y = ftorch.exp_const(f.ctx, a, (p + 1) // 4)
        return y, ftorch.eq(None, f.sqr(y), a)
    a1 = _f2_exp(f, a, (p - 3) // 4)
    alpha = f.mul(f.sqr(a1), a)
    x0 = f.mul(a1, a)
    bs = f.batch_shape(a)
    minus_one = _const(fq, fq.to_mont(p - 1), device).expand((fq.nl,) + bs)
    is_m1 = ftorch.eq(None, alpha[0], minus_one) & ftorch.is_zero(None, alpha[1])
    b = _f2_exp(f, f.add(f.one(bs), alpha), (p - 1) // 2)
    x = f.select(is_m1, (f.fq.neg(x0[1]), x0[0]), f.mul(b, x0))
    sq = f.sqr(x)
    return x, ftorch.eq(None, sq[0], a[0]) & ftorch.eq(None, sq[1], a[1])


def c_to_lem(cv, data, n: int, g2: bool, device=None) -> bytes:
    """batchCtoLEM: decompress n points, one batch on `device`; a point whose
    x^3 + b has no square root raises ValueError."""
    device = devmod.resolve(device)
    fq = cv.fq
    ctx = ftorch.get_ctx(fq.name)
    f = _f(cv, g2, device)
    w = (2 if g2 else 1) * fq.n8
    raw = np.frombuffer(data, dtype=np.uint8, count=n * w).reshape(n, w).copy()
    flags = raw[:, 0].copy()
    raw[:, 0] &= 0x3F
    inf = torch.from_numpy((flags & 0x40) != 0).to(device)
    sign = torch.from_numpy((flags & 0x80) != 0).to(device)
    # x as coordinates of a point with y = x, so _coords reads the C layout
    xx = np.concatenate([raw, raw], axis=1)
    xm = ftorch.to_mont(ctx, _coords(cv, xx, n, g2, device, True))
    if g2:
        xm = xm.reshape(fq.nl, n, 4)
        x = (xm[:, :, 0].contiguous(), xm[:, :, 1].contiguous())
        b = (_const(fq, fq.to_mont(cv.b2[0]), device), _const(fq, fq.to_mont(cv.b2[1]), device))
        b = _tree(lambda t: t.expand(fq.nl, n), b)
    else:
        x = xm.reshape(fq.nl, n, 2)[:, :, 0].contiguous()
        b = _const(fq, fq.to_mont(cv.b), device).expand(fq.nl, n)
    y, ok = _sqrt(cv, g2, f.add(f.mul(f.sqr(x), x), b), device)
    if not bool((ok | inf).all()):
        raise ValueError("point is not on the curve")
    plain_y = _tree(lambda t: ftorch.from_mont(ctx, t), y)
    y = f.select(_sign(fq, plain_y, g2) != sign, f.neg(y), y)
    return _lem_bytes(cv, g2, x, y, inf)


# section metadata: sid -> (g2?, count(power), first/inc keys)
def _sections(power: int):
    n = 1 << power
    return [
        (2, False, 2 * n - 1, "tauG1"),
        (3, True, n, "tauG2"),
        (4, False, n, "alphaTauG1"),
        (5, False, n, "betaTauG1"),
        (6, True, 1, "betaG2"),
    ]


def _firsts(key: dict) -> dict:
    alpha, beta_ = key["alpha"]["prvKey"], key["beta"]["prvKey"]
    return {2: 1, 3: 1, 4: alpha, 5: beta_, 6: beta_}


def _apply_sections(cv, power: int, lems: dict, key: dict, device) -> dict:
    """Every section of an accumulator times its key powers: the G1
    sections (2, 4, 5) in one call of `_apply_keys`, the G2 ones (3, 6) in
    another.  lems: sid -> LEM; returns sid -> LEM."""
    tau = key["tau"]["prvKey"]
    first = _firsts(key)
    out = {}
    for g2 in (False, True):
        secs = [(sid, n) for sid, is_g2, n, _ in _sections(power) if is_g2 == g2]
        res = _apply_keys(cv, g2, [(lems[sid], n, first[sid], tau) for sid, n in secs],
                          device)
        out.update({sid: r for (sid, _), r in zip(secs, res)})
    return out


# ---------------------------------------------------------------------------
# operations

def new_accumulator(cv, power: int) -> PtauFile:
    """Blank accumulator: every point is the group generator (tau=1)."""
    pt = PtauFile(cv, power, power)
    n = 1 << power
    g1b = ptau_fmt.g1_lem(cv.fq, cv.g1)
    g2b = ptau_fmt.g2_lem(cv.fq, cv.g2)
    pt.sections[2] = g1b * (2 * n - 1)
    pt.sections[3] = g2b * n
    pt.sections[4] = g1b * n
    pt.sections[5] = g1b * n
    pt.sections[6] = g2b
    return pt


def contribute(pt: PtauFile, name: str = "", entropy=None,
               rng: ChaCha | None = None, logger=None,
               device=None) -> tuple[PtauFile, bytes]:
    """MPC contribution: scale all sections by the new key's powers
    (src/powersoftau_contribute.js:33-117).  Returns (new ptau, responseHash).
    device: None means the card; raises without one."""
    device = devmod.resolve(device)
    cv = pt.curve
    if pt.power != pt.ceremony_power:
        raise ValueError("This file has been reduced. "
                         "You cannot contribute into a reduced file.")
    last_challenge = pt.last_challenge()
    if rng is None:
        rng = random_rng(entropy)
    key = keypair.create_ptau_key(cv, last_challenge, rng)
    return _apply_contribution(pt, key, Contribution(name=name, type=CONTRIB_MPC),
                               device=device)


def beacon(pt: PtauFile, beacon_hash: bytes, num_iterations_exp: int,
           name: str = "", logger=None, device=None) -> tuple[PtauFile, bytes]:
    """Deterministic beacon contribution (src/powersoftau_beacon.js)."""
    device = devmod.resolve(device)
    cv = pt.curve
    if not (0 < num_iterations_exp < 64):
        raise ValueError("Invalid numIterationsExp")
    last_challenge = pt.last_challenge()
    key = key_from_beacon(cv, last_challenge, beacon_hash, num_iterations_exp)
    contrib = Contribution(name=name, type=CONTRIB_BEACON,
                           num_iterations_exp=num_iterations_exp,
                           beacon_hash=beacon_hash)
    return _apply_contribution(pt, key, contrib, device=device)


def _hash_section(hasher, cv, lem, n: int, g2: bool, conv, device):
    """Absorb a section in the wire format `conv` gives (one batch)."""
    hasher.update(conv(cv, lem, n, g2, device))


def _apply_contribution(pt: PtauFile, key: dict, contrib: Contribution, device=None):
    cv = pt.curve
    contrib.key = key
    new = PtauFile(cv, pt.power, pt.ceremony_power,
                   contributions=list(pt.contributions))
    new.sections.update(_apply_sections(cv, pt.power, pt.sections, key, device))

    response_h = Blake2b(64)
    response_h.update(pt.last_challenge())
    firsts = {}
    for sid, g2, n, _name in _sections(pt.power):
        _hash_section(response_h, cv, new.sections[sid], n, g2, lem_to_c, device)
        conv = pcodec.g2_lem_to_ints if g2 else pcodec.g1_lem_to_ints
        firsts[sid] = conv(cv.fq, new.sections[sid], min(2, n))

    contrib.tau_g1 = firsts[2][1]
    contrib.tau_g2 = firsts[3][1]
    contrib.alpha_g1 = firsts[4][0]
    contrib.beta_g1 = firsts[5][0]
    contrib.beta_g2 = firsts[6][0]

    contrib.partial_hash = response_h.to_partial()
    response_hash = contrib.response_hash(cv)

    next_h = hashlib.blake2b(digest_size=64)
    next_h.update(response_hash)
    for sid, g2, n, _name in _sections(pt.power):
        _hash_section(next_h, cv, new.sections[sid], n, g2, lem_to_u, device)
    contrib.next_challenge = next_h.digest()
    new.contributions.append(contrib)
    return new, response_hash


def export_challenge(pt: PtauFile, device=None) -> bytes:
    """Bellman-compatible challenge file: lastResponseHash || U sections
    (src/powersoftau_export_challenge.js)."""
    device = devmod.resolve(device)
    cv = pt.curve
    if pt.contributions:
        last = pt.contributions[-1]
        last_response = last.response_hash(cv)
        cur_challenge = last.next_challenge
    else:
        last_response = hashlib.blake2b(digest_size=64).digest()
        cur_challenge = first_challenge_hash(cv, pt.power)

    out = bytearray(last_response)
    to_hash = hashlib.blake2b(digest_size=64)
    to_hash.update(last_response)
    for sid, g2, n, _name in _sections(pt.power):
        u = lem_to_u(cv, pt.sections[sid], n, g2, device)
        out += u
        to_hash.update(u)
    if to_hash.digest() != cur_challenge:
        raise ValueError("PTau file is corrupted. Calculated new challenge "
                         "hash does not match with the declared one")
    return bytes(out)


def challenge_contribute(cv, challenge: bytes, entropy=None,
                         rng: ChaCha | None = None, device=None) -> bytes:
    """Produce a Bellman-compatible compressed response file
    (src/powersoftau_challenge_contribute.js)."""
    device = devmod.resolve(device)
    fq = cv.fq
    s_g1, s_g2 = 2 * fq.n8, 4 * fq.n8
    domain = (len(challenge) + s_g1 - 64 - s_g2) // (4 * s_g1 + s_g2)
    power = domain.bit_length() - 1
    if 1 << power != domain:
        raise ValueError("Invalid file size")

    challenge_hash = hashlib.blake2b(challenge, digest_size=64).digest()
    if rng is None:
        rng = random_rng(entropy)
    key = keypair.create_ptau_key(cv, challenge_hash, rng)

    lems, pos = {}, 64
    for sid, g2, n, _name in _sections(power):
        sz = (s_g2 if g2 else s_g1) * n
        lems[sid] = u_to_lem(cv, challenge[pos:pos + sz], n, g2, device)
        pos += sz
    outs = _apply_sections(cv, power, lems, key, device)
    out = bytearray(challenge_hash)
    for sid, g2, n, _name in _sections(power):
        out += lem_to_c(cv, outs[sid], n, g2, device)
    out += pubkey_to_bytes(cv, key, montgomery=False)
    return bytes(out)


def import_response(pt: PtauFile, response: bytes, name: str = "",
                    import_points: bool = True, device=None) -> PtauFile:
    """Import a compressed response into a new ptau
    (src/powersoftau_import.js:28-95).  Each group's sections are
    decompressed in one batch."""
    device = devmod.resolve(device)
    cv = pt.curve
    fq = cv.fq
    power = pt.power
    n = 1 << power
    sc_g1, sc_g2 = fq.n8, 2 * fq.n8
    expected = (64 + (2 * n - 1) * sc_g1 + n * sc_g2 + 2 * n * sc_g1 + sc_g2
                + 2 * fq.n8 * 6 + 4 * fq.n8 * 3)
    if len(response) != expected:
        raise ValueError("Size of the contribution is invalid")

    last_challenge = pt.last_challenge()
    prev_hash = response[:64]
    if last_challenge == b"\xff" * 64:
        last_challenge = prev_hash
        pt.contributions[-1].next_challenge = prev_hash
    if prev_hash != last_challenge:
        raise ValueError("Wrong contribution. This contribution is not "
                         "based on the previous hash")

    contrib = Contribution(name=name, type=CONTRIB_MPC)
    hasher = Blake2b(64)
    hasher.update(prev_hash)

    new = PtauFile(cv, power, pt.ceremony_power,
                   contributions=list(pt.contributions))
    chunks, pos = {}, 64
    for sid, g2, np_, _name in _sections(power):
        scg = sc_g2 if g2 else sc_g1
        chunks[sid] = response[pos:pos + np_ * scg]
        pos += np_ * scg
    hasher.update(response[64:pos])
    for g2 in (False, True):
        secs = [(sid, np_) for sid, is_g2, np_, _ in _sections(power) if is_g2 == g2]
        lem = c_to_lem(cv, b"".join(chunks[sid] for sid, _ in secs),
                       sum(np_ for _, np_ in secs), g2, device)
        off, sz = 0, _sz(cv, g2)
        for sid, np_ in secs:
            new.sections[sid] = lem[off * sz:(off + np_) * sz]
            off += np_
    singulars = {}
    for sid, g2, np_, _name in _sections(power):
        conv = pcodec.g2_lem_to_ints if g2 else pcodec.g1_lem_to_ints
        singulars[sid] = conv(fq, new.sections[sid], min(2, np_))

    contrib.tau_g1 = singulars[2][1]
    contrib.tau_g2 = singulars[3][1]
    contrib.alpha_g1 = singulars[4][0]
    contrib.beta_g1 = singulars[5][0]
    contrib.beta_g2 = singulars[6][0]

    contrib.partial_hash = hasher.to_partial()
    key_bytes = response[pos:pos + pubkey_size(cv)]
    contrib.key = pubkey_from_bytes(cv, key_bytes, montgomery=False)
    hasher2 = Blake2b.from_partial(contrib.partial_hash)
    hasher2.update(key_bytes)
    response_hash = hasher2.digest()

    if import_points:
        next_h = hashlib.blake2b(digest_size=64)
        next_h.update(response_hash)
        for sid, g2, np_, _name in _sections(power):
            next_h.update(lem_to_u(cv, new.sections[sid], np_, g2, device))
        contrib.next_challenge = next_h.digest()
    else:
        contrib.next_challenge = b"\xff" * 64
    new.contributions.append(contrib)
    return new


# ---------------------------------------------------------------------------
# verification (src/powersoftau_verify.js)

def _initial_contribution(cv, ceremony_power: int) -> Contribution:
    c = Contribution(tau_g1=cv.g1, tau_g2=cv.g2, alpha_g1=cv.g1,
                     beta_g1=cv.g1, beta_g2=cv.g2)
    c.next_challenge = first_challenge_hash(cv, ceremony_power)
    return c


def _verify_contribution(cv, cur: Contribution, prev: Contribution,
                         logger=None) -> bool:
    """Pairing checks linking cur to prev (src/powersoftau_verify.js:28-127)."""
    def err(msg):
        if logger:
            logger.error(msg)
        return False

    if cur.type == CONTRIB_BEACON:
        bkey = key_from_beacon(cv, prev.next_challenge, cur.beacon_hash,
                               cur.num_iterations_exp)
        for grp in ("tau", "alpha", "beta"):
            for nm in ("g1_s", "g1_sx", "g2_spx"):
                if cur.key[grp][nm] != bkey[grp][nm]:
                    return err(f"BEACON key ({grp}.{nm}) is not generated "
                               f"correctly in challenge #{cur.id}")

    for i, grp in enumerate(("tau", "alpha", "beta")):
        cur.key[grp]["g2_sp"] = keypair.get_g2sp(
            cv, i, prev.next_challenge,
            cur.key[grp]["g1_s"], cur.key[grp]["g1_sx"])
        if not hc.same_ratio(cv, cur.key[grp]["g1_s"], cur.key[grp]["g1_sx"],
                             cur.key[grp]["g2_sp"], cur.key[grp]["g2_spx"]):
            return err(f"INVALID key ({grp}) in challenge #{cur.id}")

    k = cur.key
    if not hc.same_ratio(cv, prev.tau_g1, cur.tau_g1,
                         k["tau"]["g2_sp"], k["tau"]["g2_spx"]):
        return err(f"INVALID tau*G1. challenge #{cur.id}")
    if not hc.same_ratio(cv, k["tau"]["g1_s"], k["tau"]["g1_sx"],
                         prev.tau_g2, cur.tau_g2):
        return err(f"INVALID tau*G2. challenge #{cur.id}")
    if not hc.same_ratio(cv, prev.alpha_g1, cur.alpha_g1,
                         k["alpha"]["g2_sp"], k["alpha"]["g2_spx"]):
        return err(f"INVALID alpha*G1. challenge #{cur.id}")
    if not hc.same_ratio(cv, prev.beta_g1, cur.beta_g1,
                         k["beta"]["g2_sp"], k["beta"]["g2_spx"]):
        return err(f"INVALID beta*G1. challenge #{cur.id}")
    if not hc.same_ratio(cv, k["beta"]["g1_s"], k["beta"]["g1_sx"],
                         prev.beta_g2, cur.beta_g2):
        return err(f"INVALID beta*G2. challenge #{cur.id}")
    return True


def _section_points(cv, pt: PtauFile, sid: int, g2: bool, n: int):
    conv = pcodec.g2_lem_to_ints if g2 else pcodec.g1_lem_to_ints
    return conv(cv.fq, pt.sections[sid], n)


def _u32_limbs(fr, vals, device):
    """numpy uint64 values below 2^32 -> plain (NL, n) limbs on `device`."""
    v = np.asarray(vals, dtype=np.uint64)
    limbs = np.zeros((fr.nl, v.shape[0]), dtype=np.uint32)
    limbs[0] = v & 0xFFFF
    limbs[1] = (v >> 16) & 0xFFFF
    return ftorch.to_tensor(limbs, device)


def _msm_lem(cv, lem, scalars, g2: bool, device=None):
    """MSM over a LEM point slice with plain scalars (a list of ints, or a
    plain (NL, n) limb tensor); affine ints, None for infinity.  Through
    `MSMContext.run` (K-scan) on `device`; on a CPU device up to HOST_MAX
    points on host bigints."""
    fq, fr = cv.fq, cv.fr
    device = devmod.resolve(device)
    n = scalars.shape[-1] if isinstance(scalars, torch.Tensor) else len(scalars)
    if n == 0:
        return None
    if device.type == "cpu" and n <= HOST_MAX:
        if isinstance(scalars, torch.Tensor):
            scalars = ftorch.np_to_ints(fr, scalars)
        conv = pcodec.g2_lem_to_ints if g2 else pcodec.g1_lem_to_ints
        acc = None
        for P, k in zip(conv(fq, lem, n), scalars):
            if P is None or k == 0:
                continue
            Q = _g_mul(cv, g2, P, int(k))
            acc = Q if acc is None else _g_add(cv, g2, acc, Q)
        return acc
    if not isinstance(scalars, torch.Tensor):
        scalars = ftorch.to_tensor(ftorch.np_from_ints(fr, scalars), device)
    m = msm_mod.MSMContext(ftorch.get_ctx(fq.name), fq, extension=2 if g2 else 1)
    x, y, inf = _lem_points(cv, lem, n, g2, device)
    res = m.run(x, y, inf, scalars.to(device))
    return msm_mod.host_jac_to_affine(fq, res, 2 if g2 else 1)


def verify(pt: PtauFile, logger=None, rng: "np.random.Generator" = None,
           device=None) -> bool:
    """Full ceremony verification (src/powersoftau_verify.js:129-289)."""
    device = devmod.resolve(device)
    cv = pt.curve
    power = pt.power

    def err(msg):
        if logger:
            logger.error(msg)
        return False

    if not pt.contributions:
        return err("This file has no contribution! "
                   "It cannot be used in production")

    initial = _initial_contribution(cv, pt.ceremony_power)
    cur = pt.contributions[-1]
    prev = pt.contributions[-2] if len(pt.contributions) > 1 else initial
    if not _verify_contribution(cv, cur, prev, logger):
        return False

    if rng is None:
        rng = np.random.default_rng(secrets.randbits(64))

    next_h = hashlib.blake2b(digest_size=64)
    next_h.update(cur.response_hash(cv))

    # random-linear-combination section consistency scan (:340-396):
    # R1 = sum r_i P_i (i<n-1), R2 = sum r_i P_{i+1}; then
    # sameRatio(R1, R2, G2, tauG2) proves P_{i+1} = tau P_i for all i.
    results = {}
    for sid, g2, n, name in _sections(power):
        if sid == 6:
            next_h.update(lem_to_u(cv, pt.sections[sid], 1, True, device))
            results[6] = _section_points(cv, pt, 6, True, 1)[0]
            continue
        next_h.update(lem_to_u(cv, pt.sections[sid], n, g2, device))
        scalars = _u32_limbs(cv.fr, rng.integers(0, 1 << 32, n - 1, dtype=np.uint64),
                             device)
        sz = _sz(cv, g2)
        sec = memoryview(pt.sections[sid])
        R1 = _msm_lem(cv, sec[:(n - 1) * sz], scalars, g2, device)
        R2 = _msm_lem(cv, sec[sz:n * sz], scalars, g2, device)
        pts01 = _section_points(cv, pt, sid, g2, min(2, n))
        results[sid] = (R1, R2, pts01)

    rt1_r1, rt1_r2, tau1_pts = results[2]
    if not hc.same_ratio(cv, rt1_r1, rt1_r2, cv.g2, cur.tau_g2):
        return err("tauG1 section. Powers do not match")
    if tau1_pts[0] != cv.g1:
        return err("First element of tau*G1 section must be the generator")
    if tau1_pts[1] != cur.tau_g1:
        return err("Second element of tau*G1 section does not match the "
                   "one in the contribution section")

    rt2_r1, rt2_r2, tau2_pts = results[3]
    if not hc.same_ratio(cv, cv.g1, cur.tau_g1, rt2_r1, rt2_r2):
        return err("tauG2 section. Powers do not match")
    if tau2_pts[0] != cv.g2:
        return err("First element of tau*G2 section must be the generator")
    if tau2_pts[1] != cur.tau_g2:
        return err("Second element of tau*G2 section does not match the "
                   "one in the contribution section")

    ra_r1, ra_r2, a_pts = results[4]
    if not hc.same_ratio(cv, ra_r1, ra_r2, cv.g2, cur.tau_g2):
        return err("alphaTauG1 section. Powers do not match")
    if a_pts[0] != cur.alpha_g1:
        return err("First element of alpha*tau*G1 section (alpha*G1) does "
                   "not match the one in the contribution section")

    rb_r1, rb_r2, b_pts = results[5]
    if not hc.same_ratio(cv, rb_r1, rb_r2, cv.g2, cur.tau_g2):
        return err("betaTauG1 section. Powers do not match")
    if b_pts[0] != cur.beta_g1:
        return err("First element of beta*tau*G1 section (beta*G1) does "
                   "not match the one in the contribution section")

    if results[6] != cur.beta_g2:
        return err("betaG2 element in betaG2 section does not match the "
                   "one in the contribution section")

    if power == pt.ceremony_power:
        if next_h.digest() != cur.next_challenge:
            return err("Hash of the values does not match the next "
                       "challenge of the last contributor")

    # verify the remaining contribution chain
    for i in range(len(pt.contributions) - 2, -1, -1):
        c = pt.contributions[i]
        p = pt.contributions[i - 1] if i > 0 else initial
        if not _verify_contribution(cv, c, p, logger):
            return False

    # phase-2 Lagrange sections (:398-491)
    if all(sid in pt.sections for sid in (12, 13, 14, 15)):
        for tau_sid, lag_sid, g2, name in ((2, 12, False, "tauG1"),
                                           (3, 13, True, "tauG2"),
                                           (4, 14, False, "alphaTauG1"),
                                           (5, 15, False, "betaTauG1")):
            if not _verify_lagrange(cv, pt, tau_sid, lag_sid, g2, rng,
                                    logger, device):
                return err(f"Phase2 calculation does not match with powers "
                           f"of tau ({name})")
    elif logger:
        logger.warn("this file does not contain phase2 precalculated "
                    "values. Please run preparephase2.")
    return True


def _verify_lagrange(cv, pt, tau_sid, lag_sid, g2, rng, logger=None,
                     device=None) -> bool:
    """resTau == resLagrange via random-vector FFT (verify.js:398-491): the
    Fr NTT of the random vector runs on `device` (K-mm-norm from 2^12) and
    its limbs go straight to the MSM."""
    fr = cv.fr
    frctx = ftorch.get_ctx(fr.name)
    sz = _sz(cv, g2)
    max_p = pt.power + (1 if tau_sid == 2 else 0)
    for p in range(0, max_p + 1):
        n = 1 << p
        rs = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        if p == pt.power + 1:
            rs[n - 1] = 0
            tau_lem = (bytes(pt.sections[tau_sid][:(n - 1) * sz])
                       + b"\0" * sz)
        else:
            tau_lem = pt.sections[tau_sid][:n * sz]
        sc = _u32_limbs(fr, rs, device)
        res_tau = _msm_lem(cv, tau_lem, sc, g2, device)

        # fft of the random vector (plain->Montgomery->fft->plain)
        ev = ftorch.from_mont(frctx, nttmod.ntt(frctx, ftorch.to_mont(frctx, sc)))

        off = (n - 1) * sz
        lag_lem = pt.sections[lag_sid][off:off + n * sz]
        res_lag = _msm_lem(cv, lag_lem, ev, g2, device)
        if res_tau != res_lag:
            return False
    return True


# ---------------------------------------------------------------------------
# preparePhase2: the group-element inverse NTT of every block of a group

def host_group_ifft(cv, g2: bool, pts, k: int):
    """Radix-2 group IFFT on host bigint affine points (None = infinity).

    O(n log n) reference oracle for the batched route and the small-size
    path on CPU tensors."""
    fr = cv.fr
    n = 1 << k
    assert len(pts) == n
    out = [pts[int(format(i, f"0{k}b")[::-1], 2)] for i in range(n)] \
        if k else list(pts)
    root = fr.winv[k]
    for s in range(1, k + 1):
        m = 1 << (s - 1)
        ws = pow(root, 1 << (k - s), fr.p)
        wj = 1
        for j in range(m):
            for b in range(0, n, 2 * m):
                lo, hi = out[b + j], out[b + j + m]
                t = None if hi is None else _g_mul(cv, g2, hi, wj)
                tn = None if t is None else _g_neg(cv, g2, t)
                out[b + j] = _g_add(cv, g2, lo, t)
                out[b + j + m] = _g_add(cv, g2, lo, tn)
            wj = wj * ws % fr.p
    ninv = pow(n, fr.p - 2, fr.p)
    return [None if P is None else _g_mul(cv, g2, P, ninv) for P in out]


def _scale_batch(f, P, idx, scal):
    """P[idx] *= scal in place (Jacobian points, plain (NL, m) limb scalars),
    in batched double-and-adds of jac.DEVICE_BATCH lanes."""
    for lo in range(0, idx.shape[0], jac.DEVICE_BATCH):
        sl = idx[lo:lo + jac.DEVICE_BATCH]
        k = scal[:, lo:lo + jac.DEVICE_BATCH]
        Q = jac.batch_scalar_mul_limbs(f, tuple(f.gather(c, sl) for c in P), k,
                                       jac.scalar_bit_length(k))
        for c, v in zip(P, Q):
            f.put(c, sl, v)


def _intt_stage(cv, g2: bool, P, blocks, i: int, pending: list, device) -> int:
    """Stage i of the batched group iNTT, in place on the Jacobian lanes P.

    blocks: [(lane offset, k)], each block's points in bit-reversed order.  A
    block of k > i has 2^(k-1) butterflies (lo, hi = lo + 2^i) with the
    twiddle w_{2^(i+1)}^-off on hi.  A block whose last stage this is
    (k = i + 1) takes its 1/n here: lo times 1/n, hi times the twiddle times
    1/n.  Stage 0 multiplies nothing: the lanes of 2-point blocks go to
    `pending` and take their 1/2 in the next batch.  Hi lanes whose scalar is
    1 stay out of the batch.  Returns the number of lanes multiplied."""
    fr = cv.fr
    f = _f(cv, g2, device)
    m = 1 << i
    act = [(o, k) for o, k in blocks if k > i]
    if not act:
        return 0
    los = [(o + np.arange(0, 1 << k, 2 * m)[:, None] + np.arange(m)[None, :]).ravel()
           for o, k in act]
    idx, scal = [], []
    if i >= 1:
        ctx = ftorch.get_ctx(fr.name)
        tw = _powers(fr, 1, fr.winv[i + 1], m, device)
        ninv = pow(2 * m, fr.p - 2, fr.p)
        for lo, (o, k) in zip(los, act):
            off = np.tile(np.arange(m), (1 << k) // (2 * m))
            if k == i + 1:
                idx += [lo, lo + m]
                scal += [_const(fr, ninv, device).expand(fr.nl, lo.shape[0]),
                         ftorch.mont_mul(ctx, _const(fr, fr.to_mont(ninv), device),
                                         tw[:, torch.as_tensor(off, device=device)])]
            else:
                keep = off != 0
                idx.append(lo[keep] + m)
                scal.append(tw[:, torch.as_tensor(off[keep], device=device)])
        if pending:
            idx.append(np.concatenate(pending))
            scal.append(_const(fr, fr.half, device).expand(fr.nl, idx[-1].shape[0]))
            pending.clear()
    n_mul = sum(a.shape[0] for a in idx)
    if n_mul:
        _scale_batch(f, P, torch.as_tensor(np.concatenate(idx), device=device),
                     torch.cat(scal, dim=1).contiguous())
    lo_t = torch.as_tensor(np.concatenate(los), device=device)
    hi_t = lo_t + m
    A = tuple(f.gather(c, lo_t) for c in P)
    B = tuple(f.gather(c, hi_t) for c in P)
    top = jac.jac_add(f, A, B)
    bot = jac.jac_add(f, A, jac.jac_neg(f, B))
    for c, t, b in zip(P, top, bot):
        f.put(c, lo_t, t)
        f.put(c, hi_t, b)
    if i == 0:
        pending += [np.array([o, o + 1]) for o, k in act if k == 1]
    return n_mul


def _intt_lanes(cv, g2: bool, blocks, device):
    """The lanes of a batched group iNTT: blocks = [(lem, k)] -> (Jacobian
    lanes on `device`, each block's points in bit-reversed order one block
    after another; [(lane offset, k)])."""
    from ..ntt.ntt import bit_reverse_perm

    f = _f(cv, g2, device)
    sz = _sz(cv, g2)
    offs, perm, total = [], [], 0
    for _, k in blocks:
        offs.append((total, k))
        perm.append(total + bit_reverse_perm(k))
        total += 1 << k
    lem = b"".join(bytes(memoryview(l)[:(1 << k) * sz]) for l, k in blocks)
    x, y, inf = _lem_points(cv, lem, total, g2, device)
    order = torch.as_tensor(np.concatenate(perm), device=device)
    return jac.from_affine(f, f.gather(x, order), f.gather(y, order), inf[order]), offs


def _group_intt_batched(cv, g2: bool, blocks, device, logger=None) -> list:
    """The group iNTTs of several blocks of one group at once: blocks =
    [(lem, k)] (2^k LEM points each, k >= 1); returns each block's LEM
    Lagrange points.  All blocks share the stages (`_intt_stage`), so a
    largest block of 2^K costs K - 1 batched scalar multiplications (one
    when K = 1)."""
    f = _f(cv, g2, device)
    sz = _sz(cv, g2)
    P, offs = _intt_lanes(cv, g2, blocks, device)
    pending = []
    for i in range(max(k for _, k in offs)):
        n_mul = _intt_stage(cv, g2, P, offs, i, pending, device)
        if logger:
            logger.debug(f"group iNTT {'G2' if g2 else 'G1'} stage {i}: "
                         f"{n_mul} lanes multiplied")
    if pending:
        lanes = np.concatenate(pending)
        _scale_batch(f, P, torch.as_tensor(lanes, device=device),
                     _const(cv.fr, cv.fr.half, device).expand(cv.fr.nl, lanes.shape[0])
                     .contiguous())
    total = sum(1 << k for _, k in offs)
    out = bytearray()
    for lo in range(0, total, jac.DEVICE_BATCH):
        sl = slice(lo, min(total, lo + jac.DEVICE_BATCH))
        out += _lem_bytes(cv, g2, *jac.to_affine_batch(
            f, tuple(f.gather(c, sl) for c in P), f.batch_inv))
    return [bytes(out[o * sz:(o + (1 << k)) * sz]) for o, k in offs]


def _lagrange_blocks(cv, g2: bool, blocks, device, force_device=False,
                     logger=None) -> list:
    """G.lagrangeEvaluations of every block [(lem, k)] of one group: blocks of
    one point are their own output; on CPU tensors blocks up to
    HOST_IFFT_MAX_CPU points go to `host_group_ifft` (unless force_device);
    the rest go through `_group_intt_batched` together."""
    fq = cv.fq
    sz = _sz(cv, g2)
    outs = [None] * len(blocks)
    batched = []
    for j, (lem, k) in enumerate(blocks):
        if k == 0:
            outs[j] = bytes(memoryview(lem)[:sz])
        elif (device.type == "cpu" and not force_device
              and (1 << k) <= HOST_IFFT_MAX_CPU):
            conv_in = pcodec.g2_lem_to_ints if g2 else pcodec.g1_lem_to_ints
            conv_out = pcodec.g2_lem_from_ints if g2 else pcodec.g1_lem_from_ints
            outs[j] = conv_out(fq, host_group_ifft(cv, g2, conv_in(fq, lem, 1 << k), k))
        else:
            batched.append(j)
    if batched:
        res = _group_intt_batched(cv, g2, [blocks[j] for j in batched], device, logger)
        for j, r in zip(batched, res):
            outs[j] = r
    return outs


def group_lagrange_lem(cv, lem, n: int, g2: bool, force_device: bool = False,
                       device=None) -> bytes:
    """G.lagrangeEvaluations on a LEM slice: group IFFT -> Lagrange-basis
    points [L_j(tau) G]_j.  Groups of order 2^k need k <= s (the field's
    2-adicity)."""
    device = devmod.resolve(device)
    k = n.bit_length() - 1
    if 1 << k != n or k > cv.fr.s:
        raise ValueError(f"a group iNTT needs 2^k points with k <= {cv.fr.s}")
    return _lagrange_blocks(cv, g2, [(lem, k)], device, force_device)[0]


_LAGRANGE = ((2, 12, False, "tauG1"), (3, 13, True, "tauG2"),
             (4, 14, False, "alphaTauG1"), (5, 15, False, "betaTauG1"))


def _section_blocks(cv, pt: PtauFile, old_sid: int, g2: bool) -> list:
    """The (lem, k) blocks of one Lagrange section: the first 2^k points of
    the tau section for k = 0 .. power (tauG1 also power + 1, whose last
    point is the zero point, as the reference's file has)."""
    sz = _sz(cv, g2)
    if pt.power + (1 if old_sid == 2 else 0) > cv.fr.s:
        raise ValueError(f"a group iNTT needs 2^k points with k <= {cv.fr.s}")
    out = []
    for p in range(0, pt.power + (2 if old_sid == 2 else 1)):
        n = 1 << p
        if p == pt.power + 1:
            lem = bytes(memoryview(pt.sections[old_sid])[:(n - 1) * sz]) + b"\0" * sz
        else:
            lem = memoryview(pt.sections[old_sid])[:n * sz]
        out.append((lem, p))
    return out


def _lagrange_sections(cv, pt: PtauFile, which, device, logger=None) -> dict:
    """new sid -> bytes of the Lagrange sections in `which` (entries of
    _LAGRANGE), every block of one group in one batched group iNTT."""
    out = {}
    for g2 in (False, True):
        secs = [(old, new) for old, new, is_g2, _ in which if is_g2 == g2]
        if not secs:
            continue
        blocks = [b for old, _ in secs for b in _section_blocks(cv, pt, old, g2)]
        res = _lagrange_blocks(cv, g2, blocks, device, logger=logger)
        pos = 0
        for old, new in secs:
            nb = pt.power + (2 if old == 2 else 1)
            out[new] = b"".join(res[pos:pos + nb])
            pos += nb
    return out


def prepare_phase2(pt: PtauFile, logger=None, device=None) -> PtauFile:
    """Append Lagrange sections 12-15 (src/powersoftau_preparephase2.js).
    device: None means the card; raises without one."""
    device = devmod.resolve(device)
    cv = pt.curve
    new = PtauFile(cv, pt.power, pt.ceremony_power,
                   sections=dict(pt.sections),
                   contributions=list(pt.contributions))
    new.sections.update(_lagrange_sections(cv, pt, _LAGRANGE, device, logger))
    return new


def truncate(pt: PtauFile, p: int) -> PtauFile:
    """One truncated power-p file (src/powersoftau_truncate.js:41-58)."""
    cv = pt.curve
    fq = cv.fq
    s_g1, s_g2 = 2 * fq.n8, 4 * fq.n8
    n = 1 << p
    new = PtauFile(cv, p, pt.ceremony_power,
                   contributions=list(pt.contributions))
    new.sections[2] = pt.sections[2][: (2 * n - 1) * s_g1]
    new.sections[3] = pt.sections[3][: n * s_g2]
    new.sections[4] = pt.sections[4][: n * s_g1]
    new.sections[5] = pt.sections[5][: n * s_g1]
    new.sections[6] = pt.sections[6][:s_g2]
    if 12 in pt.sections:
        new.sections[12] = pt.sections[12][: (2 ** (p + 1) * 2 - 1) * s_g1]
        new.sections[13] = pt.sections[13][: (2 * n - 1) * s_g2]
        new.sections[14] = pt.sections[14][: (2 * n - 1) * s_g1]
        new.sections[15] = pt.sections[15][: (2 * n - 1) * s_g1]
    return new


def convert(pt: PtauFile, logger=None, device=None) -> PtauFile:
    """Recompute section 12 only (src/powersoftau_convert.js)."""
    device = devmod.resolve(device)
    cv = pt.curve
    new = PtauFile(cv, pt.power, pt.ceremony_power,
                   sections=dict(pt.sections),
                   contributions=list(pt.contributions))
    new.sections.update(_lagrange_sections(cv, pt, _LAGRANGE[:1], device, logger))
    return new


def export_json(pt: PtauFile) -> dict:
    """JSON dump of all sections (src/powersoftau_export_json.js), host only."""
    cv = pt.curve
    fq = cv.fq

    def g1s(lem, n):
        return [[str(p[0]), str(p[1]), "1"] if p else ["0", "1", "0"]
                for p in pcodec.g1_lem_to_ints(fq, lem, n)]

    def g2s(lem, n):
        return [[[str(p[0][0]), str(p[0][1])], [str(p[1][0]), str(p[1][1])],
                 ["1", "0"]] if p else [["0", "0"], ["1", "0"], ["0", "0"]]
                for p in pcodec.g2_lem_to_ints(fq, lem, n)]

    n = 1 << pt.power
    out = {
        "power": pt.power,
        "ceremonyPower": pt.ceremony_power,
        "tauG1": g1s(pt.sections[2], 2 * n - 1),
        "tauG2": g2s(pt.sections[3], n),
        "alphaTauG1": g1s(pt.sections[4], n),
        "betaTauG1": g1s(pt.sections[5], n),
        "betaG2": g2s(pt.sections[6], 1),
    }
    for sid, key, g2 in ((12, "lTauG1", False), (13, "lTauG2", True),
                         (14, "lAlphaTauG1", False), (15, "lBetaTauG1", False)):
        if sid not in pt.sections:
            continue
        conv = g2s if g2 else g1s
        sz = _sz(cv, g2)
        lst, off = [], 0
        max_p = pt.power + (1 if sid == 12 else 0)
        for p in range(0, max_p + 1):
            m = 1 << p
            lst.append(conv(pt.sections[sid][off:off + m * sz], m))
            off += m * sz
        out[key] = lst
    return out
