""".ptau powers-of-tau accumulator files (port of snarkjs_tpu/formats/ptau.py).

Container layout mirrors the reference (src/powersoftau_new.js:20-66 format
comment, src/powersoftau_utils.js):

  section 1  header: n8, q (LE), power, ceremonyPower
  section 2  tauG1        2^p*2-1 G1 points, LEM
  section 3  tauG2        2^p     G2 points, LEM
  section 4  alphaTauG1   2^p     G1 points, LEM
  section 5  betaTauG1    2^p     G1 points, LEM
  section 6  betaG2       1       G2 point,  LEM
  section 7  contributions (count + records, src/powersoftau_utils.js:163-310)
  sections 12-15 (after preparePhase2): Lagrange bases per power 0..p(+1),
  same groups/order as 2-5 (src/powersoftau_preparephase2.js:40-47).

Point wire encodings (ffjavascript conventions):
  * LEM  — little-endian Montgomery x||y; infinity = all-zero words.
  * U    — big-endian standard x||y (challenge files / transcript hashing).
  * C    — big-endian standard x with flag bits in byte 0 (response files):
           0x40 marks infinity; 0x80 marks y > p/2 ("greater" half, the
           ffjavascript sign convention).  wasmcurves g1m_LEMtoC semantics.

The codecs here work on host ints, one point at a time (ceremony records hold
a few points); whole sections go through the batched codecs of
`ceremony/ptau_ops.py`.
"""

from __future__ import annotations

import hashlib
import mmap
import struct
from dataclasses import dataclass, field

from ..curves import host_curve as hc
from ..utils.blake2b import Blake2b
from . import points
from .binfile import BinFile, BinFileWriter, SectionWriter


CONTRIB_MPC = 0
CONTRIB_BEACON = 1


# ---------------------------------------------------------------------------
# point wire codecs on host ints (ceremony records are O(1) points)

def g1_lem(fq, p) -> bytes:
    return points.g1_lem_from_ints(fq, [p])


def g2_lem(fq, p) -> bytes:
    return points.g2_lem_from_ints(fq, [p])


def g1_from_lem(fq, b: bytes):
    return points.g1_lem_to_ints(fq, b, 1)[0]


def g2_from_lem(fq, b: bytes):
    return points.g2_lem_to_ints(fq, b, 1)[0]


def g1_compressed_be(fq, p) -> bytes:
    if p is None:
        return bytes([0x40]) + b"\0" * (fq.n8 - 1)
    out = bytearray(int(p[0]).to_bytes(fq.n8, "big"))
    if int(p[1]) > fq.p >> 1:
        out[0] |= 0x80
    return bytes(out)


def g2_compressed_be(fq, p) -> bytes:
    """BE F2 reprs are component-swapped (c1 || c0) — Bellman G2Compressed /
    wasmcurves g2m_LEMtoC convention."""
    if p is None:
        return bytes([0x40]) + b"\0" * (2 * fq.n8 - 1)
    out = bytearray(int(p[0][1]).to_bytes(fq.n8, "big")
                    + int(p[0][0]).to_bytes(fq.n8, "big"))
    # sign from y lexicographically: (y1, y0) "greater" per F2 gt convention
    y0, y1 = int(p[1][0]), int(p[1][1])
    half = fq.p >> 1
    if (y1 > half) or (y1 == 0 and y0 > half):
        out[0] |= 0x80
    return bytes(out)


def g1_u_to_ints(fq, b: bytes):
    x = int.from_bytes(b[:fq.n8], "big")
    y = int.from_bytes(b[fq.n8:2 * fq.n8], "big")
    if x == 0 and y == 0:
        return None
    return (x, y)


def g2_u_to_ints(fq, b: bytes):
    return points.g2_u_to_ints(fq, b)


# ---------------------------------------------------------------------------
# pubkey / contribution records

KEY_G1S = [("tau", "g1_s"), ("tau", "g1_sx"), ("alpha", "g1_s"),
           ("alpha", "g1_sx"), ("beta", "g1_s"), ("beta", "g1_sx")]
KEY_G2S = [("tau", "g2_spx"), ("alpha", "g2_spx"), ("beta", "g2_spx")]


def pubkey_size(cv) -> int:
    return cv.fq.n8 * 2 * 6 + cv.fq.n8 * 4 * 3


def pubkey_to_bytes(cv, key: dict, montgomery: bool) -> bytes:
    """src/powersoftau_utils.js:124-155 (toPtauPubKeyRpr)."""
    fq = cv.fq
    out = b""
    for grp, name in KEY_G1S:
        p = key[grp][name]
        out += g1_lem(fq, p) if montgomery else points.g1_uncompressed_be(fq, p)
    for grp, name in KEY_G2S:
        p = key[grp][name]
        out += g2_lem(fq, p) if montgomery else points.g2_uncompressed_be(fq, p)
    return out


def pubkey_from_bytes(cv, b: bytes, montgomery: bool) -> dict:
    fq = cv.fq
    key = {"tau": {}, "alpha": {}, "beta": {}}
    pos = 0
    for grp, name in KEY_G1S:
        chunk = b[pos:pos + 2 * fq.n8]
        key[grp][name] = (g1_from_lem(fq, chunk) if montgomery
                          else g1_u_to_ints(fq, chunk))
        pos += 2 * fq.n8
    for grp, name in KEY_G2S:
        chunk = b[pos:pos + 4 * fq.n8]
        key[grp][name] = (g2_from_lem(fq, chunk) if montgomery
                          else g2_u_to_ints(fq, chunk))
        pos += 4 * fq.n8
    return key


@dataclass
class Contribution:
    tau_g1: tuple = None
    tau_g2: tuple = None
    alpha_g1: tuple = None
    beta_g1: tuple = None
    beta_g2: tuple = None
    key: dict = None
    partial_hash: bytes = b""
    next_challenge: bytes = b""
    type: int = CONTRIB_MPC
    name: str = ""
    num_iterations_exp: int = 0
    beacon_hash: bytes = b""
    id: int = 0

    def response_hash(self, cv) -> bytes:
        """Resume the saved partial hash and absorb the uncompressed pubkey
        (src/powersoftau_utils.js:180-186)."""
        h = Blake2b.from_partial(self.partial_hash)
        h.update(pubkey_to_bytes(cv, self.key, montgomery=False))
        return h.digest()


def contribution_to_bytes(cv, c: Contribution) -> bytes:
    fq = cv.fq
    w = SectionWriter()
    w.raw(g1_lem(fq, c.tau_g1))
    w.raw(g2_lem(fq, c.tau_g2))
    w.raw(g1_lem(fq, c.alpha_g1))
    w.raw(g1_lem(fq, c.beta_g1))
    w.raw(g2_lem(fq, c.beta_g2))
    w.raw(pubkey_to_bytes(cv, c.key, montgomery=True))
    if len(c.partial_hash) != 216 or len(c.next_challenge) != 64:
        raise ValueError("a contribution needs a 216-byte partial hash and a "
                         "64-byte next challenge")
    w.raw(c.partial_hash)
    w.raw(c.next_challenge)
    w.u32(c.type)
    params = bytearray()
    if c.name:
        nd = c.name[:64].encode()
        params += bytes([1, len(nd)]) + nd
    if c.type == CONTRIB_BEACON:
        params += bytes([2, c.num_iterations_exp])
        params += bytes([3, len(c.beacon_hash)]) + c.beacon_hash
    w.u32(len(params))
    w.raw(bytes(params))
    return w.tobytes()


def contribution_from_reader(cv, r) -> Contribution:
    fq = cv.fq
    c = Contribution()
    c.tau_g1 = g1_from_lem(fq, r.raw(2 * fq.n8))
    c.tau_g2 = g2_from_lem(fq, r.raw(4 * fq.n8))
    c.alpha_g1 = g1_from_lem(fq, r.raw(2 * fq.n8))
    c.beta_g1 = g1_from_lem(fq, r.raw(2 * fq.n8))
    c.beta_g2 = g2_from_lem(fq, r.raw(4 * fq.n8))
    c.key = pubkey_from_bytes(cv, r.raw(pubkey_size(cv)), montgomery=True)
    c.partial_hash = r.raw(216)
    c.next_challenge = r.raw(64)
    c.type = r.u32()
    plen = r.u32()
    pend = plen
    buf = r.raw(plen)
    pos = 0
    last_type = 0
    while pos < pend:
        t = buf[pos]; pos += 1
        if t <= last_type:
            raise ValueError("contribution params must be sorted")
        last_type = t
        if t == 1:
            ln = buf[pos]; pos += 1
            c.name = buf[pos:pos + ln].decode(); pos += ln
        elif t == 2:
            c.num_iterations_exp = buf[pos]; pos += 1
        elif t == 3:
            ln = buf[pos]; pos += 1
            c.beacon_hash = bytes(buf[pos:pos + ln]); pos += ln
        else:
            raise ValueError("unknown contribution parameter")
    return c


# ---------------------------------------------------------------------------
# the file

@dataclass
class PtauFile:
    curve: hc.CurveParams
    power: int
    ceremony_power: int
    sections: dict = field(default_factory=dict)   # sid -> raw LEM bytes
    contributions: list = field(default_factory=list)

    @property
    def n_tau_g1(self) -> int:
        return (1 << self.power) * 2 - 1

    def counts(self):
        n = 1 << self.power
        return {2: 2 * n - 1, 3: n, 4: n, 5: n, 6: 1}

    def _header(self) -> bytes:
        h = SectionWriter()
        h.u32(self.curve.fq.n8)
        h.big(self.curve.fq.p, self.curve.fq.n8)
        h.u32(self.power)
        h.u32(self.ceremony_power)
        return h.tobytes()

    def _contributions(self) -> bytes:
        cw = SectionWriter()
        cw.u32(len(self.contributions))
        for c in self.contributions:
            cw.raw(contribution_to_bytes(self.curve, c))
        return cw.tobytes()

    def tobytes(self) -> bytes:
        bw = BinFileWriter("ptau", 1)
        bw.add_section(1, self._header())
        for sid in sorted(self.sections):
            bw.add_section(sid, self.sections[sid])
        bw.add_section(7, self._contributions())
        return bw.tobytes()

    def save(self, path: str):
        """Stream the file to disk in 16 MiB chunks (no whole-file buffer;
        sections may be mmap- or spool-backed views).  The bytes are those of
        `tobytes`."""
        chunk = 16 * 1024 * 1024
        payloads = [(1, self._header())]
        payloads += [(sid, self.sections[sid]) for sid in sorted(self.sections)]
        payloads.append((7, self._contributions()))
        with open(path, "wb") as f:
            f.write(b"ptau" + struct.pack("<II", 1, len(payloads)))
            for sid, payload in payloads:
                mv = memoryview(payload)
                mm = mv.obj if isinstance(mv.obj, mmap.mmap) else None
                f.write(struct.pack("<IQ", sid, len(mv)))
                for off in range(0, len(mv), chunk):
                    f.write(mv[off:off + chunk])
                    if mm is not None:
                        # drop spool-backed pages as they stream out
                        mm.madvise(mmap.MADV_DONTNEED, off, min(chunk, len(mv) - off))

    def last_challenge(self) -> bytes:
        if self.contributions:
            return self.contributions[-1].next_challenge
        return first_challenge_hash(self.curve, self.power)


def read_ptau(path_or_bytes) -> PtauFile:
    bf = (BinFile.load(path_or_bytes, "ptau")
          if isinstance(path_or_bytes, str) else BinFile(path_or_bytes, "ptau"))
    r = bf.reader(1)
    n8 = r.u32()
    q = r.big(n8)
    cv = hc.curve_from_q(q)
    power = r.u32()
    ceremony_power = r.u32()
    pt = PtauFile(cv, power, ceremony_power)
    for sid in (2, 3, 4, 5, 6, 12, 13, 14, 15):
        try:
            pt.sections[sid] = bf.view_section(sid)
        except (KeyError, ValueError):
            pass
    try:
        cr = bf.reader(7)
    except (KeyError, ValueError):
        return pt
    n = cr.u32()
    for i in range(n):
        c = contribution_from_reader(cv, cr)
        c.id = i + 1
        pt.contributions.append(c)
    return pt


def first_challenge_hash(cv, power: int) -> bytes:
    """blake2b over the empty hash and the generator copies of a blank
    accumulator's sections (src/powersoftau_utils.js:312-358), absorbed in
    bounded runs of copies."""
    h = hashlib.blake2b(digest_size=64)
    h.update(hashlib.blake2b(digest_size=64).digest())
    vg1 = points.g1_uncompressed_be(cv.fq, cv.g1)
    vg2 = points.g2_uncompressed_be(cv.fq, cv.g2)
    n = 1 << power
    for v, count in ((vg1, 2 * n - 1), (vg2, n), (vg1, n), (vg1, n), (vg2, 1)):
        run = v * min(count, 1 << 14)
        for _ in range(count // (1 << 14)):
            h.update(run)
        h.update(v * (count % (1 << 14)))
    return h.digest()


def format_hash(b: bytes, caption: str = "") -> str:
    lines = []
    for i in range(0, len(b), 32):
        row = b[i:i + 32]
        lines.append("\t\t" + " ".join(
            row[j:j + 4].hex() for j in range(0, len(row), 4)))
    return (caption + "\n" if caption else "") + "\n".join(lines)
