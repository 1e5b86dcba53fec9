"""A plain PLONK prover for the benchmark's keys (snarkjs's plonk prove,
src/plonk_prove.js; eprint 2019/953), with its own Keccak-256 transcript.

The benchmark's keys tile the SRS from a table of consecutive multiples, so
point i is (k0 + (i mod period)) G1, and each of the nine commitments has a
closed form: sum_i c_i (k0 + (i mod period)) G1 = (k0 S0 + S1) G1, with S0
and S1 the plain and the weighted sums of the coefficients.  Everything else
is worked out in full on `reference.field` and `reference.ntt`: the grand
product, the quotient over a domain of 4n points, its split into T1, T2, T3
with b10 and b11, the six evaluations, the linearisation and both
divisions.  The route is not snarkjs's, so that the two check each other:
  - the quotient is t = num / Z_H evaluated on the coset g H4 of the 4n-th
    roots of unity (g the field's least non-residue), where Z_H has no root:
    num is evaluated point by point from the blinded polynomials (a blinded
    wire is A + Z_H (b2 + b1 X), so one product and one add on A's
    evaluations), divided by Z_H there, and brought back by an inverse NTT;
    deg t < 4n, so its 4n evaluations fix it;
  - Z's running product is a prefix product of the numerators times a suffix
    product of the denominators and one inverse, each product a log-depth scan;
  - a division by X - x is a suffix sum of c_k x^k times x^-(j+1).

`prepare` makes the key's tables, `wires` the work that depends only on the
witness, `prove` the rest of one proof for the blinders b[1..11].  Imports
nothing of the measured program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .curve import CURVES, Group
from .field import BITS, MASK, Field

DIGIT = (1 << 32) - 1
from .ntt import ntt

POINTS = ("A", "B", "C", "Z", "T1", "T2", "T3", "Wxi", "Wxiw")
EVALS = ("eval_a", "eval_b", "eval_c", "eval_s1", "eval_s2", "eval_zw")
POLYS = ("qm", "ql", "qr", "qo", "qc", "s1", "s2", "s3")
VK = ("Qm", "Ql", "Qr", "Qo", "Qc", "S1", "S2", "S3")


# ------------------------------------------------------------- Keccak-256

def _keccak_constants():
    rc, lfsr = [], 1
    for _ in range(24):
        c = 0
        for j in range(7):
            if lfsr & 1:
                c |= 1 << ((1 << j) - 1)
            lfsr = ((lfsr << 1) ^ 0x71) & 0xFF if lfsr & 0x80 else lfsr << 1
        rc.append(c)
    rot, x, y = [0] * 25, 1, 0
    for t in range(24):
        rot[x + 5 * y] = (t + 1) * (t + 2) // 2 % 64
        x, y = y, (2 * x + 3 * y) % 5
    return rc, rot


_RC, _ROT = _keccak_constants()
_LANE = (1 << 64) - 1


def _rol(v: int, k: int) -> int:
    return ((v << k) | (v >> (64 - k))) & _LANE


def _keccak_f(a: list) -> list:
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y] ^ d[x], _ROT[x + 5 * y])
        a = [b[i] ^ (~b[(i + 1) % 5 + i - i % 5] & b[(i + 2) % 5 + i - i % 5])
             for i in range(25)]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """Keccak-256 as Ethereum and snarkjs use it (pad 0x01 .. 0x80, rate 136)."""
    rate = 136
    pad = rate - len(data) % rate
    msg = bytes(data) + (b"\x81" if pad == 1 else b"\x01" + b"\x00" * (pad - 2) + b"\x80")
    a = [0] * 25
    for off in range(0, len(msg), rate):
        for i in range(rate // 8):
            a[i] ^= int.from_bytes(msg[off + 8 * i:off + 8 * i + 8], "little")
        a = _keccak_f(a)
    return b"".join(v.to_bytes(8, "little") for v in a[:4])


class Transcript:
    """snarkjs's Keccak256Transcript: G1 points as big-endian x || y (zeros at
    infinity), scalars as big-endian Fr; a challenge is the digest mod r."""

    def __init__(self, curve):
        self.cv = curve
        self.buf = b""

    def point(self, P):
        n = self.cv.fq_bytes
        self.buf += b"\0" * (2 * n) if P is None else (
            P[0].to_bytes(n, "big") + P[1].to_bytes(n, "big"))

    def scalar(self, v: int):
        self.buf += (v % self.cv.r).to_bytes(self.cv.fr_bytes, "big")

    def challenge(self) -> int:
        out = int.from_bytes(keccak256(self.buf), "big") % self.cv.r
        self.buf = b""
        return out


# ------------------------------------------------------------ the field

class Fr(Field):
    """`field.Field` with a product of fewer, fused row updates, carries over
    32-bit digits, and the table of powers made from two short ones: the
    same numbers, fewer passes over memory."""

    def __init__(self, p: int, nbytes: int):
        super().__init__(p, nbytes)
        if self.L % 2 or 2 * p >= 1 << (BITS * self.L):
            raise ValueError("needs an even number of limbs and 2p < R")
        self.pinv32 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self._roots = {}

    def mont_mul(self, a, b):
        """a b / R mod p, as `Field.mont_mul`, with a's limbs taken in pairs:
        a 32-bit digit of a times b's 16-bit limbs in each row update, and a
        32-bit Montgomery digit in each step of the reduction (every sum
        stays below 2^53)."""
        L = self.L
        a, b = torch.broadcast_tensors(a, b)
        t = torch.zeros((2 * L + 2,) + tuple(a.shape[1:]), dtype=torch.int64,
                        device=a.device)
        for i in range(0, L, 2):
            t[i:i + L].addcmul_(a[i] + (a[i + 1] << BITS), b)
        p = self._pl(a)
        q0, q1 = self.pinv32 & MASK, self.pinv32 >> BITS
        for i in range(0, L, 2):
            d0 = t[i] & MASK
            d1 = ((t[i] >> BITS) + t[i + 1]) & MASK
            m = (d0 * q0 + (((d0 * q1 + d1 * q0) & MASK) << BITS)) & DIGIT
            t[i:i + L].addcmul_(m, p)
            t[i + 1] += t[i] >> BITS
            t[i + 2] += t[i + 1] >> BITS
        hi = t[L:]                      # the result, below 2p, in 18 rows of up to 53 bits
        c = hi >> BITS
        hi &= MASK
        hi[1:] += c[:-1]
        return self._below_p(self._carry32(self._digits(hi)))[:L]

    # ------------------------------------------ carries over 32-bit digits
    @staticmethod
    def _digits(t):
        """16-bit limb rows -> 32-bit digit rows t[2k] + t[2k+1] 2^16 (the
        same value; signed rows allowed)."""
        return t[0::2] + t[1::2] * (1 << BITS)

    @staticmethod
    def _carry32(d):
        """Carries up the digits, in place; the top digit keeps the rest,
        with its sign."""
        for k in range(d.shape[0] - 1):
            d[k + 1] += d[k] >> 32
            d[k] &= DIGIT
        return d

    def _p32(self, d):
        key = ("p32", d.shape[0], d.dim(), str(d.device))
        if key not in self._p_cache:
            self._p_cache[key] = torch.tensor(
                [(self.p >> (32 * k)) & DIGIT for k in range(d.shape[0])], dtype=torch.int64,
                device=d.device).reshape((-1,) + (1,) * (d.dim() - 1))
        return self._p_cache[key]

    @staticmethod
    def _limbs16(d):
        out = torch.empty((2 * d.shape[0],) + tuple(d.shape[1:]), dtype=d.dtype, device=d.device)
        out[0::2] = d & MASK
        out[1::2] = d >> BITS
        return out

    def _below_p(self, d):
        """Carried digits of a value in [0, 2p) -> the value mod p, as limbs."""
        e = self._carry32(d - self._p32(d))
        return self._limbs16(torch.where(e[-1] < 0, d, e))

    def add(self, a, b):
        return self._below_p(self._carry32(self._digits(a + b)))

    def sub(self, a, b):
        d = self._carry32(self._digits(a - b))
        e = self._carry32(d + self._p32(d))
        return self._limbs16(torch.where(d[-1] < 0, e, d))

    def mconst(self, v: int, device) -> torch.Tensor:
        """(L, 1) Montgomery limbs of v."""
        return self.const(v % self.p * self.R, device)

    def scale(self, a, v: int):
        """a v; by 2 or 3 (k1, k2) as additions."""
        v %= self.p
        if v in (2, 3):
            d = self.add(a, a)
            return d if v == 2 else self.add(d, a)
        return self.mont_mul(a, self.mconst(v, a.device))

    def powers(self, x: int, n: int, device) -> torch.Tensor:
        """Montgomery form of x^0 .. x^(n-1): the product of a row of x^j
        (j < w, w about sqrt(n)) by a column of x^(w i), both from the host's
        integers; the powers of a root of unity (the NTT's twiddles) are kept."""
        x %= self.p
        key = (x, n, str(device))
        if key in self._roots:
            return self._roots[key]
        w = 1 << (n.bit_length() + 1) // 2
        step, lo, hi = pow(x, w, self.p), [self.R], [self.R]
        for _ in range(w - 1):
            lo.append(lo[-1] * x % self.p)
        for _ in range(-(-n // w) - 1):
            hi.append(hi[-1] * step % self.p)
        out = self.mont_mul(self.from_ints(hi, device)[:, :, None],
                            self.from_ints(lo, device)[:, None, :]).reshape(self.L, -1)[:, :n]
        if pow(x, 1 << self.s, self.p) == 1:
            self._roots[key] = out
        return out

    def plain(self, t) -> int:
        """The sum of the Montgomery elements of t, as a plain int."""
        limbs = t.sum(dim=1).tolist()
        s = sum(int(x) << (BITS * j) for j, x in enumerate(limbs))
        return s * pow(self.R, -1, self.p) % self.p

    def mod_p(self, t):
        """Limb-wise sums (L, m) of canonical elements, each limb sum below
        2^47, -> each sum mod p: the low 256 bits times R / R, the rest
        times R^2 / R."""
        t = self._carry(t)
        hi = t[-1] >> BITS
        lo = t.clone()
        lo[-1] &= MASK
        h = torch.zeros_like(lo)
        h[0], h[1] = hi & MASK, hi >> BITS
        return self.add(self.mont_mul(lo, self.const(self.R, t.device)),
                        self.mont_mul(h, self.const(self.R2, t.device)))


def field(curve) -> Fr:
    return Fr(curve.r, curve.fr_bytes)


def pad(t, m: int):
    return torch.nn.functional.pad(t, (0, m - t.shape[1])) if t.shape[1] < m else t[:, :m]


def scan(F: Fr, x, reverse: bool = False):
    """Inclusive prefix products along the columns (suffix with reverse):
    a Hillis-Steele scan inside blocks of 16, the blocks' totals scanned the
    same way, then each block times the totals before it."""
    if reverse:
        return scan(F, x.flip(1)).flip(1)
    L, n = x.shape
    if n <= 64:
        d = 1
        while d < n:
            x = torch.cat([x[:, :d], F.mont_mul(x[:, d:], x[:, :-d])], dim=1)
            d *= 2
        return x
    w = 16
    x = pad(x, -(-n // w) * w)
    one = F.mconst(1, x.device)
    x[:, n:] = one
    blocks = x.reshape(L, -1, w)
    d = 1
    while d < w:
        blocks = torch.cat([blocks[..., :d], F.mont_mul(blocks[..., d:], blocks[..., :-d])], 2)
        d *= 2
    before = scan(F, blocks[..., -1])
    before = torch.cat([one, before[:, :-1]], dim=1)
    return F.mont_mul(blocks, before[..., None]).reshape(L, -1)[:, :n]


# --------------------------------------------------------------- the key

@dataclass
class Key:
    """A PLONK key in plain numbers: the domain, the public inputs, k1 and k2,
    the gates' wire ids (a, b, c: one signal a gate), the coefficients of the
    selectors and sigmas (POLYS; (L, n) uint32 limbs in Montgomery form, as
    the .zkey stores them), the SRS's tiling (point i is (k0 + (i mod period))
    G1) and the verification key's points (VK; affine, None at infinity)."""
    curve: str
    domain: int
    n_public: int
    k1: int
    k2: int
    k0: int
    period: int
    maps: tuple
    coefs: dict
    vk: dict


@dataclass
class Tables:
    """The key's tables on the device: the selectors' and sigmas'
    coefficients, each of them and each Lagrange polynomial on the coset
    g H4, the sigmas on H, the points of H and of g H4, Z_H and 1 / Z_H on
    g H4 (period 4), and the powers of g and of 1 / g."""
    F: Fr
    dev: torch.device
    coefs: dict
    cos: dict
    lag: list
    sig_h: tuple
    w_h: torch.Tensor
    x_cos: torch.Tensor
    zh: torch.Tensor
    zh_inv: torch.Tensor
    g_pow: torch.Tensor
    g_inv: torch.Tensor


@dataclass
class Wires:
    """What depends on the witness alone: the publics, A on the public rows,
    A, B, C on H, their coefficients, their values on g H4 and their
    closed-form sums."""
    publics: list
    pi: list
    on_h: tuple
    coefs: tuple
    cos: tuple
    sums: tuple


def _limbs(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)


def coset(T: Tables, coefs):
    """The polynomial's values on g H4 (deg < 4n)."""
    n4 = T.x_cos.shape[1]
    m = coefs.shape[1]
    return ntt(T.F, pad(T.F.mont_mul(coefs, T.g_pow[:, :m]), n4))


def _period4(F, a, c):
    """a (L, 4n) times the period-4 constant c (L, 4)."""
    L, m = a.shape
    return F.mont_mul(a.reshape(L, m // 4, 4), c[:, None, :]).reshape(L, m)


def prepare(key: Key, device) -> Tables:
    cv = CURVES[key.curve]
    F = field(cv)
    dev = torch.device(device)
    n = key.domain
    k = n.bit_length() - 1
    p = F.p
    g = F.nqr
    g_pow = F.powers(g, 4 * n, dev)
    g_inv = F.powers(pow(g, -1, p), 4 * n, dev)
    x_cos = F.scale(F.powers(F.w[k + 2], 4 * n, dev), g)
    i4 = pow(F.w[k + 2], n, p)          # a primitive 4th root of unity
    zh = [(pow(g, n, p) * pow(i4, c, p) - 1) % p for c in range(4)]
    T = Tables(F=F, dev=dev, coefs={name: _limbs(key.coefs[name], dev) for name in POLYS},
               cos={}, lag=[], sig_h=(), w_h=F.powers(F.w[k], n, dev), x_cos=x_cos,
               zh=F.from_ints([v * F.R for v in zh], dev),
               zh_inv=F.from_ints([pow(v, -1, p) * F.R for v in zh], dev),
               g_pow=g_pow, g_inv=g_inv)
    T.cos = {name: coset(T, c) for name, c in T.coefs.items()}
    T.sig_h = tuple(ntt(F, T.coefs[s]) for s in ("s1", "s2", "s3"))
    for j in range(max(key.n_public, 1)):
        e = torch.zeros((F.L, n), dtype=torch.int64, device=dev)
        e[:, j:j + 1] = F.mconst(1, dev)
        T.lag.append(coset(T, ntt(F, e, inverse=True)))
    return T


def _sums(F: Fr, coefs, period: int) -> tuple:
    return F.weighted_sums(F.from_mont(coefs), period)


def wires(key: Key, T: Tables, wit_limbs: np.ndarray) -> Wires:
    """wit_limbs: (L, n_vars) plain 16-bit limbs; signal 0 is taken as 0, as
    snarkjs's prover takes it."""
    F, n = T.F, key.domain
    w = _limbs(wit_limbs, T.dev)
    w[:, 0] = 0
    publics = F.to_ints(w[:, 1:key.n_public + 1])
    on_h, coefs, cos, sums = [], [], [], []
    for m in key.maps:
        h = pad(F.to_mont(w[:, _limbs(m, T.dev)]), n)
        c = ntt(F, h, inverse=True)
        on_h.append(h)
        coefs.append(c)
        cos.append(coset(T, c))
        sums.append(_sums(F, c, key.period))
    pi = F.to_ints(F.from_mont(on_h[0][:, :key.n_public]))
    return Wires(publics, pi, tuple(on_h), tuple(coefs), tuple(cos), tuple(sums))


# ------------------------------------------------------------- the proof

def _blind(F: Fr, c, bs: list):
    """c + (bs[0] + bs[1] X + ...) Z_H: each b added at X^(n+i), taken
    away at X^i (snarkjs's blindCoefficients)."""
    n = c.shape[1]
    out = pad(c, n + len(bs)).clone()
    for i, bb in enumerate(bs):
        v = F.mconst(bb, c.device)
        out[:, n + i:n + i + 1] = v
        out[:, i:i + 1] = F.sub(out[:, i:i + 1], v)
    return out


def _combine(F: Fr, terms, m: int, const: int = 0):
    """sum of coefs * scalar (None: 1) over terms, padded to m, plus const
    at X^0."""
    acc = None
    for c, s in terms:
        c = pad(c, m)
        c = c if s is None else F.scale(c, s)
        acc = c if acc is None else F.add(acc, c)
    acc = acc.clone()
    acc[:, :1] = F.add(acc[:, :1], F.mconst(const, acc.device))
    return acc


def _divide(F: Fr, c, pw, pw_inv, what: str):
    """The quotient of c by X - x (same length, top coefficient 0), given
    the powers of x and of 1 / x; raises unless the remainder is 0."""
    m = c.shape[1]
    suffix = F.mod_p(F.mont_mul(c, pw[:, :m]).flip(1).cumsum(1).flip(1))
    if bool(suffix[:, 0].any()):
        raise ValueError(f"{what} is not divisible by X - xi")
    return pad(F.mont_mul(suffix[:, 1:], pw_inv[:, 1:m]), m)


def prove(key: Key, T: Tables, W: Wires, b: list) -> dict:
    """The proof for blinders b[1..11]: the nine commitments (affine ints,
    None at infinity), the six evaluations, and the publics."""
    cv = CURVES[key.curve]
    F, dev, n = T.F, T.dev, key.domain
    p = F.p
    g1 = Group(cv, 1)
    point = lambda s: g1.mul(cv.g1, (key.k0 * s[0] + s[1]) % p)
    commit = lambda c: point(_sums(F, c, key.period))
    out = {"publics": W.publics}
    tr = Transcript(cv)

    # round 1: the blinded wires; their sums follow from the witness's
    blinds = ((b[2], b[1]), (b[4], b[3]), (b[6], b[5]))
    A, B, C = (_blind(F, c, bs) for c, bs in zip(W.coefs, blinds))
    for name, (s0, s1), bs in zip("ABC", W.sums, blinds):
        s1 += sum(bb * ((n + i) % key.period - i % key.period) for i, bb in enumerate(bs))
        out[name] = point((s0, s1))
    for name in VK:
        tr.point(key.vk[name])
    for x in W.publics:
        tr.scalar(x)
    for name in "ABC":
        tr.point(out[name])
    beta = tr.challenge()
    tr.scalar(beta)
    gamma = tr.challenge()

    # round 2: Z
    gam = F.mconst(gamma, dev)
    bw = F.scale(T.w_h, beta)
    num = F.mont_mul(F.mont_mul(F.add(F.add(W.on_h[0], bw), gam),
                                F.add(F.add(W.on_h[1], F.scale(bw, key.k1)), gam)),
                     F.add(F.add(W.on_h[2], F.scale(bw, key.k2)), gam))
    den = F.mont_mul(F.mont_mul(F.add(F.add(W.on_h[0], F.scale(T.sig_h[0], beta)), gam),
                                F.add(F.add(W.on_h[1], F.scale(T.sig_h[1], beta)), gam)),
                     F.add(F.add(W.on_h[2], F.scale(T.sig_h[2], beta)), gam))
    before, after = scan(F, num), scan(F, den, reverse=True)
    total = F.to_ints(F.from_mont(after[:, :1]))[0]
    if F.to_ints(F.from_mont(before[:, -1:]))[0] != total:
        raise ValueError("copy constraints do not hold")
    z_h = torch.cat([F.mconst(1, dev), F.scale(F.mont_mul(before[:, :-1], after[:, 1:]),
                                               pow(total, -1, p))], dim=1)
    Z = _blind(F, ntt(F, z_h, inverse=True), [b[9], b[8], b[7]])
    out["Z"] = commit(Z)
    tr.scalar(beta)
    tr.scalar(gamma)
    tr.point(out["Z"])
    alpha = tr.challenge()

    # round 3: t = num / Z_H on g H4, where a blinded wire is A + b0 Z_H + b1 Z_H X
    X, zh = T.x_cos, T.zh
    L4 = lambda t: t.reshape(F.L, -1, 4)
    wire = lambda cos, b0, b1: F.add(F.add(L4(cos), F.scale(zh, b0)[:, None]).reshape(F.L, -1),
                                     _period4(F, X, F.scale(zh, b1)))
    a, bb, c = (wire(cos, b0, b1) for cos, (b0, b1) in zip(W.cos, blinds))
    z = coset(T, Z)
    zw = torch.roll(z, -4, dims=1)
    q = T.cos
    gate = F.add(F.add(F.mont_mul(F.mont_mul(q["qm"], a), bb), F.mont_mul(q["ql"], a)),
                 F.add(F.add(F.mont_mul(q["qr"], bb), F.mont_mul(q["qo"], c)), q["qc"]))
    for j, x in enumerate(W.pi):
        gate = F.sub(gate, F.scale(T.lag[j], x))
    bx = F.scale(X, beta)
    perm1 = F.mont_mul(F.mont_mul(F.add(F.add(a, bx), gam),
                                  F.add(F.add(bb, F.scale(bx, key.k1)), gam)),
                       F.mont_mul(F.add(F.add(c, F.scale(bx, key.k2)), gam), z))
    perm2 = F.mont_mul(F.mont_mul(F.add(F.add(a, F.scale(q["s1"], beta)), gam),
                                  F.add(F.add(bb, F.scale(q["s2"], beta)), gam)),
                       F.mont_mul(F.add(F.add(c, F.scale(q["s3"], beta)), gam), zw))
    l1 = F.mont_mul(F.sub(z, F.mconst(1, dev)), T.lag[0])
    num4 = F.add(F.add(gate, F.scale(F.sub(perm1, perm2), alpha)), F.scale(l1, alpha * alpha))
    del a, bb, c, z, zw, gate, perm1, perm2, l1
    t = F.mont_mul(ntt(F, _period4(F, num4, T.zh_inv), inverse=True), T.g_inv)
    del num4
    if bool(t[:, 3 * n + 6:].any()):
        raise ValueError("the quotient has degree 3n + 6 or more: the witness fails the gates")
    T1 = pad(t[:, :n], n + 1).clone()
    T1[:, n:] = F.mconst(b[10], dev)
    T2 = pad(t[:, n:2 * n], n + 1).clone()
    T2[:, :1] = F.sub(T2[:, :1], F.mconst(b[10], dev))
    T2[:, n:] = F.mconst(b[11], dev)
    T3 = t[:, 2 * n:3 * n + 6].clone()
    T3[:, :1] = F.sub(T3[:, :1], F.mconst(b[11], dev))
    for name, poly in (("T1", T1), ("T2", T2), ("T3", T3)):
        out[name] = commit(poly)
    tr.scalar(alpha)
    for name in ("T1", "T2", "T3"):
        tr.point(out[name])
    xi = tr.challenge()

    # round 4: evaluations
    w = F.w[n.bit_length() - 1]
    xiw = xi * w % p
    pw = {x: (F.powers(x, n + 6, dev), F.powers(pow(x, -1, p), n + 6, dev)) for x in (xi, xiw)}
    at = lambda poly, x: F.plain(F.mont_mul(poly, pw[x][0][:, :poly.shape[1]]))
    kc = T.coefs
    ev = {"eval_a": at(A, xi), "eval_b": at(B, xi), "eval_c": at(C, xi),
          "eval_s1": at(kc["s1"], xi), "eval_s2": at(kc["s2"], xi), "eval_zw": at(Z, xiw)}
    out.update(ev)
    tr.scalar(xi)
    for name in EVALS:
        tr.scalar(ev[name])
    v1 = tr.challenge()
    v = [1, v1, v1 * v1 % p, pow(v1, 3, p), pow(v1, 4, p), pow(v1, 5, p)]

    # round 5: the linearisation and the two openings
    ea, eb, ec, es1, es2, ezw = (ev[k] for k in EVALS)
    xin = pow(xi, n, p)
    zh_xi = (xin - 1) % p
    lag = [pow(w, j, p) * zh_xi * pow(n * (xi - pow(w, j, p)), -1, p) % p
           for j in range(max(key.n_public, 1))]
    pi = -sum(x * lag[j] for j, x in enumerate(W.publics)) % p
    bxi = beta * xi % p
    e2 = (ea + bxi + gamma) * (eb + bxi * key.k1 + gamma) * (ec + bxi * key.k2 + gamma) * alpha
    e3 = (ea + beta * es1 + gamma) * (eb + beta * es2 + gamma) * ezw * alpha % p
    e4 = lag[0] * alpha * alpha
    r0 = pi - e3 * (ec + gamma) - e4
    wxi = _combine(F, [(kc["qm"], ea * eb), (kc["ql"], ea), (kc["qr"], eb), (kc["qo"], ec),
                       (kc["qc"], None), (Z, e2 + e4), (kc["s3"], -e3 * beta),
                       (T1, -zh_xi), (T2, -zh_xi * xin), (T3, -zh_xi * xin * xin),
                       (A, v[1]), (B, v[2]), (C, v[3]), (kc["s1"], v[4]), (kc["s2"], v[5])],
                   n + 6, r0 - v[1] * ea - v[2] * eb - v[3] * ec - v[4] * es1 - v[5] * es2)
    out["Wxi"] = commit(_divide(F, wxi, *pw[xi], "Wxi"))
    out["Wxiw"] = commit(_divide(F, _combine(F, [(Z, None)], n + 3, -ezw), *pw[xiw], "Wxiw"))
    return out
