"""Field parameters for the curves snarkjs supports (bn128/bn254 and bls12-381).

All derived constants (Montgomery R, roots of unity, shift) follow the exact
conventions of the reference compute engine (ffjavascript F1Field, see
reference src/curves.js:9-34 use-sites and the bundled F1Field constructor:
nqr = smallest n >= 2 with n^((p-1)/2) == -1, shift = nqr^2, w[s] = nqr^t with
t = (p-1)/2^s and w[i] = w[i+1]^2), so that NTT domains and coset shifts are
bit-compatible with .zkey/.ptau artifacts produced by snarkjs.

Boundary representation: a field element is a vector of LIMB_BITS=16-bit limbs kept
in uint32 lanes (products of two limbs fit a uint32; per-column accumulations
of <= 2*NL limb-products stay < 2^21 so carries can be deferred).  Limb-major
layout `(NL, ...batch)` puts the batch dimension on consecutive addresses.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field


LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def _legendre(a: int, p: int) -> int:
    return pow(a, (p - 1) // 2, p)


@dataclass(frozen=True)
class FieldParams:
    """All constants needed for Montgomery arithmetic and NTTs over GF(p)."""

    name: str
    p: int
    n8: int  # byte length of the canonical LE representation (32 or 48)

    # Derived (filled by __post_init__ via object.__setattr__)
    nl: int = field(init=False)           # number of 16-bit limbs
    R: int = field(init=False)            # 2^(n8*8) mod p  (Montgomery radix)
    R2: int = field(init=False)           # R^2 mod p
    R3: int = field(init=False)
    Rinv: int = field(init=False)
    pinv_neg: int = field(init=False)     # -p^-1 mod 2^(n8*8)  (for full reduction)
    s: int = field(init=False)            # 2-adicity
    t: int = field(init=False)            # (p-1) >> s
    nqr: int = field(init=False)          # smallest non-residue (ffjavascript order)
    shift: int = field(init=False)        # nqr^2 — coset shift ("Fr.shift")
    shift_inv: int = field(init=False)
    w: tuple = field(init=False)          # w[i] = 2^i-th root of unity, ffjavascript ladder
    winv: tuple = field(init=False)
    one_mont: int = field(init=False)
    half: int = field(init=False)         # (p+1)/2  (for odd p: inverse of 2)

    def __post_init__(self):
        p = self.p
        nbits = self.n8 * 8
        object.__setattr__(self, "nl", self.n8 * 8 // LIMB_BITS)
        R = (1 << nbits) % p
        object.__setattr__(self, "R", R)
        object.__setattr__(self, "R2", R * R % p)
        object.__setattr__(self, "R3", R * R * R % p)
        object.__setattr__(self, "Rinv", pow(R, p - 2, p))
        object.__setattr__(self, "pinv_neg", (-pow(p, -1, 1 << nbits)) % (1 << nbits))
        s, t = 0, p - 1
        while t % 2 == 0:
            s += 1
            t //= 2
        object.__setattr__(self, "s", s)
        object.__setattr__(self, "t", t)
        nqr = 2
        while _legendre(nqr, p) != p - 1:
            nqr += 1
        object.__setattr__(self, "nqr", nqr)
        shift = nqr * nqr % p
        object.__setattr__(self, "shift", shift)
        object.__setattr__(self, "shift_inv", pow(shift, p - 2, p))
        w = [0] * (s + 1)
        w[s] = pow(nqr, t, p)
        for i in range(s - 1, -1, -1):
            w[i] = w[i + 1] * w[i + 1] % p
        object.__setattr__(self, "w", tuple(w))
        object.__setattr__(self, "winv", tuple(pow(x, p - 2, p) for x in w))
        object.__setattr__(self, "one_mont", R % p)
        object.__setattr__(self, "half", (p + 1) // 2)

    # ---- host-side scalar helpers -------------------------------------------------
    def to_mont(self, a: int) -> int:
        return a * self.R % self.p

    def from_mont(self, a: int) -> int:
        return a * self.Rinv % self.p

    def inv(self, a: int) -> int:
        return pow(a, self.p - 2, self.p)

    def limbs(self, a: int):
        """int -> list of nl 16-bit limbs, little-endian."""
        return [(a >> (LIMB_BITS * i)) & LIMB_MASK for i in range(self.nl)]

    def from_limbs(self, limbs) -> int:
        acc = 0
        for i, l in enumerate(limbs):
            acc |= int(l) << (LIMB_BITS * i)
        return acc

    def to_bytes(self, a: int) -> bytes:
        return int(a).to_bytes(self.n8, "little")

    def from_bytes(self, b: bytes) -> int:
        return int.from_bytes(b, "little")


# ---- The four primes snarkjs ships (reference src/curves.js:9-34) ----------------

BN254_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

BLS12_381_Q = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
BLS12_381_R = int(
    "73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16
)


@functools.lru_cache(maxsize=None)
def get_params(name: str) -> FieldParams:
    table = {
        "bn254_fq": ("bn254_fq", BN254_Q, 32),
        "bn254_fr": ("bn254_fr", BN254_R, 32),
        "bls12_381_fq": ("bls12_381_fq", BLS12_381_Q, 48),
        "bls12_381_fr": ("bls12_381_fr", BLS12_381_R, 32),
    }
    return FieldParams(*table[name])


BN254_FQ = get_params("bn254_fq")
BN254_FR = get_params("bn254_fr")
BLS12_381_FQ = get_params("bls12_381_fq")
BLS12_381_FR = get_params("bls12_381_fr")
