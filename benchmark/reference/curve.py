"""Plain elliptic-curve arithmetic on Python integers, for the reference.

G1 over Fq and G2 over Fq2 = Fq[u]/(u^2 + 1), short Weierstrass y^2 = x^3 + b,
for the two curves snarkjs supports.  Points are affine tuples, None is the
point at infinity; a scalar multiplication runs double-and-add in Jacobian
coordinates and inverts once.  The constants are the curves' published ones
(EIP-196/197 for bn128, the IETF pairing-friendly-curves draft for
bls12-381).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Curve:
    name: str
    q: int          # base field
    r: int          # group order (the scalar field)
    fq_bytes: int
    fr_bytes: int
    b: int
    b2: tuple       # G2 twist coefficient
    g1: tuple
    g2: tuple


_BN_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
_BLS_Q = int("1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
             "1eabfffeb153ffffb9feffffffffaaab", 16)


def _f2_div(a, b, q):
    den = pow(b[0] * b[0] + b[1] * b[1], -1, q)
    return ((a[0] * b[0] + a[1] * b[1]) * den % q, (a[1] * b[0] - a[0] * b[1]) * den % q)


CURVES = {
    "bn128": Curve(
        name="bn128", q=_BN_Q,
        r=21888242871839275222246405745257275088548364400416034343698204186575808495617,
        fq_bytes=32, fr_bytes=32, b=3, b2=_f2_div((3, 0), (9, 1), _BN_Q),
        g1=(1, 2),
        g2=((10857046999023057135944570762232829481370756359578518086990519993285655852781,
             11559732032986387107991004021392285783925812861821192530917403151452391805634),
            (8495653923123431417604973247489272438418190587263600148770280649306958101930,
             4082367875863433681332203403145435568316851327593401208105741076214120093531))),
    "bls12381": Curve(
        name="bls12381", q=_BLS_Q,
        r=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
        fq_bytes=48, fr_bytes=32, b=4, b2=(4, 4),
        g1=(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
            0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
        g2=((0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
             0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
            (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
             0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE))),
}


class _F1:
    """Fq on ints."""

    def __init__(self, q):
        self.q = q
        self.zero, self.one = 0, 1

    def add(self, a, b):
        return (a + b) % self.q

    def sub(self, a, b):
        return (a - b) % self.q

    def mul(self, a, b):
        return a * b % self.q

    def inv(self, a):
        return pow(a, -1, self.q)


class _F2:
    """Fq2 = Fq[u]/(u^2 + 1) on pairs of ints."""

    def __init__(self, q):
        self.q = q
        self.zero, self.one = (0, 0), (1, 0)

    def add(self, a, b):
        return ((a[0] + b[0]) % self.q, (a[1] + b[1]) % self.q)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.q, (a[1] - b[1]) % self.q)

    def mul(self, a, b):
        q = self.q
        return ((a[0] * b[0] - a[1] * b[1]) % q, (a[0] * b[1] + a[1] * b[0]) % q)

    def inv(self, a):
        return _f2_div((1, 0), a, self.q)


class Group:
    """G1 (ext 1) or G2 (ext 2) of a curve."""

    def __init__(self, curve: Curve, ext: int):
        self.curve = curve
        self.f = _F1(curve.q) if ext == 1 else _F2(curve.q)
        self.b = curve.b if ext == 1 else curve.b2
        self.gen = curve.g1 if ext == 1 else curve.g2

    def on_curve(self, P) -> bool:
        if P is None:
            return True
        f = self.f
        x, y = P
        return f.sub(f.mul(y, y), f.add(f.mul(f.mul(x, x), x), self.b)) == f.zero

    def add(self, P, Q):
        f = self.f
        if P is None:
            return Q
        if Q is None:
            return P
        if P[0] == Q[0]:
            if f.add(P[1], Q[1]) == f.zero:
                return None
            xx = f.mul(P[0], P[0])
            lam = f.mul(f.add(f.add(xx, xx), xx), f.inv(f.add(P[1], P[1])))
        else:
            lam = f.mul(f.sub(Q[1], P[1]), f.inv(f.sub(Q[0], P[0])))
        x = f.sub(f.sub(f.mul(lam, lam), P[0]), Q[0])
        return (x, f.sub(f.mul(lam, f.sub(P[0], x)), P[1]))

    def _jdbl(self, P):
        f = self.f
        X, Y, Z = P
        if Z == f.zero:
            return P
        A, B = f.mul(X, X), f.mul(Y, Y)
        C = f.mul(B, B)
        D = f.sub(f.sub(f.mul(f.add(X, B), f.add(X, B)), A), C)
        D = f.add(D, D)
        E = f.add(f.add(A, A), A)
        X3 = f.sub(f.mul(E, E), f.add(D, D))
        C8 = f.add(C, C)
        C8 = f.add(C8, C8)
        C8 = f.add(C8, C8)
        Y3 = f.sub(f.mul(E, f.sub(D, X3)), C8)
        return (X3, Y3, f.mul(f.add(Y, Y), Z))

    def _jadd_affine(self, P, Q):
        """Jacobian P + affine Q."""
        f = self.f
        X1, Y1, Z1 = P
        if Z1 == f.zero:
            return (Q[0], Q[1], f.one)
        Z1Z1 = f.mul(Z1, Z1)
        U2 = f.mul(Q[0], Z1Z1)
        S2 = f.mul(f.mul(Q[1], Z1), Z1Z1)
        if U2 == X1:
            return self._jdbl(P) if S2 == Y1 else (f.one, f.one, f.zero)
        H = f.sub(U2, X1)
        HH = f.mul(H, H)
        I = f.add(HH, HH)
        I = f.add(I, I)
        J = f.mul(H, I)
        rr = f.sub(S2, Y1)
        rr = f.add(rr, rr)
        V = f.mul(X1, I)
        X3 = f.sub(f.sub(f.mul(rr, rr), J), f.add(V, V))
        Y3 = f.sub(f.mul(rr, f.sub(V, X3)), f.add(f.mul(Y1, J), f.mul(Y1, J)))
        Z3 = f.sub(f.sub(f.mul(f.add(Z1, H), f.add(Z1, H)), Z1Z1), HH)
        return (X3, Y3, Z3)

    def mul(self, P, k: int):
        """k P for an affine P, k reduced mod r."""
        f = self.f
        k %= self.curve.r
        if P is None or k == 0:
            return None
        acc = (f.one, f.one, f.zero)
        for bit in bin(k)[2:]:
            acc = self._jdbl(acc)
            if bit == "1":
                acc = self._jadd_affine(acc, P)
        X, Y, Z = acc
        if Z == f.zero:
            return None
        zi = f.inv(Z)
        zi2 = f.mul(zi, zi)
        return (f.mul(X, zi2), f.mul(f.mul(Y, zi2), zi))
