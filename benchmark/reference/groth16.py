"""A plain Groth16 prover for the benchmark's keys (snarkjs's groth16 prove).

The benchmark's keys tile each point section from a table of its own, the
consecutive multiples (k0 + i) G of a generator with the section's own k0,
and take every verification-key point as a multiple of one too.  So each
MSM has a closed form, sum_i w_i (k0 + (i mod period)) G = (k0 S0 + S1) G,
and the whole proof is three scalar multiplications of the generators.  What has no shortcut is worked out in
full: buildABC from the key's coefficients, the six NTTs of the QAP at the
key's domain and P_odd = A_odd B_odd - C_odd on the odd coset, on
`reference.field` and `reference.ntt`.

Imports nothing of the measured program; takes the key's numbers and the
witness limbs as the benchmark made them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .curve import CURVES, Group
from .field import Field
from .ntt import ntt


@dataclass
class Key:
    """A Groth16 key in plain numbers: coefficients as the .zkey stores them
    (m: 0 for A, 1 for B; c: constraint; s: signal; val: (L, k) 16-bit limbs
    of coefficient * R^2 mod r), each section's first multiple k0 (by
    section: a, b1, b2, c, h), the tables' periods, and the verification
    key's scalars."""
    curve: str
    n_vars: int
    n_public: int
    domain: int
    k0: dict
    g1_period: int
    g2_period: int
    alpha: int
    beta: int
    delta: int
    m: np.ndarray
    c: np.ndarray
    s: np.ndarray
    val: np.ndarray


@dataclass
class Terms:
    """The five MSMs' scalars for one witness: A, B1, B2, C, H."""
    a: int
    b1: int
    b2: int
    c: int
    h: int


def fr(key: Key) -> Field:
    cv = CURVES[key.curve]
    return Field(cv.r, cv.fr_bytes)


def _tiled_scalar(F: Field, key: Key, x: torch.Tensor, section: str) -> int:
    """The scalar k with sum_i x_i P_i = k G over the section's points."""
    s0, s1 = F.weighted_sums(x, key.g2_period if section == "b2" else key.g1_period)
    return (key.k0[section] * s0 + s1) % F.p


def p_odd(F: Field, key: Key, w: torch.Tensor) -> torch.Tensor:
    """buildABC and the QAP: plain (L, domain) limbs of A B - C on the odd
    coset (snarkjs groth16_prove.js: A, B by the coefficients, C = A B at
    the constraints, each to coefficients, shifted, and back)."""
    dev = w.device
    n = key.domain
    k = n.bit_length() - 1
    val = torch.from_numpy(key.val.astype(np.int64)).to(dev)
    m = torch.from_numpy(key.m.astype(np.int64)).to(dev)
    c = torch.from_numpy(key.c.astype(np.int64)).to(dev)
    s = torch.from_numpy(key.s.astype(np.int64)).to(dev)
    prod = F.mont_mul(val, w[:, s])                 # coefficient * w, Montgomery form
    sums = []
    for which in (0, 1):
        sel = m == which
        acc = torch.zeros((F.L + 1, n), dtype=torch.int64, device=dev)
        acc[:F.L].index_add_(1, c[sel], prod[:, sel])
        sums.append(F.reduce_sums(acc))
    a_t, b_t = sums
    del prod, val, m, c, s
    c_t = F.mont_mul(a_t, b_t)
    inc = F.w[k + 1] if k < F.s else F.shift
    shift = F.powers(inc, n, dev)

    def odd(x):
        return ntt(F, F.mont_mul(ntt(F, x, inverse=True), shift))

    out = F.sub(F.mont_mul(odd(a_t), odd(b_t)), odd(c_t))
    return F.from_mont(out)


def terms(key: Key, wit_limbs: np.ndarray, device) -> Terms:
    """The MSM scalars for a witness ((L, n_vars) plain 16-bit limbs)."""
    F = fr(key)
    w = torch.from_numpy(wit_limbs.astype(np.int64)).to(device)
    return Terms(a=_tiled_scalar(F, key, w, "a"), b1=_tiled_scalar(F, key, w, "b1"),
                 b2=_tiled_scalar(F, key, w, "b2"),
                 c=_tiled_scalar(F, key, w[:, key.n_public + 1:], "c"),
                 h=_tiled_scalar(F, key, p_odd(F, key, w), "h"))


def proof(key: Key, t: Terms, r: int, s: int) -> dict:
    """pi_a, pi_b, pi_c (affine ints, None at infinity) blinded by r and s
    (as snarkjs groth16_prove.js blinds them):
      pi_a = alpha + A + r delta,  pi_b = beta + B2 + s delta (G2),
      pi_c = C + H + s pi_a + r (beta + B1 + s delta) - r s delta."""
    cv = CURVES[key.curve]
    q = cv.r
    a = (key.alpha + t.a + r * key.delta) % q
    b1 = (key.beta + t.b1 + s * key.delta) % q
    b2 = (key.beta + t.b2 + s * key.delta) % q
    c = (t.c + t.h + s * a + r * b1 - r * s * key.delta) % q
    g1, g2 = Group(cv, 1), Group(cv, 2)
    return {"pi_a": g1.mul(cv.g1, a), "pi_b": g2.mul(cv.g2, b2), "pi_c": g1.mul(cv.g1, c)}
