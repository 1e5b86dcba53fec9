"""Inputs that the card script (chip_smoke.py) builds and the tests hold
against the JAX package or stored files: the point tables it tiles its keys
from, the squaring chain as an r1cs and witness, the prepared .ptau of fixed
secrets, and the base-field products of one K-scan and one K-reduce addition
that its bounds count.

It imports neither jax nor snarkjs_tpu: the script runs on a card without
them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from snarkjs_tpu_torch.curves import host_curve as hc
from snarkjs_tpu_torch.fields import ftorch
from snarkjs_tpu_torch.formats import points as pcodec
from snarkjs_tpu_torch.formats import ptau as ptau_fmt
from snarkjs_tpu_torch.formats.r1cs import R1cs
from snarkjs_tpu_torch.formats.wtns import Witness
from snarkjs_tpu_torch.protocols import groth16_setup

PLONK_CONSTRAINTS = 200_000  # + 1 public-input row: domain 2^18


def point_tables(cv, n1=512, n2=64):
    """n1 multiples of G1 and n2 of G2, (i+1)*G, Montgomery limbs."""
    fq = cv.fq
    g1, acc = [], cv.g1
    for _ in range(n1):
        g1.append(acc)
        acc = hc.g1_add(cv, acc, cv.g1)
    g2, acc = [], cv.g2
    for _ in range(n2):
        g2.append(acc)
        acc = hc.g2_add(cv, acc, cv.g2)
    m = lambda vs: ftorch.np_from_ints(fq, [fq.to_mont(v) for v in vs])
    return ((m([p[0] for p in g1]), m([p[1] for p in g1])),
            ((m([p[0][0] for p in g2]), m([p[0][1] for p in g2])),
             (m([p[1][0] for p in g2]), m([p[1][1] for p in g2]))))


def tiled(t, n):
    if isinstance(t, tuple):
        return tuple(tiled(x, n) for x in t)
    return np.ascontiguousarray(np.tile(t, (1, -(-n // t.shape[1])))[:, :n])


def plonk_circuit(fr, nc=PLONK_CONSTRAINTS):
    """The squaring chain of `nc` constraints as an r1cs (wire 0 = 1, wire 1 =
    public x, wire i+2 = wire_{i+1}^2) with its witness."""
    i = np.arange(nc, dtype=np.int32)
    r1cs = R1cs(
        n8=fr.n8, prime=fr.p, n_wires=nc + 2, n_pub_out=0, n_pub_in=1, n_prv_in=0,
        n_labels=nc + 2, n_constraints=nc, m=np.tile(np.array([0, 1, 2], np.int32), nc),
        c=np.repeat(i, 3), s=np.stack([i + 1, i + 1, i + 2], 1).reshape(-1),
        vals=np.tile(np.array(fr.limbs(1), dtype=np.uint32)[:, None], (1, 3 * nc)))
    w = [1, 0xDEADBEEF]
    for _ in range(nc):
        w.append(w[-1] * w[-1] % fr.p)
    return r1cs, Witness(n8=fr.n8, q=fr.p, n=len(w), values=ftorch.np_from_ints(fr, w))


def circom_chain(fr, nc=PLONK_CONSTRAINTS):
    """`plonk_circuit`'s chain with the coefficients circom writes for
    `y <== x * x`: p - 1 on one factor and on the output ((-x) x = -y), the
    negated factor alternating between A and B.  Every point section of the
    Groth16 setup then holds full-width scalars, so each of its segmented
    MSMs runs all 254 double-and-add steps.  The witness is the chain's.
    `tests/_wasm_chain.py` writes this circuit's .r1cs and its circom .wasm."""
    r1cs, wit = plonk_circuit(fr, nc)
    i = np.arange(r1cs.n_constraints)
    neg = np.array(fr.limbs(fr.p - 1), dtype=np.uint32)[:, None]
    vals = r1cs.vals.copy()          # constraint i: A, B, C at 3i, 3i + 1, 3i + 2
    vals[:, 3 * i + i % 2] = neg
    vals[:, 3 * i + 2] = neg
    return dataclasses.replace(r1cs, vals=vals), wit


def ptau_scalars(cv, power, tau, alpha, beta):
    """The scalars of every point of the prepared .ptau of `power` that one
    contribution of (tau, alpha, beta) and preparePhase2 leave: section id ->
    (scalars, G2?).  Sections 2-6 hold tau^i, alpha tau^i, beta tau^i and
    beta; 12-15 the Lagrange values of each power 0 .. power (12 also
    power + 1), times alpha in 14 and beta in 15.  Section 12's top block is
    the group iFFT of 2^(power+1) - 1 tau points and one zero point
    (ptau_ops.prepare_phase2), so its scalars are L_j(tau) - tau^(m-1) w^j / m
    with m = 2^(power+1)."""
    fr = cv.fr
    p = fr.p
    n = 1 << power
    taus, t = [], 1
    for _ in range(2 * n - 1):
        taus.append(t)
        t = t * tau % p
    scaled = lambda k, vs: [k * v % p for v in vs]
    lag = [v for q in range(power + 1) for v in groth16_setup.lagrange_at(fr, tau, 1 << q)]
    m = 2 * n
    top = groth16_setup.lagrange_at(fr, tau, m)
    c, wj, w = taus[m - 2] * tau % p * pow(m, p - 2, p) % p, 1, fr.w[power + 1]
    for j in range(m):
        top[j] = (top[j] - c * wj) % p
        wj = wj * w % p
    return {2: (taus, False), 3: (taus[:n], True), 4: (scaled(alpha, taus[:n]), False),
            5: (scaled(beta, taus[:n]), False), 6: ([beta], True), 12: (lag + top, False),
            13: (lag, True), 14: (scaled(alpha, lag), False), 15: (scaled(beta, lag), False)}


def build_ptau(cv, power, scalars, dev):
    """The .ptau whose points are [k]G for the scalars of `ptau_scalars`, all
    G1 points from one call of the port's `_points_from_scalars` and all G2
    points from another (the batched double-and-add on the card, in batches
    of its DEVICE_BATCH).  No contribution record."""
    fq = cv.fq
    pt = ptau_fmt.PtauFile(cv, power, power)
    for g2 in (False, True):
        sids = [sid for sid, (_, is_g2) in scalars.items() if is_g2 == g2]
        ks = [k for sid in sids for k in scalars[sid][0]]
        lem = (pcodec.g2_lem_to_bytes if g2 else pcodec.g1_lem_to_bytes)(
            fq, *groth16_setup._points_from_scalars(cv, ks, g2, dev))
        size, pos = (4 if g2 else 2) * fq.n8, 0
        for sid in sids:
            n = len(scalars[sid][0]) * size
            pt.sections[sid] = lem[pos:pos + n]
            pos += n
    return pt


def madd_products(ext):
    """Full Montgomery products over the base field in one K-scan mixed add
    (msm_scan.cu:rcb_madd, the operations of rcb.rcb_madd): 11 products and
    two products by 3b.  On G1 3b is a small integer and those two are an add
    ladder (fmul_small), no multiplies; on G2 3b is a full Fq2 element, so
    all 13 are Fq2 products of three Fq products each: 39, where
    benchmark/metrics/msm_roofline_pct.py counts the operation's 29 (its 7
    multiplications and 4 squarings over Fq2, without the two by 3b)."""
    return 11 if ext == 1 else 3 * 13


def add_products(ext):
    """Full Montgomery products over the base field in one K-reduce add
    (msm_reduce.cu:rcb_add, the operations of rcb.rcb_add): 12 products and
    two products by 3b, an add ladder on G1; on G2 all 14 are Fq2 products
    of three Fq products each."""
    return 12 if ext == 1 else 3 * 14
