"""K-scan's plain version against the JAX package's own formula, word for
word; the card rule of the scan width (`msm_gpu._lanes`); the count of
field products in K-scan's bound (`tests/_torch_inputs.madd_products`).

The JAX side is the sequential formula of `msm_tpu._scan_kernel` run step by
step outside Pallas: `rcb.rcb_madd` over `msm_tpu._DevField` / `_DevField2`
with `msm_tpu._dev_b3`, from c = C - 1 down, y negated on signed lanes, the
running point packed two limbs to a word as the kernel packs it.  (The
Pallas kernel in interpret mode would take minutes of compiling on a CPU.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkjs_tpu.curves import host_curve as hc
from snarkjs_tpu.curves import msm_tpu, rcb
from snarkjs_tpu.fields import fjnp
from snarkjs_tpu_torch.curves import host_curve as thc
from snarkjs_tpu_torch.curves import msm_gpu
from snarkjs_tpu_torch.curves import rcb as trcb
from tests import _torch_inputs as inputs
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

C, RL, NW = 3, 128, 2

CASES = {
    "g1_bn254": ("BN254", 1, 21),
    "g2_bn254": ("BN254", 2, 22),
    "g1_bls12_381": ("BLS12_381", 1, 23),
    "g2_bls12_381": ("BLS12_381", 2, 24),
}


def _scan_input(cv, ext, seed):
    """(NW, C, nl*ext + 1, RL) u32: the multiples 1..C*RL of the generator,
    packed two limbs to a word, sorted per window by random keys mag*2 + sign
    and laid out as GpuMSM._sorted lays them (lane l holds sorted positions
    l*C .. l*C + C - 1)."""
    fq = cv.fq
    n = C * RL
    add = hc.g2_add if ext == 2 else hc.g1_add
    gen = cv.g2 if ext == 2 else cv.g1
    pts, acc = [], gen
    for _ in range(n):
        pts.append(acc)
        acc = add(cv, acc, gen)
    coords = ([lambda p: p[0], lambda p: p[1]] if ext == 1 else
              [lambda p: p[0][0], lambda p: p[0][1], lambda p: p[1][0], lambda p: p[1][1]])
    limbs = np.concatenate([fjnp.np_from_ints(fq, [fq.to_mont(c(p)) for p in pts])
                            for c in coords]).astype(np.uint32)
    rows = limbs[0::2] | (limbs[1::2] << 16)                   # (nl*ext, n)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 64, (NW, n)) * 2 + rng.integers(0, 2, (NW, n))
    out = []
    for w in range(NW):
        perm = np.argsort(keys[w], kind="stable")
        out.append(np.concatenate([rows[:, perm], keys[w][perm][None].astype(np.uint32)]))
    xys = np.stack(out, axis=1)                                 # (nin, NW, n)
    return xys.reshape(xys.shape[0], NW, RL, C).transpose(1, 3, 0, 2).copy()


def _jax_scan(cv, ext, xyT):
    """The JAX package's mixed-add scan over the same words, packed like
    `_scan_kernel`'s output."""
    fq = cv.fq
    nl = fq.nl
    ctx = fjnp.get_ctx(fq.name)
    f = msm_tpu._DevField(ctx) if ext == 1 else msm_tpu._DevField2(ctx)
    b3 = msm_tpu._dev_b3(ctx, cv.b if ext == 1 else cv.b2, ext, 1)
    nw, nc, nin, nr = xyT.shape
    npk = nin - 1
    out = np.zeros((nw, nc, 3 * npk // 2, nr), dtype=np.uint32)
    for w in range(nw):
        P = rcb.rcb_zero(f, (nr,))
        for c in range(nc - 1, -1, -1):
            v = xyT[w, c]
            limbs = jnp.asarray(np.stack([v[:npk] & 0xFFFF, v[:npk] >> 16], axis=1)
                                .reshape(2 * npk, nr))
            if ext == 1:
                x2, y2 = limbs[:nl], limbs[nl:]
            else:
                x2 = (limbs[:nl], limbs[nl:2 * nl])
                y2 = (limbs[2 * nl:3 * nl], limbs[3 * nl:])
            neg = jnp.asarray((v[npk] & 1) != 0)
            y2 = f.select(neg, f.sub(f.zero((nr,)), y2), y2)
            P = rcb.rcb_madd(f, P, x2, y2, b3)
            X, Y, Z = P
            parts = [X, Y, Z] if ext == 1 else [X[0], X[1], Y[0], Y[1], Z[0], Z[1]]
            rows = np.asarray(jnp.concatenate(parts, axis=0))
            out[w, c] = rows[0::2] | (rows[1::2] << 16)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_plain_matches_jax_formula_word_for_word(case):
    curve, ext, seed = CASES[case]
    cv, tcv = getattr(hc, curve), getattr(thc, curve)
    xyT = _scan_input(cv, ext, seed)
    assert (xyT[:, :, -1] & 1).any() and not (xyT[:, :, -1] & 1).all()
    b = tcv.b if ext == 1 else tcv.b2
    got = msm_gpu.scan_plain(tcv.fq, b, ext, torch.from_numpy(xyT.view(np.int32)))
    want = _jax_scan(cv, ext, xyT)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# ------------------------------------------------ the scan width on the card

@pytest.mark.parametrize("nw,n,rl", [
    (16, 600_002, 8192), (16, 262_150, 8192), (16, 1 << 20, 8192), (17, 1 << 20, 4096),
    (32, 1 << 20, 4096), (1, 1 << 20, 1 << 17), (16, 1000, 1024), (16, 100, 128),
    (16, 1, 128)])
def test_lanes_on_the_card(nw, n, rl):
    """A power of two near TARGET_THREADS / nw, no wider than the points
    need and no narrower than one block of LN lanes: RL = 8192 at every
    shape the 2^20 Groth16 and 2^18 PLONK proves give K-scan (nw = 16)."""
    got = msm_gpu._lanes(nw, n, torch.device("cuda"))
    assert got == rl and got & (got - 1) == 0
    assert got == msm_gpu.LN or nw * got <= msm_gpu.TARGET_THREADS


def test_lanes_on_the_cpu_ignore_residency():
    """On the CPU about sqrt(n) lanes, at most LN, whatever the card holds."""
    assert msm_gpu._lanes(16, 600_002, torch.device("cpu")) == msm_gpu.LN
    assert msm_gpu._lanes(2, 100, torch.device("cpu")) == 16


# ------------------------------------------- K-scan's bound counts every product

class _CountingField:
    """A field whose products count themselves, apart when one operand is 3b."""

    def __init__(self):
        self.by_b3 = self.other = 0

    def mul(self, a, b):
        if "b3" in (a, b):
            self.by_b3 += 1
        else:
            self.other += 1
        return "v"

    def add(self, a, b):
        return "v"

    sub = add


@pytest.mark.parametrize("formula", [rcb, trcb], ids=["jax", "torch"])
@pytest.mark.parametrize("ext", [1, 2])
def test_kscan_bound_counts_every_product_of_the_mixed_add(formula, ext):
    """`madd_products`, the base-field products of one K-scan step
    in its bound, against the products the mixed-add formula makes: on G1
    the two by 3b are an add ladder, on G2 every Fq2 product is three."""
    f = _CountingField()
    formula.rcb_madd(f, ("v", "v", "v"), "v", "v", "b3")
    assert (f.other, f.by_b3) == (11, 2)
    want = f.other if ext == 1 else 3 * (f.other + f.by_b3)
    assert inputs.madd_products(ext) == want
