"""Count the kernel launches one FFLONK prove makes on the card, from a run of
the plain versions on the CPU (no card, no JAX):

    python -m tests._torch_launch_count          # domains 2^5 and 2^6, then 2^18
    python -m tests._torch_launch_count --msm    # one cw = 16 G1 MSM (about a minute)

Every call of `ftorch.add/sub/mont_mul/neg` is one K-field launch on the card.
What differs on the CPU is replaced by the card's count: each NTT by the
digit-matmul route's (sizes 2^11 .. 2^20: two K-mm-norm stages and two
twiddle products), each MSM by one cw = 16 G1 MSM's over 8192 lanes (counted
with `--msm`).  An MSM's phase 2 is K-reduce on the card, four launches and
no K-field launch; on the CPU its plain twin runs hundreds of plain field
ops, so `--msm` counts K-reduce's four in its place, and a count of the
plain ops of an MSM no longer stands for the card's.  Every scan of the
prover is log2 of its length deep, so the
counts at 2^5 and 2^6 extrapolate linearly in log2 n; at 2^18 each of the 33
evaluations also takes a second `fops.field_sum` round (lengths > 2^14),
three products and one add.
"""

import collections
import json
import sys

import numpy as np
import torch

from snarkjs_tpu_torch.curves import host_curve as hc
from snarkjs_tpu_torch.curves import msm as msm_mod
from snarkjs_tpu_torch.curves import msm_gpu
from snarkjs_tpu_torch.fields import ftorch
from snarkjs_tpu_torch.formats import points as pcodec
from snarkjs_tpu_torch.formats.zkey import read_fflonk_zkey
from snarkjs_tpu_torch.ntt import ntt as nttmod
from snarkjs_tpu_torch.protocols import fflonk, fflonk_setup, plonk_setup
from tests import _torch_inputs as inputs

COUNTS = collections.Counter()
ON = [False]


def _count_ops():
    for op in ("add", "sub", "mont_mul", "neg"):
        orig = getattr(ftorch, op)

        def wrap(*a, _o=orig, _n=op):
            if ON[0]:
                COUNTS[_n] += 1
            return _o(*a)
        setattr(ftorch, op, wrap)


def _replaced(fn, launches):
    """fn with its own launches uncounted and `launches` counted instead."""
    def g(*a, **k):
        on = ON[0]
        ON[0] = False
        try:
            return fn(*a, **k)
        finally:
            ON[0] = on
            if on:
                COUNTS.update(launches)
    return g


def msm_counts(points=9000) -> dict:
    """One G1 MSM at cw = 16 with the card's lane count."""
    lanes = msm_gpu._lanes
    msm_gpu._lanes = lambda nw, n, device: lanes(nw, n, torch.device("cuda"))
    msm_gpu.scan = _replaced(msm_gpu.scan, {"msm_scan": 1})
    msm_gpu.reduce = _replaced(msm_gpu.reduce, {"msm_reduce": 4})
    cv = hc.BN254
    (gx, gy), _ = inputs.point_tables(cv, 64, 1)
    tiled = lambda t: ftorch.to_tensor(np.tile(t, (1, -(-points // 64)))[:, :points], "cpu")
    sc = ftorch.to_tensor(ftorch.np_from_ints(cv.fr, range(1, points + 1)), "cpu")
    COUNTS.clear()
    ON[0] = True
    msm_gpu.get_msm(cv.name, "g1", cw=16).run(tiled(gx), tiled(gy),
                                              torch.zeros(points, dtype=torch.bool), sc)
    ON[0] = False
    return dict(COUNTS)


def prove_counts(n_constraints: int) -> dict:
    """One prove of the squaring chain of `n_constraints` (a key over an SRS
    tiled from 64 multiples of G1), NTTs and MSMs as on the card."""
    nttmod.ntt = _replaced(nttmod.ntt, {"mont_mul": 2, "digit_mm_norm": 2})
    nttmod.intt = _replaced(nttmod.intt, {"mont_mul": 2, "digit_mm_norm": 2})
    msm_mod.MSMContext.run = _replaced(msm_mod.MSMContext.run, {"msm": 1})
    cv = hc.BN254
    r1cs, wit = inputs.plonk_circuit(cv.fr, n_constraints)
    lowered = plonk_setup.process_constraints(cv.fr, r1cs)
    m = 9 * fflonk_setup._domain(len(lowered[0])) + 18
    (gx, gy), _ = inputs.point_tables(cv, 64, 1)
    srs = pcodec.g1_lem_to_bytes(cv.fq, inputs.tiled(gx, m), inputs.tiled(gy, m),
                                 np.zeros(m, bool))
    zk = read_fflonk_zkey(fflonk_setup._write_fflonk_zkey(
        cv, r1cs, lowered, srs, cv.g2, lambda msg: None, torch.device("cpu")))
    COUNTS.clear()
    ON[0] = True
    fflonk.prove(zk, wit, b=list(range(1, 11)), device="cpu")
    ON[0] = False
    return {"power": zk.power, **COUNTS}


if __name__ == "__main__":
    torch.set_num_threads(2)
    _count_ops()
    if "--msm" in sys.argv:
        print(json.dumps({"msm": msm_counts()}))
        sys.exit()
    lo, hi = prove_counts(20), prove_counts(40)       # domains 2^5, 2^6
    ops = ("mont_mul", "add", "sub", "neg")
    at18 = {k: lo.get(k, 0) + (hi.get(k, 0) - lo.get(k, 0)) * (18 - lo["power"]) for k in ops}
    at18["mont_mul"] += 33 * 3
    at18["add"] += 33
    print(json.dumps({"2^5": lo, "2^6": hi, "2^18 without the MSMs": at18,
                      "msms": hi["msm"], "digit_mm_norm": hi["digit_mm_norm"]}))
