"""plonk_quotient_roofline_pct: PLONK's round 3 (the quotient) least time on
the card over the device time of the kernels its stage launched, in %.

Work of the operation, whatever implements it (n the domain, N the words of
Fr), as snarkjs's round 3 (src/plonk_prove.js, which the port's
protocols/plonk.py follows line for line) does it:
  products: 93 a point of the 4n domain: the point w (1); ap, bp, cp (3);
    w^2 and zp (3); w omega, its square and zWp (4); mul2 (5); the four
    selector terms with their blinding parts (8); the public input (1, one
    public); beta w and its k1, k2 (3); mul4 (27) and alpha (2) for the
    first permutation term; beta sigma1..3 (3), mul4 (27) and alpha (2) for
    the second; the Lagrange term (4); and the two inverse NTTs of 4n
    points, (4n / 2) log2(4n) butterflies of one product each;
  bytes: the 8 key evaluations (qm, ql, qr, qo, qc, sigma1..3), A, B, C and
    Z at 4n read once, T (4n) written once.
Bound: the larger of bytes / HBM bandwidth and products (4 N^2 + N) IMADs /
the IMAD rate (harness/peaks.py).  Device time: the union of the kernels
that started inside the stage `round3` ("Round 3: ..." to the first
"Multiexp" line after it), averaged over the profiled proofs; None from
a prover that writes no "Multiexp" lines.
"""

from benchmark.harness import peaks

PRODUCTS_PER_POINT = 93
READ, WRITTEN = 8 + 4, 1


def work(w: dict) -> dict:
    n4 = 4 * w["domain"]
    products = PRODUCTS_PER_POINT * n4 + 2 * (n4 // 2) * (n4.bit_length() - 1)
    nbytes = (READ + WRITTEN) * n4 * w["fr_bytes"]
    return {"products": products, "bytes": nbytes, "words": w["fr_bytes"] // 4}


def bound_s(w: dict) -> tuple:
    k = work(w)
    return peaks.bound_s(k["bytes"], k["products"] * peaks.imads_per_product(k["words"]))


def read(run):
    p = run.profile
    # without "Multiexp" lines, stage round3 runs on to "Round 4" and holds
    # the T1-T3 commitments: nothing then says where the quotient ends
    if p is None or not run.traced or not any(st.startswith("msm_") for st, _, _ in p.ranges):
        return None
    t = p.stage_kernel_s(lambda st: st == "round3") / len(run.traced)
    return 100.0 * bound_s(run.work)[0] / t if t > 0 else None
