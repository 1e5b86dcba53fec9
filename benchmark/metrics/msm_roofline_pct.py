"""msm_roofline_pct: the five MSMs' least time on the card over the device
time of the kernels their stages launched, in %.

Work of the operation, whatever implements it: an MSM of n points with
b-bit scalars takes n ceil(b / 16) mixed additions (windows of 16 bits,
fixed here whatever the program uses).  A mixed addition is 7
multiplications and 4 squarings in the coordinates' field: on G1 11 Fq
products; on G2 the same over Fq2, 7 x 3 Fq products (Karatsuba) and 4 x 2
(complex squaring), so 29.  Bytes: each point's coordinates and each
scalar read once, one Jacobian point written.
Bound: the larger of bytes / HBM bandwidth and products (4 N^2 + N) IMADs /
the IMAD rate, N the words of Fq (harness/peaks.py).  Device time: the union
of the kernels that started inside the MSM stages' profiler ranges, averaged
over the profiled proofs.
"""

from benchmark.harness import peaks

WINDOW_BITS = 16
PRODUCTS_PER_MADD = {1: 11, 2: 29}


def work(w: dict) -> dict:
    windows = -(-w["scalar_bits"] // WINDOW_BITS)
    products = sum(m["points"] * windows * PRODUCTS_PER_MADD[m["group"]] for m in w["msms"])
    nbytes = sum(m["points"] * (2 * m["group"] * w["fq_bytes"] + w["fr_bytes"])
                 + 3 * m["group"] * w["fq_bytes"] for m in w["msms"])
    return {"products": products, "bytes": nbytes, "words": w["fq_bytes"] // 4}


def bound_s(w: dict) -> tuple:
    k = work(w)
    return peaks.bound_s(k["bytes"], k["products"] * peaks.imads_per_product(k["words"]))


def read(run):
    p = run.profile
    if p is None or not run.traced:
        return None
    t = p.stage_kernel_s(lambda st: st.startswith("msm_")) / len(run.traced)
    return 100.0 * bound_s(run.work)[0] / t if t > 0 else None
