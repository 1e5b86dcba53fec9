"""qap_roofline_pct: the QAP's least time on the card over the device time of
the kernels its stage launched, in %.

Work of the operation, whatever implements it (n the domain, N the words of
Fr):
  products: 6 NTTs of n/2 log2 n butterflies, one product each; one product
    per coefficient in buildABC; 3 n to shift A, B, C to the coset; 2 n
    pointwise (C = A B on the domain, A B on the coset);
  bytes: each input and output element once: every coefficient (its value
    and its three 32-bit indices), the witness, P_odd.
Bound: the larger of bytes / HBM bandwidth and products (4 N^2 + N) IMADs /
the IMAD rate (harness/peaks.py).  Device time: the union of the kernels
that started inside the stage's profiler range, averaged over the profiled
proofs.
"""

from benchmark.harness import peaks


def work(w: dict) -> dict:
    n = w["domain"]
    products = 6 * (n // 2) * (n.bit_length() - 1) + w["coefficients"] + 3 * n + 2 * n
    nbytes = (w["coefficients"] * (w["fr_bytes"] + 12) + w["n_vars"] * w["fr_bytes"]
              + n * w["fr_bytes"])
    return {"products": products, "bytes": nbytes, "words": w["fr_bytes"] // 4}


def bound_s(w: dict) -> tuple:
    k = work(w)
    return peaks.bound_s(k["bytes"], k["products"] * peaks.imads_per_product(k["words"]))


def read(run):
    p = run.profile
    if p is None or not run.traced:
        return None
    t = p.stage_kernel_s(lambda st: st == "qap") / len(run.traced)
    return 100.0 * bound_s(run.work)[0] / t if t > 0 else None
