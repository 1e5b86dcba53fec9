"""qap_idle_ms: the card's idle time a proof under the span `qap` and its
children (`qap.coef_upload`, `qap.build_abc`, `qap.ntt`, `qap.pointwise`;
snarkjs_tpu_torch.trace), over the profiled proofs of the --trace 1 run;
each idle gap is credited to the innermost host span open then
(harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    idle = spans.idle_ms(run)
    return None if idle is None else idle["qap"]
