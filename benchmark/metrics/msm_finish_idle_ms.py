"""msm_finish_idle_ms: the card's idle time a proof while the host reads the
five MSMs' window partials back and combines them on bigints: the spans
`msm.readback` and `msm.finish` (snarkjs_tpu_torch.trace), over the
profiled proofs of the --trace 1 run; each idle gap is credited to the
innermost host span open then (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    idle = spans.idle_ms(run)
    return None if idle is None else idle["msm_finish"]
