"""msm_issue_idle_ms: the card's idle time a proof while the host issues the
five MSMs' device work: the spans `msm` (its own time), `msm.recode`,
`msm.sort`, `msm.scan`, `msm.phase2` and `msm.gather`
(snarkjs_tpu_torch.trace), over the profiled proofs of the --trace 1 run;
each idle gap is credited to the innermost host span open then
(harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    idle = spans.idle_ms(run)
    return None if idle is None else idle["msm_issue"]
