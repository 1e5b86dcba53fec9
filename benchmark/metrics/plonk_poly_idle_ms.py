"""plonk_poly_idle_ms: the card's idle time a proof under the PLONK prover's
polynomial work: the spans `plonk.witness`, `plonk.wires`, `plonk.perm`,
`plonk.quotient`, `plonk.evals` and `plonk.open` and what they hold
(snarkjs_tpu_torch.trace), over the profiled proofs of the --trace 1 run;
each idle gap is credited to the innermost host span open then
(harness/spans.py `idle_ns`).  The nine commitments' `msm` spans, siblings
of these, are read by msm_issue_idle_ms and msm_finish_idle_ms."""

from benchmark.harness import spans
from benchmark.harness.trace import _union

ROOT = "plonk.prove"
POLY = ("plonk.witness", "plonk.wires", "plonk.perm", "plonk.quotient", "plonk.evals",
        "plonk.open")


def _in_poly(root, i: int) -> bool:
    while i is not None:
        if root[i].name in POLY:
            return True
        i = root[i].parent
    return False


def read(run):
    rs = spans.roots(run)
    p = run.profile
    if rs is None or p is None or not p.device or any(r[0].name != ROOT for r in rs):
        return None
    busy = _union((s, e) for s, e, _ in p.device)
    ns = sum(idle for root in rs for i, idle in enumerate(spans.idle_ns(busy, root))
             if _in_poly(root, i))
    return ns / 1e6 / len(rs)
