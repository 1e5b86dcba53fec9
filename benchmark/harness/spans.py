"""The program's own spans (`snarkjs_tpu_torch.trace`) beside the profiler's
device events, on one clock.

The prover records its spans when it runs under the profiler: in a
--trace 1 run, the three profiled proofs, one root each.  A span's stamps
are `time.time_ns()`, the clock of the profiler's events, so each idle gap
of the card inside a root can be cut at the span boundaries and each piece
credited to the innermost host span open then (`idle_ns`).  Spans fall into
the groups the metrics read (`GROUPS`); a span whose name no group lists
takes its nearest listed ancestor's, and the root's is `entry`.

Against a program that has no tracer, or recorded fewer roots than proofs
were profiled, `roots` gives None and so does every reader.
"""

from __future__ import annotations

from .trace import _union

GROUPS = {
    "entry": ("prove.witness_upload", "prove.affine", "prove.blind"),
    "qap": ("qap", "qap.coef_upload", "qap.build_abc", "qap.ntt", "qap.pointwise"),
    "msm_issue": ("msm", "msm.recode", "msm.sort", "msm.scan", "msm.phase2", "msm.gather"),
    "msm_finish": ("msm.readback", "msm.finish"),
    "logger": ("prove.logger",),     # the benchmark's own logger: no metric reads it
}
_GROUP = {name: g for g, names in GROUPS.items() for name in names}


def roots(run):
    """The roots of the run's profiled proofs (each a list of spans, the
    root first), or None."""
    n = len(run.traced)
    if not n:
        return None
    try:
        from snarkjs_tpu_torch import trace
    except ImportError:
        return None
    got = trace.recent(n)
    return got if len(got) == n else None


def counter_total(name: str):
    """A counter of the program, the process's total so far, or None."""
    try:
        from snarkjs_tpu_torch import trace
    except ImportError:
        return None
    return trace.counters().get(name)


def pieces(spans) -> list:
    """The root's interval cut at every span boundary inside it:
    [(start, end, index of the innermost span open there)]."""
    root = spans[0]
    edges = sorted({t for s in spans for t in (s.start_ns, s.end_ns)
                    if root.start_ns <= t <= root.end_ns})
    out = []
    for a, b in zip(edges, edges[1:]):
        inner = max((i for i, s in enumerate(spans) if s.start_ns <= a and b <= s.end_ns),
                    key=lambda i: (spans[i].start_ns, i))
        out.append((a, b, inner))
    return out


def idle_ns(busy, spans) -> list:
    """The card's idle time inside the root, by span index: busy is the
    union of the card's events' (start, end), sorted (`trace._union`)."""
    out = [0] * len(spans)
    j = 0
    for a, b, i in pieces(spans):
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        out[i] += (b - a) - covered
    return out


def group_of(spans, i: int) -> str:
    while True:
        g = _GROUP.get(spans[i].name)
        if g is not None:
            return g
        if spans[i].parent is None:
            return "entry"
        i = spans[i].parent


def idle_ms(run):
    """{group: the card's idle ms a proof under its spans}, over the
    profiled proofs, or None."""
    rs = roots(run)
    p = run.profile
    if rs is None or p is None or not p.device:
        return None
    busy = _union((s, e) for s, e, _ in p.device)
    total = dict.fromkeys(GROUPS, 0)
    for spans in rs:
        for i, ns in enumerate(idle_ns(busy, spans)):
            total[group_of(spans, i)] += ns
    return {g: ns / 1e6 / len(rs) for g, ns in total.items()}
