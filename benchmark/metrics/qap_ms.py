"""qap_ms: host clock from the prove's QAP line to its first Multiexp line,
the card waited for at both (median over the window's proofs of the
--trace 1 run)."""

import statistics


def read(run):
    xs = [sum(t for st, t in d.extra["stages"] if st == "qap") * 1e3
          for d in run.window.done if "stages" in d.extra]
    return statistics.median(xs) if xs else None
