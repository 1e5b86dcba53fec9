"""msm_ms: host clock from the prove's first Multiexp line to its return,
the card waited for at each line: the five MSMs with their host finishes
and the blinding (median over the window's proofs of the --trace 1 run)."""

import statistics


def read(run):
    xs = [sum(t for st, t in d.extra["stages"] if st.startswith("msm_")) * 1e3
          for d in run.window.done if "stages" in d.extra]
    return statistics.median(xs) if xs else None
