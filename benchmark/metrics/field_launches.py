"""field_launches: the port's K-field launch counter (fcuda.LAUNCHES, all
four ops), read before and after each proof of the --trace 1 window; the
median of the differences."""

import statistics


def read(run):
    xs = [d.extra["counters"]["field_launches"] for d in run.window.done
          if "field_launches" in d.extra.get("counters", {})]
    return statistics.median(xs) if xs else None
