"""op_p90_ms: the 90th percentile of the latency of every operation the
window completed, in ms (Python's statistics.quantiles, exclusive method;
the sample count is the window's operations)."""

import statistics


def read(run):
    lat = [(d.t1 - d.t0) * 1e3 for d in run.window.done]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10)[-1]
