"""device_idle_pct: 100 (1 - busy / window) over the profiled proofs of the
--trace 1 run, busy being the union of every device event's interval
(kernels, copies, sets) from torch.profiler and the window the span from
the first profiled proof's start to the last one's end."""


def read(run):
    p = run.profile
    if p is None or not p.ranges:
        return None
    busy = p.busy_s()
    return 100.0 * (1.0 - busy / p.window_s()) if busy > 0 else None
