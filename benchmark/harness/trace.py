"""Spans around the program's stages, and what the profiler saw in them.

The program's entry emits a line at each stage boundary through its
`logger` hook.  `StageClock` is that logger: at each line it waits for the
card, stamps the host clock and names the stage (the configuration maps a
line to a stage name).  Under the profiler it also opens a profiler range
`bench.<stage>` at each line and closes the last one when the call returns,
so every kernel the stage launched runs inside its range.

`Profile` reads the profiler's raw device events (kernels, copies, sets) and
the ranges, and gives the device time of each stage, the busy and idle time
of the traced window, and the breakdown.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

PREFIX = "bench."
NAME_CHARS = 100   # a device operation's name in the breakdown is cut to this


class StageClock:
    """The `logger` handed to the program's entry: `debug(line)`."""

    def __init__(self, stage_of, sync, ranges: bool = False):
        self.stage_of = stage_of
        self.sync = sync
        self.ranges = ranges
        self._open = None
        self.marks = []

    def _mark(self, label: str):
        self.sync()
        self.marks.append((label, time.perf_counter()))
        if self.ranges:
            from torch.profiler import record_function

            if self._open is not None:
                self._open.__exit__(None, None, None)
            self._open = record_function(PREFIX + label) if label else None
            if self._open is not None:
                self._open.__enter__()

    def begin(self):
        self.marks = []
        self._mark("entry")

    def debug(self, line: str):
        self._mark(self.stage_of(line))

    def end(self) -> list:
        """[(stage, seconds)] of the call just made."""
        self._mark("")
        return [(a[0], b[1] - a[1]) for a, b in zip(self.marks, self.marks[1:])]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(merged) -> float:
    return sum(e - s for s, e in merged)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", PREFIX))


@dataclass
class Profile:
    device: list      # (start_ns, end_ns, name) of every device event
    ranges: list      # (stage, start_ns, end_ns)

    @classmethod
    def read(cls, prof):
        """From a finished torch.profiler.profile, through its raw events
        (building key_averages() costs about a millisecond a launch)."""
        from torch.autograd import DeviceType

        device, ranges = [], []
        for e in prof.profiler.kineto_results.events():
            name, t0, dt = e.name(), e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if dt > 0 and not name.startswith(PREFIX):
                    device.append((t0, t0 + dt, name))
            elif name.startswith(PREFIX):
                ranges.append((name[len(PREFIX):], t0, t0 + dt))
        return cls(device, ranges)

    @property
    def window(self) -> tuple:
        return (min(r[1] for r in self.ranges), max(r[2] for r in self.ranges))

    def window_s(self) -> float:
        a, b = self.window
        return (b - a) / 1e9

    def busy_s(self) -> float:
        a, b = self.window
        return _length(_union((max(s, a), min(e, b)) for s, e, _ in self.device
                              if e > a and s < b)) / 1e9

    def stage_kernel_s(self, want) -> float:
        """Device time (union) of the kernels that started inside the ranges
        of the stages for which want(stage) holds."""
        spans = [(s, e) for st, s, e in self.ranges if want(st)]
        ks = [(s, e) for s, e, name in self.device if is_kernel(name)
              and any(a <= s <= b for a, b in spans)]
        return _length(_union(ks)) / 1e9

    def unattributed_kernels(self) -> int:
        """Kernels that started outside every stage range: a handful at most,
        since StageClock waits for the card at each boundary."""
        return sum(1 for s, _, name in self.device if is_kernel(name)
                   and not any(a <= s <= b for _, a, b in self.ranges))

    def breakdown(self, top: int = 10) -> dict:
        by_op = {}
        for s, e, name in self.device:
            key = name[:NAME_CHARS]
            by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e9
        a, b = self.window
        merged = _union((max(s, a), min(e, b)) for s, e, _ in self.device if e > a and s < b)
        edges = [a] + [x for iv in merged for x in iv] + [b]
        idle = {}
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                stage = next((st for st, s, e in self.ranges if s <= g0 < e), "between calls")
                idle[stage] = idle.get(stage, 0.0) + (g1 - g0) / 1e9
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": order(by_op), "idle_gaps": order(idle)}
