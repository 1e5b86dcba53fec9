"""The closed loop: one caller sends its next request when its last returns.

The caller sends until `seconds` have passed since the start; a request in
flight then runs to its end, so the window closes when it returns.  A
request that raises is counted as failed, and the loop stops.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field


@dataclass
class Done:
    request: object
    output: object
    t0: float
    t1: float
    extra: dict = field(default_factory=dict)


@dataclass
class Window:
    done: list
    failed: list
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


def closed(op, requests, seconds: float) -> Window:
    """op(request) -> (output, extra dict); requests: an iterator."""
    done, failed = [], []
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        req = next(requests)
        t0 = time.perf_counter()
        try:
            out, extra = op(req)
        except Exception:  # a failed request is a result: record it, stop
            failed.append((req, traceback.format_exc()))
            break
        done.append(Done(req, out, t0, time.perf_counter(), extra))
    return Window(done, failed, start, time.perf_counter())
