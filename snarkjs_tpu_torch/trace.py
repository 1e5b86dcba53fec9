"""Spans and counters of the port, on the clock of the torch profiler.

Counters: one registry, always on.  `add(name, n)` is one integer add where
the work happens; `counters()` reads every counter, with K-field's launches
by op (`fcuda.LAUNCHES`, read where they are kept) as `k_field.<op>` and
their sum as `k_field`.  `reset_counters()` zeroes them all.

Spans: `root(name, **attrs)` opens the root span of one request.  It
records only when the torch profiler is on as it opens
(`torch.autograd._profiler_enabled()`, checked there once); an operator gets
the spans by profiling.  Inside a recording root, `span(name, **attrs)`
records a child of the innermost open span; everywhere else it is a shared
no-op after one check of a module global.  A span holds its name,
attributes, start and end, its parent, the id of its request, and the
deltas of every counter over it.  Its stamps are `time.time_ns()`, the
Unix-epoch nanoseconds of the profiler's events, so a span and the card's
events lie on one timeline and an idle gap of the card can be put down to
the host span open then.  Spans are host times: they never wait for the
card, and they open no profiler range (a range would show among the card's
events).  The last `KEEP` completed roots stay in memory: `recent(n)`.
Spans record on the thread that opened the root.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from dataclasses import dataclass, field

import torch

KEEP = 8
COUNTERS = ("k_scan", "k_reduce", "k_mm", "k_mm_norm", "h2d_bytes", "h2d_copies",
            "h2d_async_copies", "d2h_bytes", "d2h_copies", "table_builds",
            "table_build_ns", "coef_stagings")

_COUNTS = dict.fromkeys(COUNTERS, 0)
_RECENT = collections.deque(maxlen=KEEP)
_NOOP = contextlib.nullcontext()
_ids = itertools.count(1)
_req = None            # the recording request, or None
_building = [0]        # table builders open, so a nested build's time counts once


# ---------------------------------------------------------------- counters

def add(name: str, n: int = 1) -> None:
    _COUNTS[name] += n


def counters() -> dict:
    from .fields import fcuda

    out = dict(_COUNTS)
    for op, v in fcuda.LAUNCHES.items():
        out["k_field." + op] = v
    out["k_field"] = sum(fcuda.LAUNCHES.values())
    return out


def reset_counters() -> None:
    from .fields import fcuda

    for k in _COUNTS:
        _COUNTS[k] = 0
    fcuda.reset_counts()


def table(fn):
    """`functools.lru_cache(maxsize=None)` of a table builder, each miss
    counted (`table_builds`) and timed (`table_build_ns`, a build inside
    another counted once)."""
    @functools.wraps(fn)
    def build(*args, **kwargs):
        t = time.perf_counter_ns()
        _building[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _building[0] -= 1
            _COUNTS["table_builds"] += 1
            if not _building[0]:
                _COUNTS["table_build_ns"] += time.perf_counter_ns() - t

    return functools.lru_cache(maxsize=None)(build)


# ------------------------------------------------------------------- spans

@dataclass
class Span:
    name: str
    attrs: dict
    request: int             # the id of its root's request
    parent: int | None       # index of the parent in its root's list; None for the root
    start_ns: int
    end_ns: int = 0
    counters: dict = field(default_factory=dict)   # the counters' deltas, nonzero ones


class _Request:
    def __init__(self):
        self.id = next(_ids)
        self.thread = threading.get_ident()
        self.spans = []
        self.open = []       # indexes of the open spans, innermost last


def span(name: str, /, **attrs):
    """A context manager: a child span of the innermost open span."""
    if _req is None:
        return _NOOP
    return _record(_req, name, attrs)


def root(name: str, /, **attrs):
    """A context manager: the root span of a request, recording when the
    torch profiler is on; inside a recording root, a child span."""
    if _req is not None:
        return _record(_req, name, attrs)
    if not torch.autograd._profiler_enabled():
        return _NOOP
    return _record_root(name, attrs)


def recent(n: int = KEEP) -> list:
    """The last n completed roots, oldest first; each a list of its spans
    in the order they opened, the root first."""
    return list(_RECENT)[-n:] if n > 0 else []


@contextlib.contextmanager
def _record_root(name, attrs):
    global _req
    req = _req = _Request()
    try:
        with _record(req, name, attrs):
            yield
    finally:
        _req = None
        _RECENT.append(req.spans)


@contextlib.contextmanager
def _record(req, name, attrs):
    if threading.get_ident() != req.thread:
        yield
        return
    before = counters()
    s = Span(name, attrs, req.id, req.open[-1] if req.open else None, time.time_ns())
    req.open.append(len(req.spans))
    req.spans.append(s)
    try:
        yield
    finally:
        s.end_ns = time.time_ns()
        after = counters()
        s.counters = {k: v - before[k] for k, v in after.items() if v != before[k]}
        req.open.pop()
