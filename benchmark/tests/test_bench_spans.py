"""The readers of the program's spans and counters (harness/spans.py and the
six metrics on it): idle gaps cut at span boundaries and credited to the
innermost span, nothing outside the roots; None from a program without the
tracer; a tiny traced run on the CPU reports them or leaves them out."""

import sys
from types import SimpleNamespace

import pytest

from benchmark.harness import spans, spec
from benchmark.harness.trace import _union
from benchmark.tests.conftest import ROOT, run_tiny

NEW = ("entry_idle_ms", "qap_idle_ms", "msm_issue_idle_ms", "msm_finish_idle_ms", "h2d_mib",
       "table_build_s")
IDLE = {"entry_idle_ms": "entry", "qap_idle_ms": "qap", "msm_issue_idle_ms": "msm_issue",
        "msm_finish_idle_ms": "msm_finish"}


def _span(name, parent, a, b, **counters):
    return SimpleNamespace(name=name, parent=parent, start_ns=a, end_ns=b, counters=counters)


def _root(t0=0, h2d=0):
    """One hand-made proof: the root over [t0, t0 + 100) and its spans."""
    at = lambda name, parent, a, b: _span(name, parent, t0 + a, t0 + b)
    return [_span("groth16.prove", None, t0, t0 + 100, h2d_bytes=h2d),
            at("qap", 0, 10, 50), at("qap.ntt", 1, 20, 30),
            at("msm", 0, 50, 90), at("msm.finish", 3, 80, 90),
            at("prove.logger", 0, 90, 90), at("msm.later_child", 3, 60, 70)]


# the card busy over [5, 15), [25, 60), [85, 200), and long before the root
BUSY = [(-50, -10), (5, 15), (25, 60), (85, 200)]


def test_idle_is_cut_at_span_boundaries_and_goes_to_the_innermost_span():
    root = _root()
    busy = _union(BUSY)
    got = spans.idle_ns(busy, root)
    # [0, 5) root, [5, 10) busy, [10, 20) qap: 5, [20, 30) qap.ntt: 5,
    # [30, 50) busy, [50, 60) busy, [60, 70) the unlisted child: 10,
    # [70, 80) msm: 10, [80, 90) msm.finish: 5, [90, 100) busy
    assert got == [5, 5, 5, 10, 5, 0, 10]
    assert sum(got) == 100 - (10 + 35 + 15)          # all the idle in the root, none outside
    assert [spans.group_of(root, i) for i in range(len(root))] == [
        "entry", "qap", "qap", "msm_issue", "msm_finish", "logger", "msm_issue"]


def test_a_child_that_opens_with_its_parent_takes_the_gap():
    root = [_span("groth16.prove", None, 0, 10), _span("msm", 0, 0, 10),
            _span("msm.readback", 1, 0, 4)]
    assert spans.idle_ns([], root) == [0, 6, 4]


def test_the_readers_average_over_the_profiled_proofs(monkeypatch):
    from benchmark.harness.spec import reader

    two = [_root(0, h2d=2**20), _root(1000, h2d=3 * 2**20)]
    monkeypatch.setattr(spans, "roots", lambda run: two)
    run = SimpleNamespace(traced=[1, 2], profile=SimpleNamespace(
        device=[(s, e, "k") for s, e in BUSY] + [(1005, 1015, "k")]))
    idle = spans.idle_ms(run)
    # the second proof: idle everywhere but [1005, 1015)
    assert idle["qap"] == pytest.approx((10 + 35) / 2 / 1e6)
    assert sum(idle.values()) == pytest.approx((40 + 90) / 2 / 1e6)
    for name, group in IDLE.items():
        assert reader(ROOT, name).read(run) == idle[group]
    assert reader(ROOT, "h2d_mib").read(run) == 2.0


def test_without_the_programs_tracer_every_reader_gives_none(monkeypatch):
    import snarkjs_tpu_torch
    from benchmark.harness.spec import reader
    from snarkjs_tpu_torch import trace

    run = SimpleNamespace(traced=[1, 2, 3], profile=SimpleNamespace(device=[(0, 1, "k")]))
    monkeypatch.setattr(trace, "recent", lambda n: [_root(), _root(200), _root(400)][:n])
    assert spans.roots(run) is not None
    assert None not in [reader(ROOT, name).read(run) for name in NEW]
    assert spans.roots(SimpleNamespace(traced=[1, 2, 3, 4])) is None   # fewer roots
    monkeypatch.delattr(snarkjs_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "snarkjs_tpu_torch.trace", None)   # the parent's program
    assert spans.roots(run) is None
    assert [reader(ROOT, name).read(run) for name in NEW] == [None] * len(NEW)


def test_the_benchmark_lists_the_six_metrics_for_both_cells():
    s = spec.load(ROOT)
    got = {m["name"]: m for m in s["per_layer"]}
    cells = [w["name"] for w in s["workloads"]]
    for name in NEW:
        assert got[name]["workloads"] == cells and got[name]["better"] == "lower"
    assert [m["name"] for m in s["per_layer"]][-len(NEW):] == list(NEW)


def test_a_tiny_traced_run_reports_them_or_leaves_them_out(tiny_root):
    out = run_tiny(tiny_root, trace=True)
    assert out["correct"] is True
    m = out["metrics"]
    assert all(isinstance(m[n]["value"], float) for n in NEW if n in m)
    assert m["h2d_mib"]["value"] == 0.0            # the CPU copies nothing to a card
    assert m["table_build_s"]["value"] >= 0
    assert not set(IDLE) & set(m)                   # no device events to attribute
