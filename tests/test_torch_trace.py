"""The port's tracer (`snarkjs_tpu_torch/trace.py`): spans recorded only under
the torch profiler, on its clock, in the trees of `groth16.prove` and
`plonk.prove`; the counter registry; nothing recorded and the same proof
without the profiler.

On the stored tiny bn128 fixtures, with the plain versions (device="cpu")."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from snarkjs_tpu_torch import device as devmod
from snarkjs_tpu_torch import trace
from snarkjs_tpu_torch.protocols import groth16 as tg
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
R, S = 0x1111, 0x2222

MSM_CHILDREN = ["msm.recode", "msm.sort", "msm.scan", "msm.phase2", "msm.readback",
                "msm.finish"]
# (name, parent's name) of every span of one prove, in the order they open
TREE = ([("groth16.prove", None), ("prove.witness_upload", "groth16.prove"),
         ("prove.logger", "groth16.prove"), ("qap", "groth16.prove"),
         ("qap.coef_upload", "qap"), ("qap.build_abc", "qap"), ("qap.ntt", "qap"),
         ("qap.ntt", "qap"), ("qap.ntt", "qap"), ("qap.pointwise", "qap")]
        + [x for _ in range(5) for x in [("prove.logger", "groth16.prove"),
                                          ("msm", "groth16.prove")]
           + [(c, "msm") for c in MSM_CHILDREN]]
        + [("prove.affine", "groth16.prove"), ("prove.blind", "groth16.prove")])
# an op that runs only inside one leaf span of the prove
ONLY_IN = {"aten::index_add_": "qap.build_abc", "aten::sort": "msm.sort",
           "aten::searchsorted": "msm.phase2"}


class _Lines:
    def __init__(self):
        self.lines = []

    def debug(self, line):
        self.lines.append(line)


def _prove(logger=None):
    return tg.prove_files(os.path.join(FIXTURES, "tiny_bn128.zkey"),
                          os.path.join(FIXTURES, "tiny_bn128.wtns"),
                          r=R, s=S, device="cpu", logger=logger)


def _stored_proof():
    with open(os.path.join(FIXTURES, "tiny_bn128_proof.json")) as f:
        want = json.load(f)
    return json.dumps((want["proof"], want["publicSignals"]))


@pytest.fixture(scope="module")
def profiled():
    """One prove under the profiler: (its spans, the profiler's CPU events
    as (name, start_ns, end_ns), the proof, the logger's lines)."""
    before = len(trace.recent())
    lines = _Lines()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        proof = _prove(lines)
    roots = trace.recent()
    assert len(roots) == min(before + 1, trace.KEEP)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return roots[-1], events, proof, lines.lines


def test_a_profiled_prove_records_one_root_with_the_tree(profiled):
    spans, _, proof, lines = profiled
    got = [(s.name, None if s.parent is None else spans[s.parent].name) for s in spans]
    assert got == TREE
    assert len({s.request for s in spans}) == 1
    assert spans[0].attrs == {"curve": "bn128", "domain": 64, "n_vars": 42}
    msms = [s.attrs for s in spans if s.name == "msm"]
    assert [m["name"] for m in msms] == ["A", "B1", "B2", "C", "H"]
    assert [m["group"] for m in msms] == [1, 1, 2, 1, 1]
    assert [m["points"] for m in msms] == [42, 42, 42, 40, 64]
    assert all(s.attrs == {"k": 6} for s in spans if s.name == "qap.ntt")
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # the logger's lines are the prover's, one prove.logger span each
    assert len(lines) == sum(s.name == "prove.logger" for s in spans) == 6
    assert json.dumps(proof) == _stored_proof()


def test_the_spans_are_on_the_profilers_clock(profiled):
    """Every aten:: event that starts inside a leaf span ends inside it, and
    the ops that only a given leaf runs lie within that leaf's stamps."""
    spans, events, _, _ = profiled
    aten = [(n, a, b) for n, a, b in events if n.startswith("aten::")]
    parents = {s.parent for s in spans}
    leaves = [s for i, s in enumerate(spans) if i not in parents]
    inside = 0
    for s in leaves:
        for n, a, b in aten:
            if s.start_ns <= a <= s.end_ns:
                assert b <= s.end_ns, (s.name, n)
                inside += 1
    assert inside > 100
    for op, leaf in ONLY_IN.items():
        runs = [(a, b) for n, a, b in aten if n == op]
        where = [(s.start_ns, s.end_ns) for s in spans if s.name == leaf]
        assert runs and all(any(x <= a and b <= y for x, y in where) for a, b in runs), op
    root = spans[0]
    assert all(root.start_ns <= a and b <= root.end_ns for n, a, b in aten
               if root.start_ns <= a <= root.end_ns)


def test_the_profiler_sees_no_range_named_by_the_program(profiled):
    spans, events, _, _ = profiled
    names = {n for n, _, _ in events}
    assert not names & {s.name for s in spans}
    assert not [n for n in names if n.startswith(("groth16.", "prove.", "qap", "msm"))]


def test_counter_deltas_are_taken_over_each_span(profiled):
    """A prove on the CPU copies nothing to a card; what a child span
    counts, its parent counts too."""
    spans, _, _, _ = profiled
    for s in spans:
        assert not {"h2d_bytes", "d2h_bytes"} & set(s.counters)
        if s.parent is not None and s.counters:
            p = spans[s.parent]
            assert all(p.counters[k] >= v for k, v in s.counters.items() if v > 0)


def test_without_the_profiler_nothing_is_recorded_and_the_proof_is_the_stored_one():
    before = [id(r) for r in trace.recent()]
    assert not torch.autograd._profiler_enabled()
    proof = _prove(_Lines())
    assert [id(r) for r in trace.recent()] == before
    assert json.dumps(proof) == _stored_proof()


def test_outside_a_recording_root_a_span_is_the_shared_no_op():
    assert trace.span("a") is trace.span("b", k=1) is trace.root("c")
    with trace.span("a"):
        with trace.root("r"):
            pass


def test_a_root_records_counter_deltas_and_the_last_roots_are_kept():
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(trace.KEEP + 2):
            with trace.root("r", i=i):
                with trace.span("a"):
                    trace.add("h2d_bytes", 5)
                    with trace.span("b"):
                        trace.add("d2h_copies")
                trace.add("table_builds", 2)
    roots = trace.recent()
    assert len(roots) == trace.KEEP
    assert [r[0].attrs["i"] for r in roots] == list(range(2, trace.KEEP + 2))
    assert trace.recent(2) == roots[-2:] and trace.recent(0) == []
    r, a, b = roots[-1]
    assert (r.parent, a.parent, b.parent) == (None, 0, 1)
    assert r.counters == {"h2d_bytes": 5, "d2h_copies": 1, "table_builds": 2}
    assert a.counters == {"h2d_bytes": 5, "d2h_copies": 1}
    assert b.counters == {"d2h_copies": 1}
    assert len({spans[0].request for spans in roots}) == trace.KEEP


def test_one_registry_holds_every_counter():
    from snarkjs_tpu_torch.fields import fcuda

    c = trace.counters()
    assert set(trace.COUNTERS) <= set(c)
    assert {"h2d_async_copies", "coef_stagings"} <= set(trace.COUNTERS)
    assert {"k_field." + op for op in fcuda.OPS} | {"k_field"} <= set(c)
    fcuda.LAUNCHES["add"] += 3
    assert trace.counters()["k_field"] == trace.counters()["k_field.add"] + sum(
        v for op, v in fcuda.LAUNCHES.items() if op != "add")
    trace.reset_counters()
    assert all(v == 0 for v in trace.counters().values())


def test_a_table_builder_counts_each_miss_once_and_times_nested_builds_once():
    calls = []

    @trace.table
    def inner(k):
        calls.append(k)
        return k * 2

    @trace.table
    def outer(k):
        return inner(k) + 1

    before = trace.counters()
    assert outer(3) == 7 and outer(3) == 7 and inner(3) == 6
    after = trace.counters()
    assert calls == [3]
    assert after["table_builds"] - before["table_builds"] == 2
    assert after["table_build_ns"] > before["table_build_ns"]


def test_an_upload_counts_only_copies_to_a_card():
    before = trace.counters()
    t = devmod.upload(torch.zeros(10, dtype=torch.int32), "cpu")
    assert t.device.type == "cpu"
    assert trace.counters() == before


@pytest.mark.cuda
def test_an_upload_from_pinned_memory_is_counted_as_asynchronous():
    """A pinned source goes with `non_blocking` and counts `h2d_async_copies`
    and its bytes; a pageable one counts `h2d_copies`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; page-locked memory needs CUDA")
    src = torch.arange(1 << 20, dtype=torch.int64)
    keys = ("h2d_bytes", "h2d_copies", "h2d_async_copies")
    delta = lambda before: {k: trace.counters()[k] - before[k] for k in keys}
    before = trace.counters()
    out = devmod.upload(src.pin_memory(), "cuda")
    torch.cuda.synchronize()
    assert delta(before) == {"h2d_bytes": src.nbytes, "h2d_copies": 0, "h2d_async_copies": 1}
    assert out.device.type == "cuda" and torch.equal(out.cpu(), src)
    before = trace.counters()
    devmod.upload(src, "cuda")
    assert delta(before) == {"h2d_bytes": src.nbytes, "h2d_copies": 1, "h2d_async_copies": 0}


# ------------------------------------------------------------------ PLONK

PLONK_MSMS = ["A", "B", "C", "Z", "T1", "T2", "T3", "Wxi", "Wxiw"]
# the root's children but the logger's, in the order they open
PLONK_TOP = (["plonk.witness", "plonk.wires"] + ["msm"] * 3 + ["plonk.perm", "msm",
             "plonk.quotient"] + ["msm"] * 3 + ["plonk.evals", "plonk.open", "msm", "msm"])


def _plonk_prove(logger=None):
    from snarkjs_tpu_torch.protocols import plonk as tp

    with open(os.path.join(FIXTURES, "tiny_plonk_bn128_proof.json")) as f:
        want = json.load(f)
    got = tp.prove_files(os.path.join(FIXTURES, "tiny_plonk_bn128.zkey"),
                         os.path.join(FIXTURES, "tiny_plonk_bn128.wtns"), b=want["b"],
                         device="cpu", logger=logger)
    return got, (want["proof"], want["publicSignals"])


@pytest.fixture(scope="module")
def plonk_profiled():
    """One PLONK prove of the stored tiny fixture under the profiler: (its
    spans, the proof, the stored proof, the logger's lines)."""
    lines = _Lines()
    with profile(activities=[ProfilerActivity.CPU]):
        got, want = _plonk_prove(lines)
    return trace.recent(1)[0], got, want, lines.lines


def test_a_profiled_plonk_prove_records_its_rounds_and_nine_msms(plonk_profiled):
    spans, got, want, lines = plonk_profiled
    assert got == want
    root = spans[0]
    assert (root.name, root.parent, root.attrs) == ("plonk.prove", None,
                                                    {"curve": "bn128", "domain": 64})
    assert [s.name for s in spans if s.parent == 0 and s.name != "prove.logger"] == PLONK_TOP
    msms = [i for i, s in enumerate(spans) if s.name == "msm"]
    assert [spans[i].attrs for i in msms] == [
        {"name": k, "points": m} for k, m in zip(PLONK_MSMS, [66, 66, 66, 67, 65, 65, 70, 70, 67])]
    for i in msms:
        assert [s.name for s in spans if s.parent == i] == MSM_CHILDREN
    assert all(spans[s.parent].name == "msm" for s in spans if s.name.startswith("msm."))
    for s in spans[1:]:
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert len({s.request for s in spans}) == 1
    # a logger line before each round and each commitment, one prove.logger span each
    assert len(lines) == sum(s.name == "prove.logger" for s in spans) == 14
    assert [x for x in lines if x.startswith("Multiexp")] == [f"Multiexp {k}" for k in PLONK_MSMS]
    assert [x.split(":")[0] for x in lines if x.startswith("Round")] == [
        f"Round {k}" for k in range(1, 6)]


def test_plonk_counter_deltas_of_the_children_sum_to_their_parents(plonk_profiled):
    """The root's own code counts nothing: every counter's delta over the
    root is the sum of its children's; the same for each msm span."""
    spans = plonk_profiled[0]
    for i in [0] + [i for i, s in enumerate(spans) if s.name == "msm"]:
        kids = [s for s in spans if s.parent == i]
        for k, v in spans[i].counters.items():
            assert sum(s.counters.get(k, 0) for s in kids) == v, (spans[i].name, k)


def test_without_the_profiler_a_plonk_prove_records_nothing():
    before = [id(r) for r in trace.recent()]
    assert not torch.autograd._profiler_enabled()
    got, want = _plonk_prove(_Lines())
    assert [id(r) for r in trace.recent()] == before
    assert got == want
