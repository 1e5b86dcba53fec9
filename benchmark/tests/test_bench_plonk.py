"""The PLONK configuration end to end on the CPU at a tiny size: a run of a
tiny plonk_bn128 cell, through the port's plain versions, is correct and
its traced run reports what the benchmark lists for plonk_bn128.p20; its
control (the reference's proof with b = 0) and a proof altered where it is
produced are not correct.  The two PLONK readers on hand-made spans and
ranges: idle under the rounds' spans only, and no quotient share from a
prover that writes no "Multiexp" lines."""

import json
import os
from types import SimpleNamespace

import pytest

from benchmark.families import plonk_chain
from benchmark.harness import spans, spec
from benchmark.harness.spec import reader
from benchmark.harness.trace import Profile
from benchmark.tests.conftest import ROOT, make_root, run_tiny

CELL = "plonk_bn128.tiny"
# what the committed benchmark reads in the PLONK cell
METRICS = tuple(m["name"] for m in spec.load(ROOT)["per_layer"]
                if "plonk_bn128.p20" in m.get("workloads", ["plonk_bn128.p20"]))


@pytest.fixture
def plonk_root(tmp_path):
    """The tiny benchmark of conftest with a tiny PLONK cell (20 constraints,
    domain 2^5) that reports what plonk_bn128.p20 reports."""
    root = make_root(tmp_path, constraints=20)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": CELL, "config": "plonk_bn128", "traffic": "tiny",
                               "chips": 1, "why": "a test on the CPU"})
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return root


def _make(root):
    return spec.config(root, "plonk_bn128")[0].make


def test_the_sound_run_is_correct_and_traced_gives_the_plonk_metrics(plonk_root):
    out = run_tiny(plonk_root, CELL, trace=True)
    assert out["correct"] is True and out["compared"]["wrong_values"]["value"] == 0
    assert out["compared"]["checked_ops"]["value"] == out["attempted"] == 4
    got = out["metrics"]
    assert {"plonk_quotient_roofline_pct", "plonk_poly_idle_ms", "msm_ms", "msm_roofline_pct",
            "field_launches", "msm_issue_idle_ms", "msm_finish_idle_ms", "h2d_mib",
            "table_build_s", "device_idle_pct"} <= set(METRICS)
    assert set(got) <= set(METRICS)
    # on the CPU the profiler sees no device events: the readers of the card's
    # time give nothing; the launch counter reads 0 (plain versions), the
    # program's counters over the root and the nine stages msm_X do read
    assert got["field_launches"]["value"] == 0 and got["h2d_mib"]["value"] == 0.0
    assert got["table_build_s"]["value"] >= 0 and got["msm_ms"]["value"] > 0
    assert not {"plonk_quotient_roofline_pct", "msm_roofline_pct", "plonk_poly_idle_ms",
                "msm_issue_idle_ms", "msm_finish_idle_ms", "device_idle_pct"} & set(got)


def _span(name, parent, a, b):
    return SimpleNamespace(name=name, parent=parent, start_ns=a, end_ns=b, counters={})


def _proof(t0=0):
    """One hand-made PLONK proof over [t0, t0 + 100): a round, a commitment
    with a child, a round with a child, and the logger."""
    at = lambda name, parent, a, b: _span(name, parent, t0 + a, t0 + b)
    return [_span("plonk.prove", None, t0, t0 + 100),
            at("plonk.wires", 0, 0, 30), at("msm", 0, 30, 50), at("msm.finish", 2, 40, 50),
            at("plonk.quotient", 0, 50, 90), at("fops.scan", 4, 60, 70),
            at("prove.logger", 0, 90, 95)]


def test_poly_idle_is_the_idle_under_the_rounds_spans(monkeypatch):
    # the card busy over [10, 20), [35, 45), [65, 100) of each proof
    busy = [(10, 20), (35, 45), (65, 100)]
    two = [_proof(0), _proof(1000)]
    monkeypatch.setattr(spans, "roots", lambda run: two)
    run = SimpleNamespace(traced=[1, 2], profile=SimpleNamespace(
        device=[(s, e, "k") for s, e in busy]))
    # proof 1: wires 20, quotient 10 and its child's 5; the msm spans' 10 not;
    # proof 2, all idle: wires 30, quotient 40 (its child's 10 in it)
    assert reader(ROOT, "plonk_poly_idle_ms").read(run) == pytest.approx((35 + 70) / 2 / 1e6)
    monkeypatch.setattr(spans, "roots", lambda run: [[_span("groth16.prove", None, 0, 100)]] * 2)
    assert reader(ROOT, "plonk_poly_idle_ms").read(run) is None


def _ranges(lines, stage_of):
    """The profiler ranges StageClock opens for a call that writes these
    lines, one time unit a line: [(stage, start, end)]."""
    stages = ["entry"] + [stage_of(x) for x in lines]
    return [(st, 10 * i, 10 * i + 10) for i, st in enumerate(stages)]


def test_the_quotient_share_needs_the_multiexp_lines():
    stage_of = plonk_chain.Cell.stage_of
    rounds = ["Round %d: ..." % i for i in range(1, 6)]
    with_msm = (rounds[:3] + ["Multiexp T1", "Multiexp T2", "Multiexp T3"] + rounds[3:])
    reads = {}
    for name, lines in (("change", with_msm), ("parent", rounds)):
        ranges = _ranges(lines, stage_of)
        r3 = next(a for st, a, _ in ranges if st == "round3")
        run = SimpleNamespace(traced=[1], work={"domain": 2**5, "fr_bytes": 32},
                              profile=Profile(device=[(r3 + 1, r3 + 9, "k")], ranges=ranges))
        reads[name] = reader(ROOT, "plonk_quotient_roofline_pct").read(run)
    assert not any(st.startswith("msm_") for st, _, _ in _ranges(rounds, stage_of))
    assert reads["change"] > 0 and reads["parent"] is None


def test_the_control_is_not_correct(plonk_root):
    """b = 0: the blinded polynomials' commitments and evaluations, and
    everything after the first challenge, differ."""
    out = run_tiny(plonk_root, CELL, make_cell=plonk_chain.unblinded(_make(plonk_root)))
    assert out["correct"] is False
    assert out["compared"]["wrong_values"]["value"] >= 9 * out["compared"]["checked_ops"]["value"]


def test_an_answer_altered_where_it_is_produced(plonk_root):
    make = _make(plonk_root)

    def make_broken(config, mix, seed, device):
        cell = make(config, mix, seed, device)
        sound = cell.op

        def altered(request, logger=None):
            proof, publics = sound(request, logger)
            return dict(proof, eval_zw=str(int(proof["eval_zw"]) + 1)), publics

        cell.op = altered
        return cell

    out = run_tiny(plonk_root, CELL, make_cell=make_broken)
    assert out["correct"] is False
    assert out["compared"]["wrong_values"]["value"] == out["compared"]["checked_ops"]["value"]


@pytest.mark.cuda
def test_the_control_is_not_correct_on_card(plonk_root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = run_tiny(plonk_root, CELL, make_cell=plonk_chain.unblinded(_make(plonk_root)),
                   device="cuda")
    assert out["correct"] is False
    assert out["compared"]["wrong_values"]["value"] >= 9 * out["compared"]["checked_ops"]["value"]
