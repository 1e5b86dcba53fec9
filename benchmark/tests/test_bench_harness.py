"""The harness is driven by data: a new configuration, mix and metric are
found by name from new files and entries alone; what breaks the naming
rules is refused; without a card a run prints no result."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import guard, spec
from benchmark.tests.conftest import ROOT, TINY, run_tiny


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_the_benchmark_as_committed_keeps_its_rules():
    s = spec.load(ROOT)
    assert {w["name"] for w in s["workloads"]} == {"groth16_bn128.p22", "groth16_bls12381.p22"}
    assert all(w["chips"] == 1 for w in s["workloads"])


def test_new_config_traffic_and_metric_are_found_by_name(tiny_root):
    before = _files(tiny_root)
    cfg = os.path.join(tiny_root, "benchmark", "configs")
    shutil.copy(os.path.join(cfg, "groth16_bn128.py"), os.path.join(cfg, "groth16_bn128_b.py"))
    with open(os.path.join(cfg, "groth16_bn128.json")) as f:
        conf = json.load(f)
    with open(os.path.join(cfg, "groth16_bn128_b.json"), "w") as f:
        json.dump(dict(conf, g1_table=128, g2_table=16), f)
    with open(os.path.join(tiny_root, "benchmark", "traffic", "tiny_b.json"), "w") as f:
        json.dump(dict(TINY, constraints=20, pool=3), f)
    with open(os.path.join(tiny_root, "benchmark", "metrics", "ops_done.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.window.done))\n")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        old = json.load(f)
    s = json.loads(json.dumps(old))
    s["configs"].append({"name": "groth16_bn128_b", "source": "a test",
                         "file": "benchmark/configs/groth16_bn128_b.json", "reduced": [],
                         "why": "a test"})
    s["workloads"].append({"name": "groth16_bn128_b.tiny_b", "config": "groth16_bn128_b",
                           "traffic": "tiny_b", "chips": 1, "why": "a test"})
    s["end_to_end"].append({"name": "ops_done", "unit": "ops", "better": "higher",
                            "bound": 0.1, "source": "host_clock",
                            "workloads": ["groth16_bn128_b.tiny_b"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)

    out = run_tiny(tiny_root, "groth16_bn128_b.tiny_b")
    assert out["correct"] is True
    assert out["metrics"]["ops_done"]["value"] == out["attempted"] >= 1
    assert list(out)[-1] == "compared"
    after = _files(tiny_root)
    del before["BENCHMARK.json"]
    assert {k: after[k] for k in before} == before     # no file that was there changed
    assert all(s[k][:len(v)] == v for k, v in old.items() if isinstance(v, list))
    # the other cells do not report the new metric
    assert "ops_done" not in [m["name"] for m in spec.metrics(s, "groth16_bn128.tiny", False)]


def test_a_traced_run_reports_the_span_and_counter_metrics(tiny_root):
    out = run_tiny(tiny_root, "groth16_bls12381.tiny", trace=True)
    assert out["correct"] is True and out["attempted"] >= 1 + 3
    assert {"qap_ms", "msm_ms", "field_launches"} <= set(out["metrics"])
    assert "op_ms" not in out["metrics"]


def _refused(root, edit):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        s = json.load(f)
    edit(s)
    with pytest.raises(spec.SpecError):
        spec.validate(s, root)


@pytest.mark.parametrize("edit", [
    lambda s: s["workloads"][0].update(config="no_such_config"),
    lambda s: s["workloads"][0].update(traffic="no_such_mix"),
    lambda s: s["workloads"][0].update(name="a cell"),
    lambda s: s["workloads"][0].update(name="a,cell"),
    lambda s: s["workloads"][0].update(name="a/cell"),
    lambda s: s["workloads"][0].update(name="x" * 65),
    lambda s: s["end_to_end"][0].update(unit="µs"),
    lambda s: s["end_to_end"][0].update(unit="ms per op"),
    lambda s: s["end_to_end"][0].update(bound=0.3),
    lambda s: s["per_layer"][0].update(name="qap ms"),
    lambda s: s["per_layer"][0].update(moves="no_such_metric"),
    lambda s: s["per_layer"][0].update(why="metrics have no why"),
    lambda s: s["workloads"].append(dict(s["workloads"][0], name="again")),
    lambda s: s["end_to_end"].pop(),                       # setup_s
], ids=["config", "traffic", "space", "comma", "slash", "long", "greek-unit", "spaced-unit",
        "bound", "metric-name", "moves", "extra-key", "pair-twice", "no-setup"])
def test_a_broken_spec_is_refused(tiny_root, edit):
    _refused(tiny_root, edit)


def test_a_metric_without_its_reader_is_refused(tiny_root):
    os.remove(spec.metric_file(tiny_root, "qap_ms"))
    with pytest.raises(spec.SpecError):
        spec.load(tiny_root)


def test_forbidden_modules_are_compared_by_whole_name():
    assert guard.loaded_forbidden(["snarkjs_tpu_torch.protocols.groth16", "torch"]) == []
    assert guard.loaded_forbidden(["snarkjs_tpu.fields", "jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib", "snarkjs_tpu"]


@pytest.mark.parametrize("where", ["repo", "bare"])
def test_no_card_no_result(tmp_path, where):
    """Without a card, or in a directory that holds only
    BENCHMARK.json and benchmark/, the command exits non-zero and prints
    nothing on standard output."""
    cwd = ROOT
    if where == "bare":
        shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
        cwd = tmp_path
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "groth16_bn128.p22",
                        "--seed", str(2**40), "--seconds", "1", "--trace", "0"],
                       cwd=cwd, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout == ""


def test_the_closed_loop_sends_one_request_at_a_time():
    """The caller sends its next request when its last returns; every
    request is sent once, in order, and none after the window's end."""
    import time

    from benchmark.harness import loop, traffic

    inflight, most = [0], [0]

    def op(req):
        inflight[0] += 1
        most[0] = max(most[0], inflight[0])
        time.sleep(0.01)
        inflight[0] -= 1
        return req.index, {}

    mix = traffic.check(dict(TINY, pool=3))
    w = loop.closed(op, traffic.stream(mix, 1), 0.2)
    idx = [d.output for d in w.done]
    assert idx == list(range(len(idx))) and len(idx) > 3 and most[0] == 1
    assert all(d.t0 < w.start + 0.2 for d in w.done) and not w.failed
    assert [d.request.item for d in w.done] == [i % mix["pool"] for i in idx]


@pytest.mark.parametrize("callers", [0, 2, None])
def test_a_mix_with_other_than_one_caller_is_refused(callers):
    from benchmark.harness import traffic

    mix = dict(TINY, callers=callers)
    with pytest.raises(ValueError):
        traffic.check(mix)
