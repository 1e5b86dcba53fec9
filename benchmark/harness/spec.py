"""BENCHMARK.json: loading, the naming rules, and finding each piece by name.

A cell names a configuration and a traffic mix; a per-layer metric names
itself.  Each is found as a file of its own under benchmark/:
configs/<config>.py (with configs/<config>.json, the configuration as it is
run), traffic/<traffic>.json and metrics/<metric>.py.  Adding a
configuration, a mix or a metric adds files and entries; no file is edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class SpecError(ValueError):
    pass


def _need(cond, what):
    if not cond:
        raise SpecError(what)


def _name(v, what):
    _need(isinstance(v, str) and NAME.fullmatch(v) is not None, f"bad name {v!r} ({what})")


def _line(v, what):
    _need(isinstance(v, str) and 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v,
          f"bad text ({what})")


def bench_dir(root: str) -> str:
    return os.path.join(root, "benchmark")


def config_files(root: str, name: str) -> tuple:
    d = os.path.join(bench_dir(root), "configs")
    return os.path.join(d, f"{name}.py"), os.path.join(d, f"{name}.json")


def traffic_file(root: str, name: str) -> str:
    return os.path.join(bench_dir(root), "traffic", f"{name}.json")


def metric_file(root: str, name: str) -> str:
    return os.path.join(bench_dir(root), "metrics", f"{name}.py")


def _metric(m, end_to_end: bool, cells: set):
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if end_to_end else {"layer", "moves"})
    _need(keys <= set(m) <= keys | {"workloads"}, f"metric keys {sorted(m)}")
    _name(m["name"], "metric")
    _need(isinstance(m["unit"], str) and UNIT.fullmatch(m["unit"]) is not None,
          f"bad unit {m['unit']!r}")
    _need(m["better"] in ("lower", "higher"), f"better {m['better']!r}")
    _need(m["source"] in (("host_clock", "device_trace") if end_to_end else SOURCES),
          f"source {m['source']!r} of {m['name']}")
    if end_to_end:
        _need(isinstance(m["bound"], (int, float)) and 0 < m["bound"] <= 0.25,
              f"bound of {m['name']}")
    else:
        _line(m["layer"], f"layer of {m['name']}")
    for w in m.get("workloads", []):
        _need(w in cells, f"{m['name']} names an unknown cell {w}")


def validate(spec: dict, root: str) -> dict:
    """Raise SpecError unless `spec` keeps the benchmark's rules and every
    name it holds has its file."""
    _need(set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}, f"top-level keys {sorted(spec)}")
    _need(isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51,
          "run_seconds")
    configs = {}
    for c in spec["configs"]:
        _need(set(c) == {"name", "source", "file", "reduced", "why"}, f"config keys {sorted(c)}")
        _name(c["name"], "config")
        _need(c["name"] not in configs, f"config {c['name']} twice")
        _line(c["source"], "source")
        _line(c["why"], "why")
        for k in c["reduced"]:
            _name(k, "reduced")
        py, js = config_files(root, c["name"])
        _need(os.path.isfile(py) and os.path.isfile(js), f"no files for config {c['name']}")
        _need(os.path.normpath(os.path.join(root, c["file"])) == os.path.normpath(js),
              f"config {c['name']}: file is not {os.path.relpath(js, root)}")
        configs[c["name"]] = c
    cells, pairs = set(), set()
    for w in spec["workloads"]:
        _need(set(w) == {"name", "config", "traffic", "chips", "why"}, f"cell keys {sorted(w)}")
        _name(w["name"], "cell")
        _name(w["traffic"], "traffic")
        _need(w["name"] not in cells, f"cell {w['name']} twice")
        _need(w["config"] in configs, f"cell {w['name']}: unknown config {w['config']}")
        _need((w["config"], w["traffic"]) not in pairs, f"cell {w['name']}: pair twice")
        _need(w["chips"] in (1, 4), f"cell {w['name']}: chips")
        _need(os.path.isfile(traffic_file(root, w["traffic"])),
              f"cell {w['name']}: no traffic file {w['traffic']}")
        _line(w["why"], "why")
        cells.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
    names = set()
    e2e = {m["name"] for m in spec["end_to_end"]}
    _need("setup_s" in e2e, "no setup_s")
    for m in spec["end_to_end"]:
        _metric(m, True, cells)
    for m in spec["per_layer"]:
        _metric(m, False, cells)
        _need(m["moves"] in e2e, f"{m['name']} moves an unknown metric")
        _need(os.path.isfile(metric_file(root, m["name"])), f"no reader for {m['name']}")
    for m in spec["end_to_end"] + spec["per_layer"]:
        _need(m["name"] not in names, f"metric {m['name']} twice")
        names.add(m["name"])
    return spec


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return validate(json.load(f), root)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no cell {name}")


def metrics(spec: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: end-to-end ones, or with trace
    the per-layer ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def load_module(path: str, name: str):
    """Import a file of the benchmark by its path (its name may hold dots)."""
    mod_name = "benchmark_" + re.sub(r"\W", "_", name)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    sys.modules[mod_name] = mod
    s.loader.exec_module(mod)
    return mod


def config(root: str, name: str):
    """(the config's module, its JSON)."""
    py, js = config_files(root, name)
    with open(js) as f:
        return load_module(py, f"config_{name}"), json.load(f)


def traffic(root: str, name: str) -> dict:
    with open(traffic_file(root, name)) as f:
        return json.load(f)


def reader(root: str, name: str):
    return load_module(metric_file(root, name), f"metric_{name}")
