"""Shared by the benchmark's tests: a copy of the benchmark with tiny cells,
runs on the CPU through the port's plain versions, and one torch thread.

Run from the repo root: `python -m pytest benchmark/tests -q` (the cases
marked `cuda` skip without a card; on the card: `-m cuda`).
"""

import json
import os
import shutil
import time

import pytest
import torch

from benchmark.harness import runner

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"callers": 1, "pool": 2, "warmup": 0, "constraints": 30, "public_inputs": 1}
CELLS = {"groth16_bn128.tiny": "groth16_bn128", "groth16_bls12381.tiny": "groth16_bls12381"}


@pytest.fixture(autouse=True, scope="session")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_root(path, constraints: int = TINY["constraints"]) -> str:
    """A copy of BENCHMARK.json and benchmark/ at `path`, with a tiny mix and
    a tiny cell of each configuration that reports every per-layer metric."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(path, "benchmark", "traffic", "tiny.json"), "w") as f:
        json.dump(dict(TINY, constraints=constraints), f)
    for name, cfg in CELLS.items():
        spec["workloads"].append({"name": name, "config": cfg, "traffic": "tiny",
                                  "chips": 1, "why": "a test on the CPU"})
    for m in spec["per_layer"]:
        m.setdefault("workloads", []).extend(CELLS)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def run_tiny(root, cell="groth16_bn128.tiny", seed=2**40 + 7, trace=False, make_cell=None,
             device="cpu"):
    """One run of a tiny cell: a window that closes after its first call."""
    return runner.run(root, cell, seed, 0.01, trace, device, time.perf_counter(),
                      make_cell=make_cell)
