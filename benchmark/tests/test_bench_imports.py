"""The import rule, in fresh processes: a whole run of the harness loads no
JAX and not the JAX package (top-level names compared whole) and opens no
file of the repo outside benchmark/, the port and BENCHMARK.json; the
reference loads nothing of the port."""

import json
import os
import subprocess
import sys

from benchmark.tests.conftest import ROOT, make_root

RUN = r"""
import json, os, sys, time
opened = []
sys.addaudithook(lambda ev, args: opened.append(os.fspath(args[0]))
                 if ev == "open" and isinstance(args[0], (str, bytes, os.PathLike)) else None)
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from benchmark.harness import runner
out = runner.run({root!r}, "groth16_bn128.tiny", 2**45 + 1, 0.01, True, "cpu", time.perf_counter())
print(json.dumps({{"correct": out["correct"], "modules": sorted(sys.modules),
                  "opened": sorted(set(p if isinstance(p, str) else p.decode() for p in opened))}}))
"""

REFERENCE = r"""
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
from benchmark.reference import groth16 as ref
nc = 8
i = np.arange(nc, dtype=np.int32)
m = np.concatenate([np.tile([0, 1], nc), [0, 0]]).astype(np.int32)
c = np.concatenate([np.repeat(i, 2), [nc, nc + 1]]).astype(np.int32)
s = np.concatenate([np.repeat(i + 1, 2), [0, 1]]).astype(np.int32)
key = ref.Key(curve="bls12381", n_vars=nc + 2, n_public=1, domain=16,
              k0=dict(a=3, b1=4, b2=5, c=6, h=7), g1_period=4, g2_period=2, alpha=5, beta=7, delta=11, m=m, c=c, s=s,
              val=np.ones((16, len(m)), dtype=np.uint32))
w = np.arange(16 * (nc + 2), dtype=np.uint32).reshape(16, nc + 2) % 7
proof = ref.proof(key, ref.terms(key, w, "cpu"), 2, 3)
assert proof["pi_a"] is not None
print(json.dumps(sorted(sys.modules)))
"""


def _tops(modules):
    return {m.split(".")[0] for m in modules}


def _python(code, tmp_path):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=tmp_path, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_reads_only_its_own(tmp_path):
    root = make_root(tmp_path / "checkout")
    got = _python(RUN.format(repo=ROOT, root=root), tmp_path)
    assert got["correct"] is True
    assert not _tops(got["modules"]) & {"jax", "jaxlib", "flax", "snarkjs_tpu"}
    assert "snarkjs_tpu_torch" in _tops(got["modules"])
    allowed = [os.path.join(ROOT, "benchmark") + os.sep, os.path.join(ROOT, "snarkjs_tpu_torch")
               + os.sep, os.path.join(root, "benchmark") + os.sep,
               os.path.join(root, "BENCHMARK.json")]
    inside = [p for p in got["opened"] if os.path.abspath(p).startswith((ROOT + os.sep, root))]
    assert inside and all(os.path.abspath(p).startswith(tuple(allowed)) for p in inside), inside


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    tops = _tops(_python(REFERENCE.format(repo=ROOT), tmp_path))
    assert "benchmark" in tops
    assert not tops & {"snarkjs_tpu_torch", "snarkjs_tpu", "jax", "jaxlib"}
