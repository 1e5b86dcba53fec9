"""snarkjs_tpu_torch/parallel/distributed.py: the process group, the mesh,
the shard ranges (against the JAX package's local_shard_slice) and the
launcher's limits (tests/_torch_dist.py worlds of Gloo ranks on the CPU)."""

import os
import time
import types

import numpy as np
import pytest

from snarkjs_tpu.parallel import distributed as jdist
from snarkjs_tpu_torch.parallel import distributed as tdist
from tests import _torch_dist as td


def test_init_without_a_rendezvous_does_nothing():
    assert tdist.init() is False
    assert tdist.device() is None


def _jax_slice(monkeypatch, n, ndev, r):
    """The JAX local_shard_slice of process r, one device a process."""
    import jax

    monkeypatch.setattr(jax, "process_index", lambda: r)
    mesh = types.SimpleNamespace(
        shape={"d": ndev},
        devices=np.array([types.SimpleNamespace(process_index=j) for j in range(ndev)]))
    return jdist.local_shard_slice(n, mesh)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return td.run_world(3, ("mesh_case",), tmp_path_factory.mktemp("world3"))


def test_prover_mesh_is_a_device_mesh_in_rank_order(world3):
    for r, out in enumerate(world3):
        m = out["mesh_case"]
        assert (m["type"], m["size"], m["rank"], m["device_type"]) == ("DeviceMesh", 3, r,
                                                                       "cpu")


@pytest.mark.parametrize("n", td.SLICE_NS)
def test_local_shard_slice_gives_the_jax_ranges(world3, monkeypatch, n):
    """n not divisible by the world size too: blocks of ceil(n / 3), the
    last one shorter, as the JAX function gives each process."""
    for r, out in enumerate(world3):
        assert out["mesh_case"]["slices"][n] == _jax_slice(monkeypatch, n, 3, r)


def _alive(pids):
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except OSError:
            pass
    return alive


def _children():
    import multiprocessing

    return [p.pid for p in multiprocessing.active_children()]


def test_a_rank_that_raises_makes_the_launcher_raise(tmp_path):
    t = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        td.run_world(3, ("raising_case",), tmp_path, timeout=60)
    assert time.monotonic() - t < 60
    assert not _alive(_children())


def test_the_join_limit_kills_every_rank(tmp_path):
    t = time.monotonic()
    with pytest.raises(TimeoutError):
        td.run_world(2, ("sleeping_case",), tmp_path, timeout=8)
    assert time.monotonic() - t < 40
    assert not _alive(_children())
