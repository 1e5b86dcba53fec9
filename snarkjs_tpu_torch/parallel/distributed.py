"""Process groups, the prover mesh and its collectives (port of
snarkjs_tpu/parallel/distributed.py).

The JAX package runs one controller over a `jax.sharding.Mesh` with axis
"d".  PyTorch runs one process per rank, so the port is SPMD over
`torch.distributed`: every rank calls the same function with the same full
inputs, takes its own contiguous block of the sharded axis
(`local_shard_slice`), and returns the same full result.

* `init()` joins this process to a group; the rendezvous comes by argument
  (a `file://` or `tcp://` URL, world size, rank), never from the process's
  variables.  With no arguments it does nothing and returns False, as the
  JAX function does for one process.
* `prover_mesh()` is the 1-D `DeviceMesh` over axis "d" that every sharded
  op takes (`GpuMSM.run_sharded`, `parallel.sharded`, the provers' and the
  ceremony's `mesh=`).  Its ranks are in rank order, which is the JAX
  package's host-major (process-major) device order.
* `all_gather`, `all_to_all`, `all_gather_bytes`, `broadcast_object`,
  `barrier` are the collectives the sharded code calls, on the mesh's
  group, whatever its backend: NCCL takes its tensors on the rank's card
  (a host tensor is copied there and back), Gloo takes them where they
  are, host or card (PyTorch's Gloo carries CUDA tensors for these
  collectives itself).
* `spawn()` runs a function on N ranks in fresh processes (start method
  `spawn`), joins them within a time limit, kills the survivors when one
  rank fails or the limit passes, and raises with the failed rank's
  traceback; it is what the CLI's `--devices N` and the tests use.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

AXIS = "d"
JOIN_LIMIT_S = 3600.0
_STATE = {"device": None}


def init(init_method: str | None = None, world_size: int | None = None,
         rank: int | None = None, backend: str | None = None,
         device=None) -> bool:
    """Join a process group.  Returns True when a group was initialized,
    False with no rendezvous (a single process: nothing to do).

    init_method: a `file://` or `tcp://` URL every rank is given; device:
    this rank's device (default "cuda"; a CUDA device becomes the current
    one); backend: default NCCL for a CUDA device, Gloo for the CPU."""
    if init_method is None:
        return False
    if world_size is None or rank is None:
        raise ValueError("init needs world_size and rank with init_method")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' for a CPU rank")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    _STATE["device"] = dev
    return True


def device() -> torch.device | None:
    """The device `init` gave this rank (None before `init`)."""
    return _STATE["device"]


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["device"] = None


def prover_mesh(n_devices: int | None = None, device_type: str | None = None):
    """1-D DeviceMesh(("d",)) over the group's ranks in rank order.

    Without a group (a single process that never called `init`) it first
    makes a one-rank group on `device_type` (default "cuda") over a `file://`
    store in a temporary directory.  n_devices must be the world size (a
    rank outside the mesh would have no block to work on)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        d = tempfile.mkdtemp(prefix="snarkjs-mesh-")
        init(f"file://{os.path.join(d, 'store')}", 1, 0, device=device_type or "cuda")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"prover_mesh: {n_devices} devices asked, the group has {world}")
    if device_type is None:
        device_type = _STATE["device"].type if _STATE["device"] is not None else "cpu"
    return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(AXIS,))


def mesh_size(mesh) -> int:
    return mesh.size(0)


def mesh_rank(mesh) -> int:
    return mesh.get_local_rank(AXIS)


def local_shard_slice(n: int, mesh) -> slice:
    """The [start, stop) range of a length-n "d"-sharded axis that this rank
    owns: blocks of ceil(n / ndev) in rank order, the last one shorter or
    empty (start >= stop), the JAX function's ranges."""
    ndev = mesh_size(mesh)
    per = -(-n // ndev)
    r = mesh_rank(mesh)
    return slice(r * per, min((r + 1) * per, n))


def _comm_device(group, t: torch.Tensor) -> torch.device:
    """Where the group's collective takes t: the rank's card for NCCL, t's
    own device for Gloo."""
    if dist.get_backend(group) == "nccl":
        return _STATE["device"]
    return t.device


def all_gather(mesh, t: torch.Tensor) -> torch.Tensor:
    """(ndev, *t.shape): every rank's t in rank order, on every rank, on
    t's device."""
    group = mesh.get_group(AXIS)
    src = t.to(_comm_device(group, t)).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh_size(mesh))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def all_to_all(mesh, t: torch.Tensor) -> torch.Tensor:
    """Dimension 0 of t in ndev equal chunks: chunk j goes to rank j, and
    the result's chunk j came from rank j."""
    group = mesh.get_group(AXIS)
    src = t.to(_comm_device(group, t)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


def all_gather_bytes(mesh, data) -> list:
    """Every rank's bytes (lengths may differ), in rank order."""
    n = torch.tensor([len(data)], dtype=torch.int64)
    sizes = all_gather(mesh, n).flatten().tolist()
    buf = torch.zeros(max(sizes), dtype=torch.uint8)
    if len(data):
        buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    every = all_gather(mesh, buf)
    return [every[j, :sizes[j]].numpy().tobytes() for j in range(len(sizes))]


def broadcast_object(mesh, obj):
    """Rank 0's `obj` on every rank (random draws made once)."""
    group = mesh.get_group(AXIS)
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group,
                               device=_comm_device(group, torch.empty(0)))
    return box[0]


def barrier(mesh):
    dist.barrier(group=mesh.get_group(AXIS))


# ----------------------------------------------------------- launching ranks

def _rank_main(rank, fn, world_size, store_dir, backend, devices, args):
    if torch.device(devices[rank]).type == "cpu" and world_size > 1:
        torch.set_num_threads(1)     # as torchrun: ranks sharing the host's cores
    init(f"file://{os.path.join(store_dir, 'store')}", world_size, rank,
         backend=backend, device=devices[rank])
    try:
        out = fn(rank, *args)
        with open(os.path.join(store_dir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        # written before the group closes, so a rank that fails first has
        # the earliest stamp (the others fail in a collective after it)
        with open(os.path.join(store_dir, f"error-{rank}.txt"), "w") as f:
            f.write(f"{time.time_ns()}\n{traceback.format_exc()}")
        raise
    finally:
        shutdown()


def _first_error(store_dir, world_size):
    """(rank, traceback) of the rank that failed first, or None."""
    first = None
    for r in range(world_size):
        try:
            with open(os.path.join(store_dir, f"error-{r}.txt")) as f:
                stamp, tb = f.read().split("\n", 1)
        except OSError:
            continue
        if first is None or int(stamp) < first[0]:
            first = (int(stamp), r, tb)
    return None if first is None else first[1:]


def _join(ctx, deadline, store_dir, world_size) -> bool:
    """ctx.join until the deadline; when a rank fails (the others are then
    killed), raise with the traceback of the rank that failed first."""
    import torch.multiprocessing as mp

    try:
        return ctx.join(timeout=max(0.0, deadline - time.monotonic()))
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        first = _first_error(store_dir, world_size)
        if first is None:
            raise
        raise RuntimeError(f"rank {first[0]} failed:\n{first[1]}") from e


def spawn(fn, world_size: int, args=(), devices=None, backend: str | None = None,
          timeout: float = JOIN_LIMIT_S, store_dir: str | None = None) -> list:
    """fn(rank, *args) on `world_size` fresh processes joined in one group;
    returns the ranks' return values in rank order.

    devices: one device per rank (default "cuda:r"); backend: as `init`;
    store_dir: an empty directory for the `file://` store and the results
    (default a new temporary one, removed afterwards).  fn must be
    importable by name (a module-level function).  When a rank raises, the
    others are killed and this raises with its traceback; when `timeout`
    seconds pass first, every rank is killed and TimeoutError raised."""
    import torch.multiprocessing as mp

    devices = list(devices or [f"cuda:{r}" for r in range(world_size)])
    if len(devices) != world_size:
        raise ValueError("spawn needs one device per rank")
    own = store_dir is None
    if own:
        store_dir = tempfile.mkdtemp(prefix="snarkjs-ranks-")
    try:
        ctx = mp.start_processes(_rank_main, args=(fn, world_size, store_dir, backend,
                                                   devices, tuple(args)),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not _join(ctx, deadline, store_dir, world_size):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world_size} ranks did not finish in {timeout:.0f} s")
        out = []
        for r in range(world_size):
            with open(os.path.join(store_dir, f"result-{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)
