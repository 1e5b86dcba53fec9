"""One run of one cell: set-up, warm-up, the measured window, the traced
proofs, the metrics, and the comparison with the reference.

The configuration's module (configs/<config>.py) gives `make(config, mix,
seed, device)`, an object with:
  op(request, logger=None)  the timed call of the program's entry point;
  stage_of(line)            the stage that a logger line of the entry opens;
  counters()                the program's counters, read, never reset;
  work()                    the sizes the metric readers count work from;
  free()                    drops the program's state;
  reference(requests)       the reference's answer to each request;
  wrong(output, want)       how many parts of an answer differ.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from . import loop, spec as spec_mod, traffic
from .trace import Profile, StageClock

TRACED = 3   # proofs run under the profiler in a --trace 1 run


@dataclass
class RunData:
    """What a metric reader reads."""
    window: loop.Window
    setup_s: float
    peak_window_bytes: int
    traced: list
    profile: Profile | None
    work: dict


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def compare(cell, done: list, failed: int) -> dict:
    """Every completed call against the reference: {name: {value, max|min}}."""
    wants = cell.reference([d.request for d in done])
    wrong = sum(cell.wrong(d.output, want) for d, want in zip(done, wants))
    return {"failed_ops": {"value": failed, "max": 0},
            "checked_ops": {"value": len(wants), "min": max(1, len(done))},
            "wrong_values": {"value": wrong, "max": 0}}


def passes(compared: dict) -> bool:
    return all(c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
               for c in compared.values())


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, make_cell=None) -> dict:
    """The result object of one run.  make_cell replaces the configuration's
    `make` (the control, the tests' faults)."""
    spec = spec_mod.load(root)
    cell_spec = spec_mod.cell(spec, workload)
    cfg_mod, cfg = spec_mod.config(root, cell_spec["config"])
    mix = traffic.check(spec_mod.traffic(root, cell_spec["traffic"]))
    wanted = spec_mod.metrics(spec, workload, trace)
    readers = {m["name"]: spec_mod.reader(root, m["name"]) for m in wanted}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    t = time.perf_counter()
    log(f"imports and spec {t - t_start:.3f} s")
    cell = (make_cell or cfg_mod.make)(cfg, mix, seed, dev)
    log(f"inputs made in {time.perf_counter() - t:.3f} s")
    for req in traffic.stream(mix, seed, "warmup"):
        if req.index >= mix["warmup"]:
            break
        t = time.perf_counter()
        cell.op(req)
        sync()
        log(f"warm-up call {req.index}: {time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"set-up {setup_s:.3f} s")

    clock = StageClock(cell.stage_of, sync)

    def op(req):
        if not trace:
            out = cell.op(req)
            sync()
            return out, {}
        before = cell.counters()
        clock.begin()
        out = cell.op(req, logger=clock)
        stages = clock.end()
        after = cell.counters()
        return out, {"stages": stages, "counters": {k: after[k] - v for k, v in before.items()}}

    requests = traffic.stream(mix, seed)
    window = loop.closed(op, requests, seconds)
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"window {window.seconds:.3f} s: {len(window.done)} done, {len(window.failed)} failed; "
        f"latencies ms {[round((d.t1 - d.t0) * 1e3, 1) for d in window.done]}")
    for _, tb in window.failed[:1]:
        log(tb)

    traced, profile = [], None
    if trace and window.done and not window.failed:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        ranged = StageClock(cell.stage_of, sync, ranges=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with torch_profile(activities=acts) as prof:
            for _ in range(TRACED):
                req = next(requests)
                t0 = time.perf_counter()
                ranged.begin()
                out = cell.op(req, logger=ranged)
                ranged.end()
                traced.append(loop.Done(req, out, t0, time.perf_counter()))
        t_read = time.perf_counter()
        profile = Profile.read(prof)
        log(f"profile read in {time.perf_counter() - t_read:.1f} s: {len(profile.device)} "
            f"device events, {profile.unattributed_kernels()} kernels outside the stages")
    peak = max(peak, peak_window, torch.cuda.max_memory_allocated(dev) if cuda else 0)

    data = RunData(window, setup_s, peak_window, traced, profile, cell.work())
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"attempted": len(window.done) + len(window.failed) + len(traced),
           "failed": len(window.failed), "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                      "count": cell_spec["chips"] if cuda else 1,
                      "memory_peak_bytes": peak}}
    if cuda:
        result["device"]["power_limit_w"] = _power_limit_w()
    if profile is not None and profile.ranges:
        result["device"]["busy_s"] = profile.busy_s()
        result["device"]["window_s"] = profile.window_s()
        result["breakdown"] = profile.breakdown()

    cell.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    compared = compare(cell, window.done + traced, len(window.failed))
    log(f"reference {time.perf_counter() - t_ref:.1f} s")
    result["correct"] = passes(compared)
    result["compared"] = compared
    for name, c in compared.items():
        rule = f"max {c['max']}" if "max" in c else f"min {c['min']}"
        log(f"compared {name} {c['value']} ({rule})")
    return result
