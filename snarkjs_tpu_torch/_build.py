"""Build the CUDA sources under csrc/ with nvcc at first use, load with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface
(`extern "C"` launchers that return the launch's cudaError_t), compiled for
Hopper (`sm_90a`) into `snarkjs_tpu_torch/_build/`.  The file name carries a
hash of the sources, so an edited kernel is rebuilt and a stale library is
never loaded.  `build_all()` starts one nvcc per source at once; the wrappers
call `library(name)`, which builds on demand.  The host code in
`csrc/<name>.cpp` (the BLAKE2b compression) is built the same way with g++
by `host_library(name)`, on any machine.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
OUT = os.path.join(_HERE, "_build")
SOURCES = ("field_ops", "msm_scan", "msm_reduce", "digit_mm", "digit_mm_norm")
ARCH = "arch=compute_90a,code=sm_90a"
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    return "nvcc"


def _digest(name: str) -> str:
    h = hashlib.sha256(ARCH.encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return h.hexdigest()[:12]


def lib_path(name: str) -> str:
    return os.path.join(OUT, f"lib{name}-{_digest(name)}.so")


def host_lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    with open(os.path.join(CSRC, f"{name}.cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(OUT, f"lib{name}-host-{h.hexdigest()[:12]}.so")


def log_path(name: str) -> str:
    """The ptxas report of the library at lib_path(name)."""
    return lib_path(name)[:-3] + ".log"


def _command(name: str, out: str) -> list[str]:
    return [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
            "-o", out, os.path.join(CSRC, f"{name}.cu")]


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel; returns ptxas reports.

    The report of each source (registers, spills, shared memory per kernel)
    is also written beside its library, under the same digest (`log_path`).
    """
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        path = lib_path(name)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, path)
    reports = {}
    failed = []
    for name, (proc, tmp, path) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        with open(log_path(name), "w") as f:
            f.write(text)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text[-4000:]}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if missing."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build_all((name,))
            _libs[name] = ctypes.CDLL(lib_path(name))
    return _libs[name]


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library for csrc/<name>.cpp, built with g++ first if
    missing.  A failed build raises; nothing falls back to Python."""
    key = f"host:{name}"
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        if key not in _libs:
            path = host_lib_path(name)
            if not os.path.exists(path):
                os.makedirs(OUT, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                try:
                    proc = subprocess.run(
                        ["g++", *HOST_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cpp")],
                        capture_output=True, text=True)
                except OSError as e:
                    raise RuntimeError(f"g++ failed for {name}: {e}") from e
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {name}:\n"
                                       f"{(proc.stdout + proc.stderr)[-4000:]}")
                os.replace(tmp, path)
            _libs[key] = ctypes.CDLL(path)
    return _libs[key]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
