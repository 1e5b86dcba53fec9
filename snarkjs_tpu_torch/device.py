"""Device choice for the port's entry points: the card unless told otherwise."""

from __future__ import annotations

import torch

from . import trace


def resolve(device=None) -> torch.device:
    """`None` means "cuda".  Raises when CUDA is asked for and absent; the
    plain versions run only when the caller passes a CPU device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass device='cpu' to run the plain versions")
    return dev


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """t on `device`.  A copy from the host to a CUDA device is counted in
    `h2d_bytes`; from page-locked memory it is enqueued on the current
    stream without waiting (`h2d_async_copies`), else it blocks
    (`h2d_copies`).  A pinned source must not be written while its copy may
    be in flight."""
    h2d = torch.device(device).type == "cuda" and t.device.type == "cpu"
    pinned = h2d and t.is_pinned()
    out = t.to(device, non_blocking=pinned)
    if h2d:
        trace.add("h2d_bytes", t.nbytes)
        trace.add("h2d_async_copies" if pinned else "h2d_copies")
    return out
