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
    """t on `device`; a copy from the host to a CUDA device is counted
    (`h2d_bytes`, `h2d_copies`)."""
    out = t.to(device)
    if out.device.type == "cuda" and t.device.type == "cpu":
        trace.add("h2d_bytes", t.nbytes)
        trace.add("h2d_copies")
    return out
