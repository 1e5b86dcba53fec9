"""Device choice for the port's entry points: the card unless told otherwise."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` means "cuda".  Raises when CUDA is asked for and absent; the
    plain versions run only when the caller passes a CPU device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass device='cpu' to run the plain versions")
    return dev
