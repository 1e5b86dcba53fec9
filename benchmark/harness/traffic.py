"""The one traffic generator: requests from a mix's parameters and a seed.

A mix (traffic/<name>.json) gives the number of callers (1: the loop is
closed, each request sent when the last one returns), the warm-up calls,
the size of the pool of distinct inputs that requests cycle through, and
the configuration's own sizes (read by the configuration, not here).  Request
k uses pool item k mod pool and carries 64 random bits of its own (the
configuration turns them into, say, blinding scalars).  The same seed gives
the same requests in the same order, whatever the speed of the system.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

@dataclass(frozen=True)
class Request:
    index: int
    item: int      # pool item
    bits: int      # this request's own random draw


def check(mix: dict) -> dict:
    if mix.get("callers") != 1:
        raise ValueError("traffic key callers must be 1: the loop has one request in flight")
    for k in ("pool", "warmup"):
        if not isinstance(mix.get(k), int) or mix[k] < (0 if k == "warmup" else 1):
            raise ValueError(f"traffic key {k} must be a whole number")
    return mix


def stream(mix: dict, seed: int, tag: str = "window"):
    """Endless requests; warm-up and window draw from separate streams."""
    rng = random.Random(f"{tag}/{seed}")
    k = 0
    while True:
        yield Request(k, k % mix["pool"], rng.getrandbits(64))
        k += 1


def rng(seed: int, tag: str) -> random.Random:
    """A generator for the inputs a configuration makes from the seed."""
    return random.Random(f"{tag}/{seed}")
