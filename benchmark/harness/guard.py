"""What the process that prints the result may not have loaded: JAX and the
JAX package the port was made from, compared by whole top-level name (the
port's package name begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "snarkjs_tpu")


def loaded_forbidden(modules=None) -> list:
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))
