"""Layouts the families' key writers share: integers as the port's 16-bit
limb columns, and a short table of points tiled along a key section."""

from __future__ import annotations

import numpy as np


def limbs(vals, nbytes: int) -> np.ndarray:
    """ints -> (nbytes / 2, len) uint32 16-bit limbs, little-endian: one
    column a value, as the port's keys and witnesses hold them."""
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in vals)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(vals), nbytes // 2)
    return np.ascontiguousarray(u16.T).astype(np.uint32)


def tiled(t, n: int):
    """The columns of t (an array, or a tuple of arrays such as a point's
    coordinates) repeated in order until there are n of them."""
    if isinstance(t, tuple):
        return tuple(tiled(x, n) for x in t)
    return np.ascontiguousarray(np.tile(t, (1, -(-n // t.shape[1])))[:, :n])
