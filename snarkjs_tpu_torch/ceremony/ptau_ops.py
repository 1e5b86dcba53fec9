"""Powers-of-tau operations (port of snarkjs_tpu/ceremony/ptau_ops.py), begun
with what the setups need: `lem_to_u`.  The rest of the ceremony (new,
contribute, beacon, challenge/response, verify, preparePhase2, truncate,
convert) is ROADMAP A4.
"""

from __future__ import annotations

import numpy as np

from .. import device as devmod
from ..fields import ftorch


def lem_to_u(cv, lem, n: int, g2: bool, device=None) -> bytes:
    """batchLEMtoU: n LEM points -> big-endian standard affine coordinates,
    F2 components swapped (c1 || c0); infinity stays all zeros.  The
    Montgomery reduction of every coordinate runs as one batch on `device`
    (None: the card)."""
    device = devmod.resolve(device)
    fq = cv.fq
    k = (4 if g2 else 2) * n
    u16 = np.frombuffer(lem, dtype="<u2", count=k * fq.nl).reshape(k, fq.nl)
    ctx = ftorch.get_ctx(fq.name)
    plain = ftorch.to_numpy(ftorch.from_mont(ctx, ftorch.to_tensor(u16.T, device)))
    le = np.ascontiguousarray(plain.T.astype("<u2")).view(np.uint8)
    be = le.reshape(k, fq.n8)[:, ::-1]
    if g2:
        be = be.reshape(n, 2, 2, fq.n8)[:, :, ::-1]
    return np.ascontiguousarray(be).tobytes()
