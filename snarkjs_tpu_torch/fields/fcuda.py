"""K-field: the card's elementwise field kernel (csrc/field_ops.cu).

Replaces snarkjs_tpu/fields/fpal.py:PalField (`mont_mul`, `add`, `sub`,
`neg`, launched through `PalField._run`).  `ftorch` calls `launch` for
every op on a CUDA tensor; the plain versions of the same four ops live in
`ftorch` (`_mont_mul_plain` and friends) and serve CPU tensors.

Bound on the card: bytes (a stream of 16-bit limbs in u32 words); the design
note is in the source.  `LAUNCHES` counts kernel launches per op;
`trace.counters()` reads it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .params import FieldParams

OPS = {"mont_mul": 0, "add": 1, "sub": 2, "neg": 3}
LAUNCHES = {op: 0 for op in OPS}


def reset_counts() -> None:
    for op in LAUNCHES:
        LAUNCHES[op] = 0


@functools.lru_cache(maxsize=None)
def consts(fp: FieldParams):
    """(p words, -p^-1 mod 2^32, R mod p words) as ctypes arrays."""
    n32 = fp.nl // 2
    words = lambda v: (ctypes.c_uint32 * n32)(
        *[(v >> (32 * i)) & 0xFFFFFFFF for i in range(n32)])
    np0 = (-pow(fp.p, -1, 1 << 32)) % (1 << 32)
    return words(fp.p), np0, words(fp.one_mont)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("field_ops")
    lib.snark_field_op.restype = ctypes.c_int
    lib.snark_field_op.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p]
    return lib


def launch(op: str, fp: FieldParams, a: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """out = op(a[, b]) elementwise over (NL, *batch) int32 limb tensors.

    Both operands must be CUDA, int32, contiguous and of one shape (the
    caller broadcasts).  A launch error raises.
    """
    args = (a,) if b is None else (a, b)
    for t in args:
        if t.device.type != "cuda" or t.dtype != torch.int32:
            raise ValueError("K-field takes int32 CUDA tensors")
        if not t.is_contiguous() or t.shape != a.shape:
            raise ValueError("K-field operands must be contiguous, one shape")
    if a.shape[0] != fp.nl:
        raise ValueError(f"limb axis {a.shape[0]} != {fp.nl}")
    out = torch.empty_like(a)
    B = a.numel() // fp.nl
    if B == 0:
        return out
    p32, np0, one32 = consts(fp)
    err = _lib().snark_field_op(
        OPS[op], fp.nl // 2, a.data_ptr(), (b if b is not None else a).data_ptr(),
        out.data_ptr(), B, ctypes.cast(p32, ctypes.c_void_p), np0,
        ctypes.cast(one32, ctypes.c_void_p), _build.stream_ptr(a.device))
    _build.check(err, f"K-field {op}")
    LAUNCHES[op] += 1
    return out
