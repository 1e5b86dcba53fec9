""".wtns witness files (reference src/wtns_utils.js:25-91).

Sections: 1 = header {n8: ULE32, prime: n8 LE bytes, nWitness: ULE32},
2 = nWitness plain-form LE field values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields.params import FieldParams
from . import points
from .binfile import BinFile, BinFileWriter, SectionWriter


@dataclass
class Witness:
    n8: int
    q: int
    n: int
    values: np.ndarray  # (NL, n) uint32, PLAIN form (not Montgomery)


def read_wtns(path_or_bytes) -> Witness:
    bf = (BinFile.load(path_or_bytes, "wtns")
          if isinstance(path_or_bytes, str) else BinFile(path_or_bytes, "wtns"))
    r = bf.reader(1)
    n8 = r.u32()
    q = r.big(n8)
    n = r.u32()
    data = bf.read_section(2)
    from ..fields.params import LIMB_BITS

    class _FP:  # minimal param shim for codec (n8 may differ from known fields)
        pass

    fp = _FP()
    fp.nl = n8 * 8 // LIMB_BITS
    fp.n8 = n8
    vals = points.frs_from_bytes(fp, data, n)
    return Witness(n8=n8, q=q, n=n, values=vals)


def write_wtns(fp: FieldParams, values: np.ndarray) -> bytes:
    """values: (NL, n) plain-form limb array."""
    n = values.shape[1]
    w = BinFileWriter("wtns", 2)
    h = SectionWriter()
    h.u32(fp.n8)
    h.big(fp.p, fp.n8)
    h.u32(n)
    w.add_section(1, h.tobytes())
    w.add_section(2, points.frs_to_bytes(fp, values))
    return w.tobytes()
