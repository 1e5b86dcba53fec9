""".r1cs constraint files (iden3 r1csfile format v1).

Sections: 1 = header {n8, prime, nWires, nPubOut, nPubIn, nPrvIn,
nLabels: u64, nConstraints}, 2 = constraints (A,B,C linear combinations per
constraint, each: u32 nEntries + nEntries x {u32 wireId, n8-byte plain LE
value}), 3 = wire-to-label map (u64 per wire).

Constraints are parsed into flat numpy arrays (matrix id, constraint id,
signal id, value limbs) — the same flattened triple-list the reference setup
builds (reference src/zkey_new.js:203-300) and the natural device layout for
segment-sum QAP evaluation.  (Own copy of snarkjs_tpu/formats/r1cs.py.)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from .binfile import BinFile


@dataclass
class R1cs:
    n8: int
    prime: int
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    n_constraints: int
    # flat entries across all constraints
    m: np.ndarray        # (E,) int32: 0=A, 1=B, 2=C
    c: np.ndarray        # (E,) int32 constraint index
    s: np.ndarray        # (E,) int32 signal index
    vals: np.ndarray     # (NL, E) uint32 plain-form values
    map: np.ndarray | None = None  # (nWires,) uint64 labels

    @property
    def n_public(self):
        return self.n_pub_out + self.n_pub_in


def read_r1cs(path_or_bytes, load_map: bool = True) -> R1cs:
    bf = (BinFile.load(path_or_bytes, "r1cs")
          if isinstance(path_or_bytes, str) else BinFile(path_or_bytes, "r1cs"))
    r = bf.reader(1)
    n8 = r.u32()
    prime = r.big(n8)
    n_wires = r.u32()
    n_pub_out = r.u32()
    n_pub_in = r.u32()
    n_prv_in = r.u32()
    n_labels = r.u64()
    n_constraints = r.u32()

    fr_nl = n8 * 8 // 16

    data = bf.read_section(2)
    raw = np.frombuffer(data, dtype=np.uint8)
    entry_sz = 4 + n8
    # walk the headers (u32 nEntries before each of a constraint's A, B, C)
    # on the host, then cut every entry out of the section at once
    unpack = struct.Struct("<I").unpack_from
    counts, pos = [], 0
    for _ in range(3 * n_constraints):
        ne = unpack(data, pos)[0]
        counts.append(ne)
        pos += 4 + ne * entry_sz
    counts = np.array(counts, dtype=np.int64)
    heads = np.cumsum(4 + counts * entry_sz) - (4 + counts * entry_sz)
    is_entry = np.ones(pos, dtype=bool)
    is_entry[(heads[:, None] + np.arange(4)).ravel()] = False
    block = raw[:pos][is_entry].reshape(-1, entry_sz)
    lc = np.repeat(np.arange(3 * n_constraints, dtype=np.int64), counts)
    m = (lc % 3).astype(np.int32)
    c = (lc // 3).astype(np.int32)
    s = np.ascontiguousarray(block[:, :4]).view("<u4").ravel().astype(np.int32)
    u16 = np.ascontiguousarray(block[:, 4:]).view("<u2").reshape(len(lc), fr_nl)
    vals = np.ascontiguousarray(u16.T).astype(np.uint32)

    wmap = None
    if load_map and 3 in bf.sections:
        wmap = np.frombuffer(bf.read_section(3), dtype="<u8").copy()

    return R1cs(n8=n8, prime=prime, n_wires=n_wires, n_pub_out=n_pub_out,
                n_pub_in=n_pub_in, n_prv_in=n_prv_in, n_labels=n_labels,
                n_constraints=n_constraints, m=m, c=c, s=s, vals=vals, map=wmap)


def check_witness(r1cs: R1cs, witness_vals: np.ndarray, fr) -> bool:
    """Re-evaluate every constraint A*B - C == 0 against a witness
    (reference src/wtns_check.js:26-150).  Host bigint exact."""
    from ..fields import ftorch

    w = ftorch.np_to_ints(fr, witness_vals)
    vals = ftorch.np_to_ints(fr, r1cs.vals)
    p = fr.p
    sums = {}
    for mi, ci, si, v in zip(r1cs.m, r1cs.c, r1cs.s, vals):
        key = (int(mi), int(ci))
        sums[key] = (sums.get(key, 0) + v * w[int(si)]) % p
    for ci in range(r1cs.n_constraints):
        a = sums.get((0, ci), 0)
        b = sums.get((1, ci), 0)
        cc = sums.get((2, ci), 0)
        if (a * b - cc) % p != 0:
            return False
    return True
