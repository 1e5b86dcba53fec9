"""Vectorized codecs between ffjavascript point/field byte layouts and
limb-major device arrays.

ffjavascript conventions (wasmcurves reprs, observed via reference
src/zkey_utils.js:183-205 writeG1/readG1 using toRprLEM/fromRprLEM):

* ``LEM``: little-endian Montgomery — each Fq coordinate is n8 LE bytes of
  x*R mod q.  G1 = x||y (2*n8 bytes); G2 = x.c0||x.c1||y.c0||y.c1.
  The point at infinity is encoded as all-zero coordinates.
* ``uncompressed`` (used for hashing/transcripts): big-endian standard form.
* Fr values in .wtns are plain LE; zkey section-4 coefficients are stored as
  value*R^2 (reference src/zkey_utils.js:174-179).
"""

from __future__ import annotations

import numpy as np

from ..fields.params import FieldParams


def frs_from_bytes(fp: FieldParams, data: bytes, n: int) -> np.ndarray:
    """n consecutive LE field values -> (NL, n) uint32 limb array."""
    u16 = np.frombuffer(data, dtype="<u2", count=n * fp.nl).reshape(n, fp.nl)
    return np.ascontiguousarray(u16.T).astype(np.uint32)


def frs_to_bytes(fp: FieldParams, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    n = arr.shape[1] if arr.ndim > 1 else 1
    u16 = arr.reshape(fp.nl, n).T.astype("<u2")
    return np.ascontiguousarray(u16).tobytes()


def g1_lem_from_bytes(fq: FieldParams, data: bytes, n: int):
    """G1 LEM section -> ((NL,n) x, (NL,n) y, (n,) inf mask), Montgomery."""
    u16 = np.frombuffer(data, dtype="<u2", count=n * 2 * fq.nl).reshape(n, 2, fq.nl)
    x = np.ascontiguousarray(u16[:, 0, :].T).astype(np.uint32)
    y = np.ascontiguousarray(u16[:, 1, :].T).astype(np.uint32)
    inf = (x == 0).all(axis=0) & (y == 0).all(axis=0)
    return x, y, inf


def g1_lem_to_bytes(fq: FieldParams, x: np.ndarray, y: np.ndarray,
                    inf: np.ndarray) -> bytes:
    n = x.shape[1]
    u16 = np.zeros((n, 2, fq.nl), dtype="<u2")
    mask = ~np.asarray(inf)
    u16[mask, 0, :] = np.asarray(x).T[mask]
    u16[mask, 1, :] = np.asarray(y).T[mask]
    return np.ascontiguousarray(u16).tobytes()


def g2_lem_from_bytes(fq: FieldParams, data: bytes, n: int):
    """G2 LEM section -> ((x0,x1),(y0,y1), inf) limb arrays, Montgomery."""
    u16 = np.frombuffer(data, dtype="<u2", count=n * 4 * fq.nl).reshape(n, 4, fq.nl)
    c = [np.ascontiguousarray(u16[:, i, :].T).astype(np.uint32) for i in range(4)]
    inf = np.ones(n, dtype=bool)
    for arr in c:
        inf &= (arr == 0).all(axis=0)
    return (c[0], c[1]), (c[2], c[3]), inf


def g2_lem_to_bytes(fq: FieldParams, x, y, inf) -> bytes:
    n = x[0].shape[1]
    u16 = np.zeros((n, 4, fq.nl), dtype="<u2")
    mask = ~np.asarray(inf)
    for i, arr in enumerate((x[0], x[1], y[0], y[1])):
        u16[mask, i, :] = np.asarray(arr).T[mask]
    return np.ascontiguousarray(u16).tobytes()


# ---- host (bigint) <-> bytes ----

def g1_lem_from_ints(fq: FieldParams, pts) -> bytes:
    """list of affine int pairs (or None) -> LEM bytes."""
    out = bytearray()
    for p in pts:
        if p is None:
            out += b"\0" * (2 * fq.n8)
        else:
            out += fq.to_bytes(fq.to_mont(p[0]))
            out += fq.to_bytes(fq.to_mont(p[1]))
    return bytes(out)


def g1_lem_to_ints(fq: FieldParams, data: bytes, n: int):
    pts = []
    for i in range(n):
        xo = int.from_bytes(data[i * 2 * fq.n8 : i * 2 * fq.n8 + fq.n8], "little")
        yo = int.from_bytes(data[i * 2 * fq.n8 + fq.n8 : (i + 1) * 2 * fq.n8], "little")
        if xo == 0 and yo == 0:
            pts.append(None)
        else:
            pts.append((fq.from_mont(xo), fq.from_mont(yo)))
    return pts


def g2_lem_from_ints(fq: FieldParams, pts) -> bytes:
    out = bytearray()
    for p in pts:
        if p is None:
            out += b"\0" * (4 * fq.n8)
        else:
            for c in (p[0][0], p[0][1], p[1][0], p[1][1]):
                out += fq.to_bytes(fq.to_mont(c))
    return bytes(out)


def g2_lem_to_ints(fq: FieldParams, data: bytes, n: int):
    pts = []
    s = 4 * fq.n8
    for i in range(n):
        cs = [int.from_bytes(data[i * s + j * fq.n8 : i * s + (j + 1) * fq.n8],
                             "little") for j in range(4)]
        if all(c == 0 for c in cs):
            pts.append(None)
        else:
            cs = [fq.from_mont(c) for c in cs]
            pts.append(((cs[0], cs[1]), (cs[2], cs[3])))
    return pts


def g1_uncompressed_be(fq: FieldParams, p) -> bytes:
    """Affine int pair -> big-endian uncompressed (for transcripts/hashing)."""
    if p is None:
        return b"\0" * (2 * fq.n8)
    return int(p[0]).to_bytes(fq.n8, "big") + int(p[1]).to_bytes(fq.n8, "big")


def g2_uncompressed_be(fq: FieldParams, p) -> bytes:
    """Big-endian F2 reprs swap components (c1 || c0), matching
    ffjavascript F2.toRprBE / Bellman G2Uncompressed so ceremony challenge
    files and transcript hashes interoperate (reference
    src/powersoftau_utils.js:124-155 toPtauPubKeyRpr via G2.toRprUncompressed).
    """
    if p is None:
        return b"\0" * (4 * fq.n8)
    out = b""
    for c in (p[0][1], p[0][0], p[1][1], p[1][0]):
        out += int(c).to_bytes(fq.n8, "big")
    return out


def g2_u_to_ints(fq: FieldParams, b: bytes):
    """Uncompressed BE G2 -> affine int pairs ((x0,x1),(y0,y1))."""
    n8 = fq.n8
    c = [int.from_bytes(b[i * n8:(i + 1) * n8], "big") for i in range(4)]
    if all(v == 0 for v in c):
        return None
    return ((c[1], c[0]), (c[3], c[2]))
