"""iden3 binfile container: read/write.

Layout (reference: @iden3/binfileutils, inlined at
reference build/browser.esm.js:937-1067):

    magic:    4 ASCII bytes (file type, e.g. "zkey", "wtns", "ptau", "r1cs")
    version:  ULE32
    nSections:ULE32
    sections: nSections x { type: ULE32, size: ULE64, payload: size bytes }

Sections may appear in any order and a type may repeat; readers address them
by type id.  This implementation is host-side (numpy/bytes) — artifacts are
streamed section-by-section to the device by the protocol layers.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass


@dataclass
class Section:
    pos: int
    size: int


class BinFile:
    """Random-access reader over bytes (memory-mapped files work too)."""

    def __init__(self, data, expected_type: str | None = None,
                 max_version: int = 2):
        self.data = data
        magic = bytes(data[0:4])
        if expected_type is not None and magic != expected_type.encode():
            raise ValueError(
                f"invalid file magic {magic!r}, expected {expected_type!r}")
        self.ftype = magic.decode("latin1")
        self.version = struct.unpack_from("<I", data, 4)[0]
        if self.version > max_version:
            raise ValueError(f"version {self.version} not supported")
        n_sections = struct.unpack_from("<I", data, 8)[0]
        self.sections: dict[int, list[Section]] = {}
        pos = 12
        for _ in range(n_sections):
            stype = struct.unpack_from("<I", data, pos)[0]
            ssize = struct.unpack_from("<Q", data, pos + 4)[0]
            pos += 12
            self.sections.setdefault(stype, []).append(Section(pos, ssize))
            pos += ssize

    @classmethod
    def load(cls, path: str, expected_type: str | None = None,
             max_version: int = 2) -> "BinFile":
        """Memory-map the file: reading a 97 GB power-28 ptau costs page
        cache, not RSS (the reference's fastfile streaming analogue)."""
        import mmap

        f = open(path, "rb")
        try:
            data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            data = f.read()       # empty or unmappable file
            f.close()
            return cls(data, expected_type, max_version)
        bf = cls(data, expected_type, max_version)
        bf._file = f              # keep the fd alive with the mapping
        return bf

    def view_section(self, stype: int, idx: int = 0):
        """Zero-copy view of a section payload."""
        s = self.section(stype, idx)
        return memoryview(self.data)[s.pos:s.pos + s.size]

    def section(self, stype: int, idx: int = 0) -> Section:
        if stype not in self.sections or idx >= len(self.sections[stype]):
            raise KeyError(f"section {stype}[{idx}] missing")
        return self.sections[stype][idx]

    def read_section(self, stype: int, idx: int = 0) -> bytes:
        s = self.section(stype, idx)
        return bytes(self.data[s.pos : s.pos + s.size])

    def reader(self, stype: int, idx: int = 0) -> "SectionReader":
        s = self.section(stype, idx)
        return SectionReader(self.data, s.pos, s.size)


class SectionReader:
    def __init__(self, data, pos, size):
        self.data = data
        self.pos = pos
        self.end = pos + size

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def big(self, n8: int) -> int:
        v = int.from_bytes(self.data[self.pos : self.pos + n8], "little")
        self.pos += n8
        return v

    def raw(self, n: int) -> bytes:
        v = bytes(self.data[self.pos : self.pos + n])
        self.pos += n
        return v

    def remaining(self) -> int:
        return self.end - self.pos


class BinFileWriter:
    """Section-list writer.  Payloads may be bytes OR buffer views
    (memoryview / mmap, e.g. SpooledOut.finish() results), which are
    never copied until written — `save` streams them to disk in bounded
    chunks, so a multi-GB artifact needs no whole-file RAM image
    (reference binfileutils startWriteSection/endWriteSection,
    build/browser.esm.js:983-1001)."""

    _CHUNK = 16 * 1024 * 1024

    def __init__(self, ftype: str, version: int = 1):
        self.ftype = ftype
        self.version = version
        self.chunks: list[tuple[int, object]] = []

    def add_section(self, stype: int, payload):
        self.chunks.append((stype, payload))

    def _header(self) -> bytes:
        return (self.ftype.encode()[:4].ljust(4, b"\0")
                + struct.pack("<I", self.version)
                + struct.pack("<I", len(self.chunks)))

    def tobytes(self) -> bytes:
        out = io.BytesIO()
        out.write(self._header())
        for stype, payload in self.chunks:
            out.write(struct.pack("<I", stype))
            out.write(struct.pack("<Q", len(payload)))
            out.write(payload)
        return out.getvalue()

    def save(self, path: str):
        import mmap as _mmap

        with open(path, "wb") as f:
            f.write(self._header())
            for stype, payload in self.chunks:
                f.write(struct.pack("<I", stype))
                f.write(struct.pack("<Q", len(payload)))
                mv = memoryview(payload)
                mm = payload if isinstance(payload, _mmap.mmap) else (
                    mv.obj if isinstance(mv.obj, _mmap.mmap) else None)
                for off in range(0, len(mv), self._CHUNK):
                    f.write(mv[off:off + self._CHUNK])
                    if mm is not None and hasattr(mm, "madvise"):
                        # spool-backed pages are dropped as they stream
                        # out, so peak RSS stays O(chunk) for any size
                        mm.madvise(_mmap.MADV_DONTNEED, off,
                                   min(self._CHUNK, len(mv) - off))


class StreamingBinFileWriter:
    """True streaming writer: open -> start_section/write.../end_section
    -> close.  Section sizes are patched after the payload streams out,
    so producer code can emit device chunks straight to disk with O(chunk)
    memory at any artifact size (the reference's 2^28 / ~97 GB regime,
    reference src/mpc_applykey.js:30-47)."""

    def __init__(self, path: str, ftype: str, version: int = 1,
                 n_sections: int | None = None):
        self.f = open(path, "wb")
        self.f.write(ftype.encode()[:4].ljust(4, b"\0"))
        self.f.write(struct.pack("<I", version))
        self._nsec_pos = self.f.tell()
        self.f.write(struct.pack("<I", n_sections or 0))
        self._n = 0
        self._size_pos = None

    def start_section(self, stype: int):
        assert self._size_pos is None, "previous section still open"
        self.f.write(struct.pack("<I", stype))
        self._size_pos = self.f.tell()
        self.f.write(struct.pack("<Q", 0))

    def write(self, b):
        assert self._size_pos is not None, "no open section"
        self.f.write(b)

    def end_section(self):
        end = self.f.tell()
        size = end - self._size_pos - 8
        self.f.seek(self._size_pos)
        self.f.write(struct.pack("<Q", size))
        self.f.seek(end)
        self._size_pos = None
        self._n += 1

    def close(self):
        assert self._size_pos is None, "section still open"
        self.f.seek(self._nsec_pos)
        self.f.write(struct.pack("<I", self._n))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self.f.closed:
            self.close()


class SectionWriter:
    """Helper to build a section payload."""

    def __init__(self):
        self.buf = io.BytesIO()

    def u32(self, v: int):
        self.buf.write(struct.pack("<I", v))

    def u64(self, v: int):
        self.buf.write(struct.pack("<Q", v))

    def big(self, v: int, n8: int):
        self.buf.write(int(v).to_bytes(n8, "little"))

    def raw(self, b: bytes):
        self.buf.write(b)

    def tobytes(self) -> bytes:
        return self.buf.getvalue()
