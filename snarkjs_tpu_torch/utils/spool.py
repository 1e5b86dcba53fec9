"""Bounded-memory section buffers (port of snarkjs_tpu/utils/spool.py).

The reference keeps ceremony memory bounded by processing chunks straight
between files (reference src/mpc_applykey.js:30-47,
src/powersoftau_contribute.js:129-153).  Here whole sections go to the card
in batches; this module keeps the host side bounded: section outputs larger
than a threshold spill to an anonymous temp file and are handed around as a
read-only mmap (page cache the OS can reclaim).
"""

from __future__ import annotations

import mmap
import os
import tempfile

SPOOL_THRESHOLD = 256 * 1024 * 1024


class SpooledOut:
    """Append-only byte sink; spills to a temp file beyond the threshold.

    finish() returns bytes (small) or a read-only memoryview of an mmap
    (large).  The backing file is unlinked at once, so the mapping is its
    only reference.
    """

    def __init__(self, threshold: int = SPOOL_THRESHOLD):
        self.threshold = threshold
        self._buf = bytearray()
        self._file = None
        self._size = 0

    def write(self, b):
        self._size += len(b)
        if self._file is None:
            self._buf.extend(b)
            if len(self._buf) > self.threshold:
                self._spill()
        else:
            self._file.write(b)

    def _spill(self):
        fd, path = tempfile.mkstemp(prefix="snarkjs_spool_")
        self._file = os.fdopen(fd, "wb+")
        os.unlink(path)
        self._file.write(self._buf)
        self._buf = bytearray()

    def finish(self):
        if self._file is None:
            return bytes(self._buf)
        self._file.flush()
        mm = mmap.mmap(self._file.fileno(), self._size, access=mmap.ACCESS_READ)
        self._file.close()
        self._file = None
        return memoryview(mm)
