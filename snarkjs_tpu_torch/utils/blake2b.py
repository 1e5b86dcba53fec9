"""BLAKE2b-512 with midstate export and import (port of
snarkjs_tpu/utils/blake2b.py).

Every ceremony contribution stores a 216-byte BLAKE2b midstate (reference
src/misc.js:89-127 toPartialHash/fromPartialHash over @noble/hashes
internals), so the response hash can be finished later with the public key
appended.  hashlib cannot export a state, so this class keeps the noble
layout itself: the 128-byte pending buffer, the 8 x 64-bit h state as (lo,
hi) u32 pairs, the count of compressed bytes and the buffer position.  The
compression runs in host C++ (`csrc/blake2b.cpp`, built with g++ at first use
by `_build.host_library`); a failed build raises.

Streams that never export a midstate use `hashlib.blake2b` directly.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from .. import _build

IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.host_library("blake2b")
    lib.snark_blake2b_update.restype = None
    lib.snark_blake2b_update.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint64]
    lib.snark_blake2b_final.restype = None
    lib.snark_blake2b_final.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_void_p]
    return lib


class Blake2b:
    """Unkeyed BLAKE2b of digest_size bytes (default 64)."""

    def __init__(self, digest_size: int = 64):
        self.digest_size = digest_size
        self._h = (ctypes.c_uint64 * 8)(*IV)
        self._h[0] ^= 0x01010000 ^ digest_size
        self._buf = (ctypes.c_uint8 * 128)()
        self._comp = ctypes.c_uint64(0)   # bytes compressed so far
        self._pos = ctypes.c_uint32(0)    # bytes pending in the buffer
        _lib()

    def update(self, data) -> "Blake2b":
        """Absorb bytes (any buffer).  A full buffer is compressed only once
        more input arrives, as @noble/hashes does."""
        arr = np.frombuffer(data, dtype=np.uint8)
        if arr.size:
            _lib().snark_blake2b_update(
                ctypes.addressof(self._h), ctypes.addressof(self._buf),
                ctypes.addressof(self._comp), ctypes.addressof(self._pos),
                arr.ctypes.data, arr.size)
        return self

    def digest(self) -> bytes:
        out = (ctypes.c_uint8 * 64)()
        _lib().snark_blake2b_final(ctypes.addressof(self._h), ctypes.addressof(self._buf),
                                   self._comp.value, self._pos.value, ctypes.addressof(out))
        return bytes(out)[:self.digest_size]

    # ---- 216-byte midstate (reference src/misc.js:89-127 layout) ----

    def to_partial(self) -> bytes:
        u32 = []
        for v in self._h:
            u32 += [v & 0xFFFFFFFF, v >> 32]
        comp = self._comp.value
        u32 += [comp & 0xFFFFFFFF, comp >> 32, self._pos.value, 0]
        return bytes(self._buf) + struct.pack("<20I", *u32) + bytes(8)

    @classmethod
    def from_partial(cls, partial: bytes) -> "Blake2b":
        if len(partial) < 208:
            raise ValueError("a BLAKE2b midstate has 216 bytes")
        h = cls()
        ctypes.memmove(h._buf, bytes(partial[0:128]), 128)
        u32 = struct.unpack("<20I", partial[128:208])
        for i in range(8):
            h._h[i] = u32[2 * i] | (u32[2 * i + 1] << 32)
        h._comp.value = u32[16] | (u32[17] << 32)
        h._pos.value = u32[18]
        return h
