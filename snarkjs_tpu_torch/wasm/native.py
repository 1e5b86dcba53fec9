"""ctypes binding of the native C++ WASM VM (`csrc/wasmvm.cpp`), the
default VM of the witness calculator (`vm="native"`).

The library is built with g++ at first use by `_build.host_library` into
`_build/`; a failed build or load raises, and nothing falls back to the
Python interpreter: the caller picks that one by argument (`vm="python"`).
`NativeInstance` has the interface of `interp.Instance` (invoke + mem), with
the same semantics, at ~100x the throughput.
"""

from __future__ import annotations

import ctypes
import functools

from .. import _build
from . import interp


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.host_library("wasmvm")
    lib.wvm_new.restype = ctypes.c_void_p
    lib.wvm_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                            ctypes.c_char_p, ctypes.c_uint64]
    lib.wvm_free.restype = None
    lib.wvm_free.argtypes = [ctypes.c_void_p]
    lib.wvm_error.restype = ctypes.c_char_p
    lib.wvm_error.argtypes = [ctypes.c_void_p]
    lib.wvm_invoke.restype = ctypes.c_int
    lib.wvm_invoke.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int)]
    lib.wvm_has_export.restype = ctypes.c_int
    lib.wvm_has_export.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.wvm_mem.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.wvm_mem.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint64)]
    return lib


class _MemProxy:
    """bytearray-compatible view over the VM's linear memory (refetched
    per access: memory.grow may reallocate the backing buffer)."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle

    def _buf(self):
        size = ctypes.c_uint64()
        ptr = self._lib.wvm_mem(self._h, ctypes.byref(size))
        return ptr, size.value

    def __len__(self):
        return self._buf()[1]

    def __getitem__(self, idx):
        ptr, size = self._buf()
        if isinstance(idx, slice):
            start, stop, step = idx.indices(size)
            if step != 1:
                raise ValueError("strided access to linear memory")
            return bytes(ctypes.string_at(
                ctypes.addressof(ptr.contents) + start, max(0, stop - start)))
        return ptr[idx]

    def __setitem__(self, idx, value):
        ptr, size = self._buf()
        if isinstance(idx, slice):
            start, stop, step = idx.indices(size)
            value = bytes(value)
            if step != 1 or len(value) != stop - start:
                raise ValueError("linear memory writes keep their length")
            ctypes.memmove(ctypes.addressof(ptr.contents) + start, value,
                           stop - start)
        else:
            ptr[idx] = value


class NativeInstance:
    """interp.Instance-compatible facade over the C++ VM."""

    def __init__(self, wasm_bytes: bytes):
        lib = _lib()
        err = ctypes.create_string_buffer(512)
        self._lib = lib
        self._h = lib.wvm_new(wasm_bytes, len(wasm_bytes), err, 512)
        if not self._h:
            raise interp.Trap(err.value.decode() or "wasm parse failed")
        self.mem = _MemProxy(lib, self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.wvm_free(h)
            self._h = None

    def invoke(self, name: str, *args):
        arr = (ctypes.c_uint64 * max(1, len(args)))(
            *[int(a) & 0xFFFFFFFFFFFFFFFF for a in args])
        res = ctypes.c_uint64()
        has = ctypes.c_int()
        rc = self._lib.wvm_invoke(self._h, name.encode(), arr, len(args),
                                  ctypes.byref(res), ctypes.byref(has))
        if rc != 0:
            raise interp.Trap(self._lib.wvm_error(self._h).decode())
        return res.value if has.value else None
