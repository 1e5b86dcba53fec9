"""Witness calculator for circom-compiled circuit WASM (port of
snarkjs_tpu/wasm/witness_calculator.py).

Host-side code implementing the exact calculator protocols of
circom_runtime (reference src/wtns_calculate.js:27-50; circom2 protocol
inlined at build/browser.esm.js:3224-3373, circom1 at :3050-3223):
fnv1a-64 signal-name hashing, shared-RW-memory word shuttling, and .wtns
binary emission.

The caller picks the VM: `vm="native"` (the default, `csrc/wasmvm.cpp`
through `native.py`; a failed build raises) or `vm="python"`
(`interp.py`).  Debug-logging hooks need the Python VM, so passing `hooks`
selects it.  Both give the same witness and the same trap messages.
"""

from __future__ import annotations

from . import interp

VMS = ("native", "python")


def fnv_hash(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s:
        h ^= ord(ch)
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def flat_array(v):
    out = []

    def fill(x):
        if isinstance(x, (list, tuple)):
            for e in x:
                fill(e)
        else:
            out.append(x)

    fill(v)
    return out


class WitnessCalculator:
    def __init__(self, wasm_bytes: bytes, sanity_check: bool = False,
                 hooks: dict | None = None, vm: str = "native"):
        """hooks (reference src/wtns_debug.js:29-72 logging options): dict
        with optional callables 'get'(sig_id, value), 'set'(sig_id, value),
        'start'(comp_id), 'finish'(comp_id); given hooks run the Python VM.
        vm: "native" (C++, the default) or "python"."""
        if vm not in VMS:
            raise ValueError(f"unknown WASM VM {vm!r}: use one of {VMS}")
        self.err_parts = []
        self.msg_parts = []
        self.hooks = hooks or {}
        m = interp.Module(wasm_bytes)
        self._mod = m
        self.vm = "python" if self.hooks else vm
        if self.vm == "native":
            from . import native

            self.inst = native.NativeInstance(wasm_bytes)
        else:
            host = {
                ("runtime", "printDebug"): lambda v: None,
                ("runtime", "exceptionHandler"): self._exception,
                ("runtime", "printErrorMessage"): self._print_error,
                ("runtime", "writeBufferMessage"): self._write_buffer,
                ("runtime", "showSharedRWMemory"): self._show_shared,
                # circom1 runtime imports
                ("runtime", "error"): self._c1_error,
                ("runtime", "log"): lambda a: None,
                ("runtime", "logGetSignal"): self._log_get,
                ("runtime", "logSetSignal"): self._log_set,
                ("runtime", "logStartComponent"): self._log_start,
                ("runtime", "logFinishComponent"): self._log_finish,
                ("env", "memory"): None,
            }
            self.inst = interp.Instance(m, host)
            if m.mem_pages and len(self.inst.mem) < (1 << 28):
                # circom expects the host-supplied big imported memory
                self.inst.mem.extend(
                    b"\0" * ((1 << 28) - len(self.inst.mem)))

        self.version = (self.inst.invoke("getVersion")
                        if "getVersion" in m.exports else 1)
        self.sanity_check = sanity_check
        if self.version == 2:
            self.n32 = self.inst.invoke("getFieldNumLen32")
            self.inst.invoke("getRawPrime")
            self.prime = self._read_shared_big()
            self.witness_size = self.inst.invoke("getWitnessSize")
        elif self.version == 1:
            self.n32 = (self.inst.invoke("getFrLen") >> 2) - 2
            praw = self.inst.invoke("getPRawPrime")
            self.prime = int.from_bytes(
                self.inst.mem[praw:praw + self.n32 * 4], "little")
            self.witness_size = self.inst.invoke("getNVars")
            bitlen = self.prime.bit_length()
            self.n64 = (bitlen - 1) // 64 + 1
            self.R = (1 << (self.n64 * 64)) % self.prime
            self.Rinv = pow(self.R, self.prime - 2, self.prime)
        else:
            raise ValueError(f"Unsupported circom version: {self.version}")

    # ---- host imports ----
    def _log_get(self, sig, pval):
        h = self.hooks.get("get")
        if h:
            h(sig, self._c1_get_fr(pval))

    def _log_set(self, sig, pval):
        h = self.hooks.get("set")
        if h:
            h(sig, self._c1_get_fr(pval))

    def _log_start(self, comp):
        h = self.hooks.get("start")
        if h:
            h(comp)

    def _log_finish(self, comp):
        h = self.hooks.get("finish")
        if h:
            h(comp)

    def _exception(self, code):
        errs = {1: "Signal not found. ", 2: "Too many signals set. ",
                3: "Signal already set. ", 4: "Assert Failed. ",
                5: "Not enough memory. ",
                6: "Input signal array access exceeds the size. "}
        raise interp.Trap(errs.get(code, "Unknown error. ")
                          + "".join(self.err_parts))

    def _get_message(self) -> str:
        out = []
        c = self.inst.invoke("getMessageChar")
        while c:
            out.append(chr(c))
            c = self.inst.invoke("getMessageChar")
        return "".join(out)

    def _print_error(self):
        self.err_parts.append(self._get_message() + "\n")

    def _write_buffer(self):
        self.msg_parts.append(self._get_message())

    def _show_shared(self):
        pass  # log() output — ignored

    def _c1_error(self, code, pstr, a, b, c, d):
        mem = self.inst.mem
        msg = bytearray()
        i = pstr
        while mem[i]:
            msg.append(mem[i])
            i += 1
        raise interp.Trap(f"circuit error {code}: {msg.decode()} "
                          f"{a} {b} {c} {d}")

    # ---- shared memory helpers (circom2) ----
    def _read_shared_big(self) -> int:
        acc = 0
        for i in range(self.n32):
            acc |= self.inst.invoke("readSharedRWMemory", i) << (32 * i)
        return acc

    # ---- input loading ----
    def _set_inputs(self, input_map: dict, sanity_check: bool):
        self.inst.invoke("init", 1 if (self.sanity_check or sanity_check)
                         else 0)
        count = 0
        if self.version == 2:
            for k, v in input_map.items():
                h = fnv_hash(k)
                h_msb, h_lsb = h >> 32, h & 0xFFFFFFFF
                arr = flat_array(v)
                if "getInputSignalSize" in self._mod.exports:
                    size = self.inst.invoke("getInputSignalSize", h_msb,
                                            h_lsb)
                    if interp._s32(size) < 0:
                        raise ValueError(f"Signal {k} not found")
                    if len(arr) != interp._s32(size):
                        raise ValueError(
                            f"Wrong number of values for input signal {k}")
                for i, val in enumerate(arr):
                    fv = int(val) % self.prime
                    for j in range(self.n32):
                        self.inst.invoke("writeSharedRWMemory", j,
                                         (fv >> (32 * j)) & 0xFFFFFFFF)
                    self.inst.invoke("setInputSignal", h_msb, h_lsb, i)
                    count += 1
            if count < self.inst.invoke("getInputSize"):
                raise ValueError(
                    f"Not all inputs have been set. Only {count} out of "
                    f"{self.inst.invoke('getInputSize')}")
            return

        # circom1 (build/browser.esm.js:3081-3101)
        i32 = self.inst.mem

        def alloc(nbytes):
            p = int.from_bytes(i32[0:4], "little")
            i32[0:4] = (p + nbytes).to_bytes(4, "little")
            return p

        p_sig = alloc(8)
        p_fr = alloc(self.n32 * 4 + 8)
        for k, v in input_map.items():
            h = fnv_hash(k)
            h_msb, h_lsb = h >> 32, h & 0xFFFFFFFF
            self.inst.invoke("getSignalOffset32", p_sig, 0, h_msb, h_lsb)
            sig_off = int.from_bytes(i32[p_sig:p_sig + 4], "little")
            for i, val in enumerate(flat_array(v)):
                self._c1_set_fr(p_fr, int(val) % self.prime)
                self.inst.invoke("setSignal", 0, 0, sig_off + i, p_fr)

    def _c1_set_fr(self, p, v):
        mem = self.inst.mem
        if v < 0x80000000:
            mem[p:p + 4] = v.to_bytes(4, "little")
            mem[p + 4:p + 8] = b"\0\0\0\0"
            return
        neg = v - self.prime  # v normalized to [0, prime)
        if -0x80000000 <= neg < 0:
            mem[p:p + 4] = (neg + (1 << 32)).to_bytes(4, "little")
            mem[p + 4:p + 8] = b"\0\0\0\0"
            return
        mem[p:p + 4] = b"\0\0\0\0"
        mem[p + 4:p + 8] = (0x80000000).to_bytes(4, "little")
        mem[p + 8:p + 8 + self.n32 * 4] = v.to_bytes(self.n32 * 4, "little")

    def _c1_get_fr(self, p) -> int:
        mem = self.inst.mem
        flags = int.from_bytes(mem[p + 4:p + 8], "little")
        if flags & 0x80000000:
            v = int.from_bytes(mem[p + 8:p + 8 + self.n32 * 4], "little")
            if flags & 0x40000000:
                v = v * self.Rinv % self.prime
            return v % self.prime
        v = int.from_bytes(mem[p:p + 4], "little")
        if v & 0x80000000:
            v -= 1 << 32
        return v % self.prime

    def _read_witness(self) -> list[int]:
        """circom2: every witness value, one getWitness and n32
        readSharedRWMemory calls each."""
        out = []
        for i in range(self.witness_size):
            self.inst.invoke("getWitness", i)
            out.append(self._read_shared_big())
        return out

    # ---- public API ----
    def calculate_witness(self, input_map: dict,
                          sanity_check: bool = False) -> list[int]:
        if self.version == 2:
            self._set_inputs(input_map, sanity_check)
            return self._read_witness()
        old0 = bytes(self.inst.mem[0:4])
        self._set_inputs(input_map, sanity_check)
        out = []
        for i in range(self.witness_size):
            p = self.inst.invoke("getPWitness", i)
            out.append(self._c1_get_fr(p))
        self.inst.mem[0:4] = old0
        return out

    def calculate_wtns_bin(self, input_map: dict,
                           sanity_check: bool = False) -> bytes:
        """Witness as .wtns file bytes (circom2 calculateWTNSBin layout,
        build/browser.esm.js:3308-3371)."""
        return wtns_bytes(self.prime, self.n32,
                          self.calculate_witness(input_map, sanity_check))


def wtns_bytes(prime: int, n32: int, witness: list[int]) -> bytes:
    """The .wtns file of a witness computed over `prime`."""
    from ..fields import ftorch
    from ..formats import wtns as wtns_fmt

    fp = _field_for(prime, n32 * 4)
    return wtns_fmt.write_wtns(fp, ftorch.np_from_ints(fp, witness))


def _field_for(prime: int, n8: int):
    from ..fields.params import BLS12_381_FR, BN254_FR, FieldParams

    if prime == BN254_FR.p:
        return BN254_FR
    if prime == BLS12_381_FR.p:
        return BLS12_381_FR
    return FieldParams(f"fr_{prime % 100000}", prime, n8)


def calculate_wtns(input_map: dict, wasm_path_or_bytes,
                   sanity_check: bool = False, vm: str = "native") -> bytes:
    """wtnsCalculate equivalent (reference src/wtns_calculate.js:27-50):
    returns .wtns bytes for the given input."""
    if isinstance(wasm_path_or_bytes, str):
        with open(wasm_path_or_bytes, "rb") as f:
            wasm_path_or_bytes = f.read()
    wc = WitnessCalculator(wasm_path_or_bytes, vm=vm)
    return wc.calculate_wtns_bin(input_map, sanity_check)
