"""Minimal WebAssembly (MVP) interpreter for circom circuit binaries (own
copy of snarkjs_tpu/wasm/interp.py, same semantics and trap messages).

The reference executes circuit .wasm files through Node's native WASM VM via
the circom_runtime package (reference src/wtns_calculate.js:27-50, runtime
inlined at build/browser.esm.js:3224-3373).  The package carries its own
host-side interpreters: this one in Python (`vm="python"`, and whenever
debug-logging hooks are given) and its C++ twin `csrc/wasmvm.cpp`
(`vm="native"`).  Witness generation is O(circuit) host work off the card's
hot path; the proving math stays on the device.

Scope: i32/i64 numerics (no floats — circom emits none), linear memory,
br_table, call_indirect, globals, data segments.  Unsupported opcodes raise
immediately with their hex code.
"""

from __future__ import annotations

import struct


def _leb_u(buf, pos):
    res, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        res |= (b & 0x7F) << shift
        if not b & 0x80:
            return res, pos
        shift += 7


def _leb_s(buf, pos, bits=64):
    res, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        res |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            if b & 0x40 and shift < bits + 7:
                res |= -(1 << shift)
            return res, pos


MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def _s32(v):
    v &= MASK32
    return v - (1 << 32) if v >> 31 else v


def _s64(v):
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


class FuncType:
    __slots__ = ("params", "results")

    def __init__(self, params, results):
        self.params = params
        self.results = results


class Function:
    __slots__ = ("type_idx", "locals", "body", "name")

    def __init__(self, type_idx, locals_, body, name=""):
        self.type_idx = type_idx
        self.locals = locals_
        self.body = body
        self.name = name


class Module:
    def __init__(self, data: bytes):
        assert data[:4] == b"\0asm", "not a wasm module"
        self.types: list[FuncType] = []
        self.imports: list[tuple] = []      # (mod, name, type_idx)
        self.func_type_idx: list[int] = []
        self.funcs: list[Function] = []
        self.table: list[int] = []
        self.mem_pages = 0
        self.globals_init: list[tuple] = []  # (mutable, valtype, init)
        self.exports: dict[str, tuple] = {}
        self.data_segments: list[tuple] = []
        self.elem_segments: list[tuple] = []
        self._parse(data)

    def _parse(self, data):
        pos = 8
        n_imported = 0
        while pos < len(data):
            sec_id = data[pos]
            pos += 1
            size, pos = _leb_u(data, pos)
            end = pos + size
            p = pos
            if sec_id == 1:  # types
                cnt, p = _leb_u(data, p)
                for _ in range(cnt):
                    assert data[p] == 0x60
                    p += 1
                    np_, p = _leb_u(data, p)
                    params = list(data[p:p + np_]); p += np_
                    nr, p = _leb_u(data, p)
                    results = list(data[p:p + nr]); p += nr
                    self.types.append(FuncType(params, results))
            elif sec_id == 2:  # imports
                cnt, p = _leb_u(data, p)
                for _ in range(cnt):
                    ln, p = _leb_u(data, p)
                    mod = data[p:p + ln].decode(); p += ln
                    ln, p = _leb_u(data, p)
                    name = data[p:p + ln].decode(); p += ln
                    kind = data[p]; p += 1
                    if kind == 0:
                        ti, p = _leb_u(data, p)
                        self.imports.append((mod, name, ti))
                        n_imported += 1
                    elif kind == 2:  # memory import
                        flags, p = _leb_u(data, p)
                        mn, p = _leb_u(data, p)
                        if flags & 1:
                            _, p = _leb_u(data, p)
                        self.mem_pages = max(self.mem_pages, mn)
                    elif kind == 1:  # table import
                        p += 1
                        flags, p = _leb_u(data, p)
                        mn, p = _leb_u(data, p)
                        if flags & 1:
                            _, p = _leb_u(data, p)
                    else:  # global import
                        p += 2
            elif sec_id == 3:  # function decls
                cnt, p = _leb_u(data, p)
                for _ in range(cnt):
                    ti, p = _leb_u(data, p)
                    self.func_type_idx.append(ti)
            elif sec_id == 4:  # tables
                cnt, p = _leb_u(data, p)
                for _ in range(cnt):
                    p += 1  # elemtype
                    flags, p = _leb_u(data, p)
                    mn, p = _leb_u(data, p)
                    if flags & 1:
                        _, p = _leb_u(data, p)
                    self.table = [None] * mn
            elif sec_id == 5:  # memories
                cnt, p = _leb_u(data, p)
                for _ in range(cnt):
                    flags, p = _leb_u(data, p)
                    mn, p = _leb_u(data, p)
                    if flags & 1:
                        _, p = _leb_u(data, p)
                    self.mem_pages = max(self.mem_pages, mn)
            elif sec_id == 6:  # globals
                cnt, p = _leb_u(data, p)
                for _ in range(cnt):
                    vt = data[p]; p += 1
                    mut = data[p]; p += 1
                    val, p = self._const_expr(data, p)
                    self.globals_init.append((mut, vt, val))
            elif sec_id == 7:  # exports
                cnt, p = _leb_u(data, p)
                for _ in range(cnt):
                    ln, p = _leb_u(data, p)
                    name = data[p:p + ln].decode(); p += ln
                    kind = data[p]; p += 1
                    idx, p = _leb_u(data, p)
                    self.exports[name] = (kind, idx)
            elif sec_id == 9:  # elements
                cnt, p = _leb_u(data, p)
                for _ in range(cnt):
                    flags, p = _leb_u(data, p)
                    assert flags == 0, "only active elem segments supported"
                    off, p = self._const_expr(data, p)
                    n, p = _leb_u(data, p)
                    idxs = []
                    for _ in range(n):
                        fi, p = _leb_u(data, p)
                        idxs.append(fi)
                    self.elem_segments.append((off, idxs))
            elif sec_id == 10:  # code
                cnt, p = _leb_u(data, p)
                for i in range(cnt):
                    bsz, p = _leb_u(data, p)
                    bend = p + bsz
                    nloc, p = _leb_u(data, p)
                    locals_ = []
                    for _ in range(nloc):
                        ncnt, p = _leb_u(data, p)
                        vt = data[p]; p += 1
                        locals_ += [vt] * ncnt
                    self.funcs.append(Function(
                        self.func_type_idx[i], locals_, data[p:bend]))
                    p = bend
            elif sec_id == 11:  # data
                cnt, p = _leb_u(data, p)
                for _ in range(cnt):
                    flags, p = _leb_u(data, p)
                    assert flags == 0
                    off, p = self._const_expr(data, p)
                    n, p = _leb_u(data, p)
                    self.data_segments.append((off, data[p:p + n]))
                    p += n
            pos = end
        self.n_imported = n_imported

    @staticmethod
    def _const_expr(data, p):
        op = data[p]
        p += 1
        if op == 0x41:
            v, p = _leb_s(data, p, 32)
        elif op == 0x42:
            v, p = _leb_s(data, p, 64)
        elif op == 0x23:
            v, p = _leb_u(data, p)  # global.get — circom uses const inits
        else:
            raise ValueError(f"unsupported const expr op {op:#x}")
        assert data[p] == 0x0B
        return v, p + 1


class Trap(Exception):
    pass


class Instance:
    """Executes a parsed Module with host import functions.

    host_imports: dict (module, name) -> python callable taking/returning
    ints (params per the function type).
    """

    PAGE = 65536

    def __init__(self, module: Module, host_imports: dict,
                 max_pages: int = 32768):
        self.m = module
        self.mem = bytearray(module.mem_pages * self.PAGE)
        self.max_pages = max_pages
        self.globals = [v for (_, _, v) in module.globals_init]
        self.host = []
        for (mod, name, ti) in module.imports:
            fn = host_imports.get((mod, name))
            if fn is None:
                fn = self._missing(mod, name)
            self.host.append((fn, module.types[ti]))
        for off, seg in module.data_segments:
            self.mem[off:off + len(seg)] = seg
        self.table = list(module.table)
        for off, idxs in module.elem_segments:
            for i, fi in enumerate(idxs):
                self.table[off + i] = fi
        # pre-decode side tables for control flow per function
        self._jump_cache = {}

    @staticmethod
    def _missing(mod, name):
        def fn(*a):
            raise Trap(f"call to unresolved import {mod}.{name}{a}")
        return fn

    # ---- exports ----
    def invoke(self, name: str, *args):
        kind, idx = self.m.exports[name]
        assert kind == 0
        return self._call(idx, list(args))

    def _call(self, fidx: int, args):
        m = self.m
        if fidx < m.n_imported:
            fn, ftype = self.host[fidx]
            r = fn(*args)
            if not ftype.results:
                return None
            return r
        func = m.funcs[fidx - m.n_imported]
        ftype = m.types[func.type_idx]
        locals_ = list(args) + [0] * len(func.locals)
        return self._exec(func, ftype, locals_)

    # ---- control-flow pre-scan: match each block/loop/if to its end/else
    def _jumps(self, func):
        cached = self._jump_cache.get(id(func))
        if cached is not None:
            return cached
        body = func.body
        stack = []
        jumps = {}
        p = 0
        n = len(body)
        while p < n:
            op = body[p]
            q = p + 1
            if op in (0x02, 0x03, 0x04):      # block, loop, if
                q = self._skip_blocktype(body, q)
                stack.append((op, p))
            elif op == 0x05:                  # else
                kind, start = stack[-1]
                jumps[start] = ("else", p)
                stack[-1] = (0x04, start, p)  # if with else at p
            elif op == 0x0B:                  # end
                if stack:
                    top = stack.pop()
                    if len(top) == 3:
                        _, start, else_p = top
                        jumps[start] = ("ifelse", else_p, p)
                        jumps[else_p] = ("end", p)
                    else:
                        kind, start = top
                        jumps[start] = ("end", p)
            elif op in (0x0C, 0x0D):          # br, br_if
                _, q = _leb_u(body, q)
            elif op == 0x0E:                  # br_table
                cnt, q = _leb_u(body, q)
                for _ in range(cnt + 1):
                    _, q = _leb_u(body, q)
            elif op == 0x10:                  # call
                _, q = _leb_u(body, q)
            elif op == 0x11:                  # call_indirect
                _, q = _leb_u(body, q)
                q += 1
            elif op in (0x20, 0x21, 0x22, 0x23, 0x24):
                _, q = _leb_u(body, q)
            elif 0x28 <= op <= 0x3E:          # mem load/store
                _, q = _leb_u(body, q)
                _, q = _leb_u(body, q)
            elif op in (0x3F, 0x40):          # memory.size/grow
                q += 1
            elif op == 0x41:
                _, q = _leb_s(body, q, 32)
            elif op == 0x42:
                _, q = _leb_s(body, q, 64)
            elif op in (0x43,):
                q += 4
            elif op in (0x44,):
                q += 8
            p = q
        self._jump_cache[id(func)] = jumps
        return jumps

    @staticmethod
    def _skip_blocktype(body, q):
        # 0x40 empty, value types 0x7C-0x7F; (s33 typeidx unsupported range)
        return q + 1

    @staticmethod
    def _block_arity(body, q):
        return 0 if body[q] == 0x40 else 1

    def _exec(self, func, ftype, locals_):
        m = self.m
        mem = self.mem
        body = func.body
        jumps = self._jumps(func)
        st = []                 # operand stack
        # control stack entries: (start_pos, end_pos, is_loop, stack_depth)
        ctrl = []
        p = 0
        n = len(body)
        unp_u, unp_s = _leb_u, _leb_s

        while True:
            if p >= n:
                break
            op = body[p]
            p += 1
            if op == 0x0B:  # end
                if ctrl:
                    ctrl.pop()
                    continue
                break
            elif op == 0x02 or op == 0x03:  # block / loop
                p = self._skip_blocktype(body, p)
                info = jumps[p - 2]
                end = info[-1]
                ctrl.append((p - 2, end, op == 0x03, len(st)))
            elif op == 0x04:  # if
                p = self._skip_blocktype(body, p)
                start = p - 2
                info = jumps[start]
                cond = st.pop()
                if info[0] == "ifelse":
                    _, else_p, end = info
                    ctrl.append((start, end, False, len(st)))
                    if not cond:
                        p = else_p + 1
                else:
                    end = info[1]
                    if cond:
                        ctrl.append((start, end, False, len(st)))
                    else:
                        p = end + 1
            elif op == 0x05:  # else (falls here after then-branch) -> jump end
                end = jumps[p - 1][1]
                ctrl.pop()
                p = end + 1
            elif op == 0x0C or op == 0x0D:  # br / br_if
                depth, p = unp_u(body, p)
                if op == 0x0D and not st.pop():
                    continue
                p = self._do_branch(ctrl, depth, jumps, st)
            elif op == 0x0E:  # br_table
                cnt, p = unp_u(body, p)
                targets = []
                for _ in range(cnt):
                    tgt, p = unp_u(body, p)
                    targets.append(tgt)
                deflt, p = unp_u(body, p)
                i = st.pop() & MASK32
                depth = targets[i] if i < cnt else deflt
                p = self._do_branch(ctrl, depth, jumps, st)
            elif op == 0x0F:  # return
                return st[-1] if ftype.results else None
            elif op == 0x00:
                raise Trap("unreachable")
            elif op == 0x01:
                pass
            elif op == 0x10:  # call
                fi, p = unp_u(body, p)
                p = self._invoke_into(fi, st, p)
            elif op == 0x11:  # call_indirect
                ti, p = unp_u(body, p)
                p += 1  # table idx
                elem = st.pop() & MASK32
                fi = self.table[elem]
                if fi is None:
                    raise Trap("uninitialized table element")
                p = self._invoke_into(fi, st, p)
            elif op == 0x1A:  # drop
                st.pop()
            elif op == 0x1B:  # select
                c = st.pop()
                b = st.pop()
                a = st.pop()
                st.append(a if c else b)
            elif op == 0x20:  # local.get
                i, p = unp_u(body, p)
                st.append(locals_[i])
            elif op == 0x21:  # local.set
                i, p = unp_u(body, p)
                locals_[i] = st.pop()
            elif op == 0x22:  # local.tee
                i, p = unp_u(body, p)
                locals_[i] = st[-1]
            elif op == 0x23:  # global.get
                i, p = unp_u(body, p)
                st.append(self.globals[i])
            elif op == 0x24:  # global.set
                i, p = unp_u(body, p)
                self.globals[i] = st.pop()
            elif 0x28 <= op <= 0x35:  # loads
                _, p = unp_u(body, p)
                off, p = unp_u(body, p)
                addr = (st.pop() & MASK32) + off
                if op == 0x28:    # i32.load
                    v = int.from_bytes(mem[addr:addr + 4], "little")
                elif op == 0x29:  # i64.load
                    v = int.from_bytes(mem[addr:addr + 8], "little")
                elif op == 0x2C:  # i32.load8_s
                    v = mem[addr]
                    v = v - 256 if v >= 128 else v
                    v &= MASK32
                elif op == 0x2D:  # i32.load8_u
                    v = mem[addr]
                elif op == 0x2E:  # i32.load16_s
                    v = int.from_bytes(mem[addr:addr + 2], "little")
                    v = v - 65536 if v >= 32768 else v
                    v &= MASK32
                elif op == 0x2F:  # i32.load16_u
                    v = int.from_bytes(mem[addr:addr + 2], "little")
                elif op == 0x30:  # i64.load8_s
                    v = mem[addr]
                    v = (v - 256 if v >= 128 else v) & MASK64
                elif op == 0x31:  # i64.load8_u
                    v = mem[addr]
                elif op == 0x32:  # i64.load16_s
                    v = int.from_bytes(mem[addr:addr + 2], "little")
                    v = (v - 65536 if v >= 32768 else v) & MASK64
                elif op == 0x33:  # i64.load16_u
                    v = int.from_bytes(mem[addr:addr + 2], "little")
                elif op == 0x34:  # i64.load32_s
                    v = int.from_bytes(mem[addr:addr + 4], "little")
                    v = (v - (1 << 32) if v >> 31 else v) & MASK64
                elif op == 0x35:  # i64.load32_u
                    v = int.from_bytes(mem[addr:addr + 4], "little")
                else:
                    raise Trap(f"float load {op:#x}")
                st.append(v)
            elif 0x36 <= op <= 0x3E:  # stores
                _, p = unp_u(body, p)
                off, p = unp_u(body, p)
                v = st.pop()
                addr = (st.pop() & MASK32) + off
                if op == 0x36:    # i32.store
                    mem[addr:addr + 4] = (v & MASK32).to_bytes(4, "little")
                elif op == 0x37:  # i64.store
                    mem[addr:addr + 8] = (v & MASK64).to_bytes(8, "little")
                elif op == 0x3A:  # i32.store8
                    mem[addr] = v & 0xFF
                elif op == 0x3B:  # i32.store16
                    mem[addr:addr + 2] = (v & 0xFFFF).to_bytes(2, "little")
                elif op == 0x3C:  # i64.store8
                    mem[addr] = v & 0xFF
                elif op == 0x3D:  # i64.store16
                    mem[addr:addr + 2] = (v & 0xFFFF).to_bytes(2, "little")
                elif op == 0x3E:  # i64.store32
                    mem[addr:addr + 4] = (v & MASK32).to_bytes(4, "little")
                else:
                    raise Trap(f"float store {op:#x}")
            elif op == 0x3F:  # memory.size
                p += 1
                st.append(len(mem) // self.PAGE)
            elif op == 0x40:  # memory.grow
                p += 1
                delta = st.pop() & MASK32
                cur = len(mem) // self.PAGE
                if cur + delta > self.max_pages:
                    st.append(MASK32)  # -1
                else:
                    self.mem.extend(b"\0" * (delta * self.PAGE))
                    mem = self.mem
                    st.append(cur)
            elif op == 0x41:  # i32.const
                v, p = unp_s(body, p, 32)
                st.append(v & MASK32)
            elif op == 0x42:  # i64.const
                v, p = unp_s(body, p, 64)
                st.append(v & MASK64)
            elif op == 0x45:  # i32.eqz
                st.append(1 if (st.pop() & MASK32) == 0 else 0)
            elif 0x46 <= op <= 0x4F:  # i32 comparisons
                b = st.pop() & MASK32
                a = st.pop() & MASK32
                sa, sb = _s32(a), _s32(b)
                v = {0x46: a == b, 0x47: a != b, 0x48: sa < sb, 0x49: a < b,
                     0x4A: sa > sb, 0x4B: a > b, 0x4C: sa <= sb,
                     0x4D: a <= b, 0x4E: sa >= sb, 0x4F: a >= b}[op]
                st.append(1 if v else 0)
            elif op == 0x50:  # i64.eqz
                st.append(1 if (st.pop() & MASK64) == 0 else 0)
            elif 0x51 <= op <= 0x5A:  # i64 comparisons
                b = st.pop() & MASK64
                a = st.pop() & MASK64
                sa, sb = _s64(a), _s64(b)
                v = {0x51: a == b, 0x52: a != b, 0x53: sa < sb, 0x54: a < b,
                     0x55: sa > sb, 0x56: a > b, 0x57: sa <= sb,
                     0x58: a <= b, 0x59: sa >= sb, 0x5A: a >= b}[op]
                st.append(1 if v else 0)
            elif 0x67 <= op <= 0x78:  # i32 arithmetic
                st.append(self._i32_op(op, st))
            elif 0x79 <= op <= 0x8A:  # i64 arithmetic
                st.append(self._i64_op(op, st))
            elif op == 0xA7:  # i32.wrap_i64
                st.append(st.pop() & MASK32)
            elif op == 0xAC:  # i64.extend_i32_s
                st.append(_s32(st.pop()) & MASK64)
            elif op == 0xAD:  # i64.extend_i32_u
                st.append(st.pop() & MASK32)
            else:
                raise Trap(f"unsupported opcode {op:#x} at {p - 1}")
        return st[-1] if ftype.results and st else None

    def _invoke_into(self, fi, st, p):
        m = self.m
        if fi < m.n_imported:
            fn, ftype = self.host[fi]
        else:
            func = m.funcs[fi - m.n_imported]
            ftype = m.types[func.type_idx]
        nargs = len(ftype.params)
        args = st[len(st) - nargs:] if nargs else []
        del st[len(st) - nargs:]
        r = self._call(fi, args)
        if ftype.results:
            st.append(r & (MASK32 if ftype.results[0] == 0x7F else MASK64)
                      if isinstance(r, int) else r)
        return p

    def _do_branch(self, ctrl, depth, jumps, st):
        target = ctrl[len(ctrl) - 1 - depth]
        start, end, is_loop, depth_st = target
        del ctrl[len(ctrl) - depth:]
        if is_loop:
            # branch to loop start: re-enter the loop (keep its ctrl entry)
            del st[depth_st:]
            return start + 2  # skip opcode + blocktype
        ctrl.pop()
        del st[depth_st:]
        return end + 1

    @staticmethod
    def _i32_op(op, st):
        if op == 0x67:  # clz
            a = st.pop() & MASK32
            return (32 - a.bit_length()) if a else 32
        if op == 0x68:  # ctz
            a = st.pop() & MASK32
            return (a & -a).bit_length() - 1 if a else 32
        if op == 0x69:  # popcnt
            return bin(st.pop() & MASK32).count("1")
        b = st.pop() & MASK32
        a = st.pop() & MASK32
        if op == 0x6A:
            return (a + b) & MASK32
        if op == 0x6B:
            return (a - b) & MASK32
        if op == 0x6C:
            return (a * b) & MASK32
        if op == 0x6D:  # div_s
            sa, sb = _s32(a), _s32(b)
            if sb == 0:
                raise Trap("div by zero")
            q = abs(sa) // abs(sb)
            if (sa < 0) != (sb < 0):
                q = -q
            return q & MASK32
        if op == 0x6E:  # div_u
            if b == 0:
                raise Trap("div by zero")
            return (a // b) & MASK32
        if op == 0x6F:  # rem_s
            sa, sb = _s32(a), _s32(b)
            if sb == 0:
                raise Trap("rem by zero")
            r = abs(sa) % abs(sb)
            if sa < 0:
                r = -r
            return r & MASK32
        if op == 0x70:  # rem_u
            if b == 0:
                raise Trap("rem by zero")
            return (a % b) & MASK32
        if op == 0x71:
            return a & b
        if op == 0x72:
            return a | b
        if op == 0x73:
            return a ^ b
        if op == 0x74:
            return (a << (b % 32)) & MASK32
        if op == 0x75:  # shr_s
            return (_s32(a) >> (b % 32)) & MASK32
        if op == 0x76:  # shr_u
            return a >> (b % 32)
        if op == 0x77:  # rotl
            b %= 32
            return ((a << b) | (a >> (32 - b))) & MASK32 if b else a
        if op == 0x78:  # rotr
            b %= 32
            return ((a >> b) | (a << (32 - b))) & MASK32 if b else a
        raise Trap(f"i32 op {op:#x}")

    @staticmethod
    def _i64_op(op, st):
        if op == 0x79:  # clz
            a = st.pop() & MASK64
            return (64 - a.bit_length()) if a else 64
        if op == 0x7A:  # ctz
            a = st.pop() & MASK64
            return (a & -a).bit_length() - 1 if a else 64
        if op == 0x7B:
            return bin(st.pop() & MASK64).count("1")
        b = st.pop() & MASK64
        a = st.pop() & MASK64
        if op == 0x7C:
            return (a + b) & MASK64
        if op == 0x7D:
            return (a - b) & MASK64
        if op == 0x7E:
            return (a * b) & MASK64
        if op == 0x7F:  # div_s
            sa, sb = _s64(a), _s64(b)
            if sb == 0:
                raise Trap("div by zero")
            q = abs(sa) // abs(sb)
            if (sa < 0) != (sb < 0):
                q = -q
            return q & MASK64
        if op == 0x80:
            if b == 0:
                raise Trap("div by zero")
            return (a // b) & MASK64
        if op == 0x81:
            sa, sb = _s64(a), _s64(b)
            if sb == 0:
                raise Trap("rem by zero")
            r = abs(sa) % abs(sb)
            if sa < 0:
                r = -r
            return r & MASK64
        if op == 0x82:
            if b == 0:
                raise Trap("rem by zero")
            return (a % b) & MASK64
        if op == 0x83:
            return a & b
        if op == 0x84:
            return a | b
        if op == 0x85:
            return a ^ b
        if op == 0x86:
            return (a << (b % 64)) & MASK64
        if op == 0x87:
            return (_s64(a) >> (b % 64)) & MASK64
        if op == 0x88:
            return a >> (b % 64)
        if op == 0x89:
            b %= 64
            return ((a << b) | (a >> (64 - b))) & MASK64 if b else a
        if op == 0x8A:
            b %= 64
            return ((a >> b) | (a << (64 - b))) & MASK64 if b else a
        raise Trap(f"i64 op {op:#x}")
