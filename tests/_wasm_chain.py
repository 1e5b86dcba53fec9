"""The squaring chain as circom would compile it: `.wasm`, `.r1cs`, `.sym`
and `input.json`, written from scratch for the witness-calculator tests.

The circuit: wire 0 = 1, wire 1 = public input x, wire i + 2 = wire_{i+1}^2
for i < nc.  Constraint i carries circom's coefficients for
`y <== x * x`: p - 1 on one factor (A for even i, B for odd i) and on the
output, so (-x) x = -y (`chip_smoke.circom_chain`); with `ones`, every
coefficient is 1 (`chip_smoke.plonk_circuit`, `__graft_entry__._tiny_circuit`).
The witness equals `_tiny_circuit`'s for x = 0xDEADBEEF.

The `.wasm` follows circom 2's witness ABI (getVersion 2, getFieldNumLen32,
getRawPrime, the shared read/write memory, init, getInputSignalSize,
setInputSignal, getWitness, getMessageChar; imports runtime.exceptionHandler,
printErrorMessage, writeBufferMessage, showSharedRWMemory).  Its field
arithmetic runs in WASM as circom's does: a CIOS Montgomery product over
8 x 32-bit limbs in i64 arithmetic, p and R^2 mod p in a data segment, the
witness kept in Montgomery form and converted out by getWitness.  Setting
the last input runs the chain.  With init(1), x = 0 fails the chain's
assert: a message goes out through printErrorMessage, then
exceptionHandler(4).  An unknown signal hash makes getInputSignalSize
return -1.  The prime is a parameter (any prime below 2^255: bn254 Fr,
bls12-381 Fr).

Imports neither jax nor either package, so the card's machine (no jax) can
use it too.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

N32 = 8                  # 32-bit limbs of a field element
X = 0xDEADBEEF           # the chain's input

# linear memory layout (bytes)
P_AT, R2_AT, ONE_AT, MSG_AT = 0, 32, 64, 96
SHARED_AT, T_AT, W_AT = 256, 320, 1024
MESSAGE = b"Error in template SquaringChain_0 line: 7"

I32, I64 = 0x7F, 0x7E
OPS = {
    "unreachable": 0x00, "loop": 0x03, "if": 0x04, "end": 0x0B, "br_if": 0x0D,
    "return": 0x0F, "call": 0x10, "local.get": 0x20, "local.set": 0x21,
    "global.get": 0x23, "global.set": 0x24, "i32.load": 0x28, "i64.load": 0x29,
    "i32.load8_u": 0x2D, "i64.load32_u": 0x35, "i32.store": 0x36,
    "i32.const": 0x41, "i64.const": 0x42, "i32.eq": 0x46, "i32.ne": 0x47,
    "i32.lt_u": 0x49, "i64.eqz": 0x50, "i64.gt_u": 0x56, "i32.add": 0x6A,
    "i32.and": 0x71, "i32.or": 0x72, "i32.shl": 0x74, "i64.add": 0x7C,
    "i64.sub": 0x7D, "i64.mul": 0x7E, "i64.and": 0x83, "i64.or": 0x84,
    "i64.shr_u": 0x88, "i32.wrap_i64": 0xA7,
}


def fnv_hash(s: str) -> int:
    """circom's signal-name hash (fnv1a-64)."""
    h = 0xCBF29CE484222325
    for ch in s:
        h ^= ord(ch)
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _uleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _sleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if (v == 0 and not b & 0x40) or (v == -1 and b & 0x40):
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _s32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def _encode(instrs) -> bytes:
    """(name, *immediates) tuples -> bytecode.  Blocks are untyped (0x40);
    loads and stores take (align, offset)."""
    out = bytearray()
    for name, *imm in instrs:
        out.append(OPS[name])
        if name in ("loop", "if"):
            out.append(0x40)
        elif name == "i32.const":
            out += _sleb(_s32(imm[0]))
        elif name == "i64.const":
            out += _sleb(imm[0])
        elif "load" in name or "store" in name:
            out += _uleb(imm[0]) + _uleb(imm[1])
        else:
            for v in imm:
                out += _uleb(v)
    return bytes(out)


def _vec(items) -> bytes:
    return _uleb(len(items)) + b"".join(items)


def _section(sid: int, payload: bytes) -> bytes:
    return bytes([sid]) + _uleb(len(payload)) + payload


def _const_expr(v: int) -> bytes:
    return b"\x41" + _sleb(_s32(v)) + b"\x0B"


# ---------------------------------------------------------------- the code

def _at4(base_local, idx_local):
    """Address base + 4 * idx on the stack."""
    return [("local.get", base_local), ("local.get", idx_local), ("i32.const", 2),
            ("i32.shl",), ("i32.add",)]


def _idx4(idx_local):
    """4 * idx on the stack (a fixed base goes into the memarg offset)."""
    return [("local.get", idx_local), ("i32.const", 2), ("i32.shl",)]


def _count_loop(idx_local, stop, body):
    """do { body; idx += 1 } while idx < stop."""
    return ([("loop",)] + body
            + [("local.get", idx_local), ("i32.const", 1), ("i32.add",),
               ("local.set", idx_local), ("local.get", idx_local), ("i32.const", stop),
               ("i32.lt_u",), ("br_if", 0), ("end",)])


def _mont_mul(np0: int):
    """mont_mul(a, b, r): r = a b R^-1 mod p (CIOS over 32-bit limbs, the sum
    in T).  Locals: a 0, b 1, r 2, i 3, j 4; c 5, m 6, bi 7, t 8 (i64)."""
    a, b, r, i, j, c, m, bi, t = range(9)
    ld_t = lambda off=0: _idx4(j) + [("i64.load32_u", 2, T_AT + off)]
    st_t = lambda off=0: [("i32.wrap_i64",), ("i32.store", 2, T_AT + off)]
    body = [("i32.const", 0), ("local.set", j)]
    body += _count_loop(j, N32 + 2, _idx4(j) + [("i32.const", 0), ("i32.store", 2, T_AT)])
    body += [("i32.const", 0), ("local.set", i)]
    inner1 = (_idx4(j) + ld_t()
              + _at4(a, j) + [("i64.load32_u", 2, 0), ("local.get", bi), ("i64.mul",),
                              ("i64.add",), ("local.get", c), ("i64.add",),
                              ("local.set", t), ("local.get", t)] + st_t()
              + [("local.get", t), ("i64.const", 32), ("i64.shr_u",), ("local.set", c)])
    inner2 = (_idx4(j) + ld_t()
              + [("local.get", m)] + _idx4(j) + [("i64.load32_u", 2, P_AT), ("i64.mul",),
                                                 ("i64.add",), ("local.get", c), ("i64.add",),
                                                 ("local.set", t), ("local.get", t)]
              + st_t(-4)
              + [("local.get", t), ("i64.const", 32), ("i64.shr_u",), ("local.set", c)])
    outer = (
        [("i64.const", 0), ("local.set", c)]
        + _at4(b, i) + [("i64.load32_u", 2, 0), ("local.set", bi),
                        ("i32.const", 0), ("local.set", j)]
        + _count_loop(j, N32, inner1)
        # t[n] += c; t[n+1] = carry
        + [("i32.const", 0), ("i64.load32_u", 2, T_AT + 4 * N32), ("local.get", c),
           ("i64.add",), ("local.set", t),
           ("i32.const", 0), ("local.get", t), ("i32.wrap_i64",),
           ("i32.store", 2, T_AT + 4 * N32),
           ("i32.const", 0), ("local.get", t), ("i64.const", 32), ("i64.shr_u",),
           ("i32.wrap_i64",), ("i32.store", 2, T_AT + 4 * N32 + 4)]
        # m = t[0] np0 mod 2^32; c = (t[0] + m p[0]) >> 32
        + [("i32.const", 0), ("i64.load32_u", 2, T_AT), ("i64.const", np0), ("i64.mul",),
           ("i64.const", 0xFFFFFFFF), ("i64.and",), ("local.set", m),
           ("i32.const", 0), ("i64.load32_u", 2, T_AT), ("local.get", m),
           ("i32.const", 0), ("i64.load32_u", 2, P_AT), ("i64.mul",), ("i64.add",),
           ("i64.const", 32), ("i64.shr_u",), ("local.set", c),
           ("i32.const", 1), ("local.set", j)]
        + _count_loop(j, N32, inner2)
        # t[n-1] = t[n] + c; t[n] = t[n+1] + carry
        + [("i32.const", 0), ("i64.load32_u", 2, T_AT + 4 * N32), ("local.get", c),
           ("i64.add",), ("local.set", t),
           ("i32.const", 0), ("local.get", t), ("i32.wrap_i64",),
           ("i32.store", 2, T_AT + 4 * N32 - 4),
           ("i32.const", 0), ("i32.const", 0), ("i64.load32_u", 2, T_AT + 4 * N32 + 4),
           ("local.get", t), ("i64.const", 32), ("i64.shr_u",), ("i64.add",),
           ("i32.wrap_i64",), ("i32.store", 2, T_AT + 4 * N32)])
    body += _count_loop(i, N32, outer)
    # r = t - p; where that borrows past t[n], r = t
    sub = (_at4(r, j) + _idx4(j) + [("i64.load32_u", 2, T_AT)] + _idx4(j)
           + [("i64.load32_u", 2, P_AT), ("i64.sub",), ("local.get", c), ("i64.sub",),
              ("local.set", t), ("local.get", t), ("i32.wrap_i64",), ("i32.store", 2, 0),
              ("local.get", t), ("i64.const", 63), ("i64.shr_u",), ("local.set", c)])
    copy = _at4(r, j) + _idx4(j) + [("i32.load", 2, T_AT), ("i32.store", 2, 0)]
    body += ([("i64.const", 0), ("local.set", c), ("i32.const", 0), ("local.set", j)]
             + _count_loop(j, N32, sub)
             + [("local.get", c), ("i32.const", 0), ("i64.load32_u", 2, T_AT + 4 * N32),
                ("i64.gt_u",), ("if",), ("i32.const", 0), ("local.set", j)]
             + _count_loop(j, N32, copy) + [("end",)])
    return [(2, I32), (4, I64)], body


def chain_wasm(prime: int, nc: int) -> bytes:
    """The circuit's witness calculator for `nc` >= 1 constraints over the
    field of `prime` (< 2^255)."""
    assert nc >= 1 and prime.bit_length() <= 255
    np0 = (-pow(prime, -1, 1 << 32)) % (1 << 32)
    r2 = pow(2, 512, prime)
    hx = fnv_hash("x")
    xm, xl = hx >> 32, hx & 0xFFFFFFFF
    n_wit = nc + 2
    pages = -(-(W_AT + 32 * n_wit) // 65536)

    types = [((I32,), ()), ((), ()), ((I32, I32, I32), ()), ((), (I32,)),
             ((I32,), (I32,)), ((I32, I32), ()), ((I32, I32), (I32,))]
    imports = [("exceptionHandler", 0), ("printErrorMessage", 1),
               ("writeBufferMessage", 1), ("showSharedRWMemory", 1)]
    EXC, PRINT_ERR = 0, 1
    MONT = len(imports)
    G_COUNT, G_SANITY, G_MSG = 0, 1, 2
    call_mont = lambda a, b, r: [("i32.const", a), ("i32.const", b), ("i32.const", r),
                                 ("call", MONT)]
    fail = lambda code: [("i32.const", code), ("call", EXC), ("unreachable",)]
    hash_is_x = lambda cmp: [("local.get", 0), ("i32.const", xm), (cmp,),
                             ("local.get", 1), ("i32.const", xl), (cmp,)]
    x_is_zero = ([("i32.const", 0), ("i64.load", 3, W_AT + 32)]
                 + [op for k in (1, 2, 3)
                    for op in (("i32.const", 0), ("i64.load", 3, W_AT + 32 + 8 * k),
                               ("i64.or",))]
                 + [("i64.eqz",)])
    q = 3   # setInputSignal's cursor over the witness
    funcs = {   # name -> (type, locals, body, exported)
        "mont_mul": (2, *_mont_mul(np0), False),
        "getVersion": (3, [], [("i32.const", 2)], True),
        "getFieldNumLen32": (3, [], [("i32.const", N32)], True),
        "getRawPrime": (1, [(1, I32)], [("i32.const", 0), ("local.set", 0)] + _count_loop(
            0, N32, _idx4(0) + _idx4(0) + [("i32.load", 2, P_AT),
                                           ("i32.store", 2, SHARED_AT)]), True),
        "readSharedRWMemory": (4, [], _idx4(0) + [("i32.load", 2, SHARED_AT)], True),
        "writeSharedRWMemory": (5, [], _idx4(0) + [("local.get", 1),
                                                  ("i32.store", 2, SHARED_AT)], True),
        "getWitnessSize": (3, [], [("i32.const", n_wit)], True),
        "getInputSize": (3, [], [("i32.const", 1)], True),
        "getInputSignalSize": (6, [], hash_is_x("i32.eq") + [
            ("i32.and",), ("if",), ("i32.const", 1), ("return",), ("end",),
            ("i32.const", -1)], True),
        "init": (0, [], [("local.get", 0), ("global.set", G_SANITY), ("i32.const", 0),
                         ("global.set", G_COUNT)] + call_mont(ONE_AT, R2_AT, W_AT), True),
        "setInputSignal": (2, [(1, I32)], (
            hash_is_x("i32.ne") + [("i32.or",), ("if",)] + fail(1) + [("end",)]
            + [("local.get", 2), ("if",)] + fail(6) + [("end",)]
            + [("global.get", G_COUNT), ("if",)] + fail(3) + [("end",)]
            + call_mont(SHARED_AT, R2_AT, W_AT + 32)
            + [("i32.const", 1), ("global.set", G_COUNT), ("global.get", G_SANITY), ("if",)]
            + x_is_zero + [("if",), ("i32.const", MSG_AT), ("global.set", G_MSG),
                           ("call", PRINT_ERR)] + fail(4) + [("end",), ("end",)]
            + [("i32.const", W_AT + 32), ("local.set", q), ("loop",),
               ("local.get", q), ("local.get", q), ("local.get", q), ("i32.const", 32),
               ("i32.add",), ("call", MONT),
               ("local.get", q), ("i32.const", 32), ("i32.add",), ("local.set", q),
               ("local.get", q), ("i32.const", W_AT + 32 * (nc + 1)), ("i32.lt_u",),
               ("br_if", 0), ("end",)]), True),
        "getWitness": (0, [], [("local.get", 0), ("i32.const", 5), ("i32.shl",),
                               ("i32.const", W_AT), ("i32.add",), ("i32.const", ONE_AT),
                               ("i32.const", SHARED_AT), ("call", MONT)], True),
        "getMessageChar": (3, [(1, I32)], [
            ("global.get", G_MSG), ("i32.load8_u", 0, 0), ("local.set", 0),
            ("local.get", 0), ("if",), ("global.get", G_MSG), ("i32.const", 1),
            ("i32.add",), ("global.set", G_MSG), ("end",), ("local.get", 0)], True),
    }
    names = list(funcs)

    def ftype(params, results):
        return b"\x60" + _vec([bytes([v]) for v in params]) + _vec([bytes([v]) for v in results])

    def body(locals_, instrs):
        code = (_vec([_uleb(n) + bytes([vt]) for n, vt in locals_])
                + _encode(instrs) + b"\x0B")
        return _uleb(len(code)) + code

    def name(s):
        return _uleb(len(s)) + s.encode()

    limbs = lambda v: v.to_bytes(32, "little")
    data = [(P_AT, limbs(prime)), (R2_AT, limbs(r2)), (ONE_AT, limbs(1)),
            (MSG_AT, MESSAGE + b"\0")]
    exports = [name("memory") + b"\x02" + _uleb(0)] + [
        name(n) + b"\x00" + _uleb(len(imports) + k)
        for k, n in enumerate(names) if funcs[n][3]]
    return (b"\0asm" + struct.pack("<I", 1)
            + _section(1, _vec([ftype(*t) for t in types]))
            + _section(2, _vec([name("runtime") + name(n) + b"\x00" + _uleb(t)
                                for n, t in imports]))
            + _section(3, _vec([_uleb(funcs[n][0]) for n in names]))
            + _section(5, _vec([b"\x00" + _uleb(pages)]))
            + _section(6, _vec([bytes([I32, 1]) + _const_expr(v)
                                for v in (0, 0, MSG_AT + len(MESSAGE))]))
            + _section(7, _vec(exports))
            + _section(10, _vec([body(funcs[n][1], funcs[n][2]) for n in names]))
            + _section(11, _vec([b"\x00" + _const_expr(at) + _uleb(len(b)) + b
                                 for at, b in data])))


# ------------------------------------------------------- r1cs, sym, input

def chain_r1cs(prime: int, nc: int, ones: bool = False) -> bytes:
    """circom's binary .r1cs (v1: header, constraints, wire-to-label map).
    ones: every coefficient 1 (`__graft_entry__._tiny_circuit`'s chain,
    whose keys the stored fixtures hold) in place of circom's p - 1."""
    n8, n_wires = 32, nc + 2
    header = (struct.pack("<I", n8) + prime.to_bytes(n8, "little")
              + struct.pack("<IIIIQI", n_wires, 0, 1, 0, n_wires, nc))
    entry = np.dtype([("n", "<u4"), ("s", "<u4"), ("v", "u1", n8)])
    e = np.zeros((nc, 3), entry)
    i = np.arange(nc)
    e["n"] = 1
    e["s"] = np.stack([i + 1, i + 1, i + 2], 1)
    one = np.frombuffer((1).to_bytes(n8, "little"), np.uint8)
    neg = np.frombuffer((prime - 1).to_bytes(n8, "little"), np.uint8)
    e["v"] = one
    if not ones:
        e["v"][i, i % 2] = neg
        e["v"][:, 2] = neg
    labels = np.arange(n_wires, dtype="<u8").tobytes()
    sections = [(1, header), (2, e.tobytes()), (3, labels)]
    return (b"r1cs" + struct.pack("<II", 1, len(sections))
            + b"".join(struct.pack("<IQ", sid, len(p)) + p for sid, p in sections))


def chain_sym(nc: int) -> str:
    """One `label,wire,component,name` line per signal wire."""
    lines = ["1,1,0,main.x"] + [f"{k + 2},{k + 2},0,main.y[{k}]" for k in range(nc)]
    return "\n".join(lines) + "\n"


def chain_witness(prime: int, nc: int, x: int = X) -> list[int]:
    w = [1, x % prime]
    for _ in range(nc):
        w.append(w[-1] * w[-1] % prime)
    return w


def write_chain(directory: str, prime: int, nc: int, x: int = X,
                ones: bool = False) -> dict[str, str]:
    """Write chain.wasm, chain.r1cs, chain.sym and input.json; name -> path."""
    os.makedirs(directory, exist_ok=True)
    files = {"chain.wasm": chain_wasm(prime, nc), "chain.r1cs": chain_r1cs(prime, nc, ones),
             "chain.sym": chain_sym(nc).encode(),
             "input.json": json.dumps({"x": str(x)}).encode()}
    paths = {}
    for fn, data in files.items():
        paths[fn] = os.path.join(directory, fn)
        with open(paths[fn], "wb") as f:
            f.write(data)
    return paths
