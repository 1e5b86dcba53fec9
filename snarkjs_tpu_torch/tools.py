"""Introspection & debugging tools: r1cs info/print/export-json, wtns
check/debug/export-json, sym-file loading, the Groth16 zkey dump (port of
snarkjs_tpu/tools.py; reference src/r1cs_info.js, src/r1cs_print.js,
src/r1cs_export_json.js, src/wtns_check.js, src/wtns_debug.js,
src/wtns_export_json.js, src/loadsyms.js, src/zkey_export_json.js).

`wtns_check` runs on the card (K-field through `ftorch`); the others are
host code.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as devmod
from .curves import host_curve as hc
from .fields import ftorch
from .formats import wtns as wtns_fmt
from .formats.r1cs import R1cs


def _fr_of(prime: int):
    return hc.BN254.fr if prime == hc.BN254.fr.p else hc.BLS12_381.fr


def r1cs_info(r1cs: R1cs, logger=None) -> dict:
    """reference src/r1cs_info.js:26-45."""
    if r1cs.prime == hc.BN254.fr.p:
        curve = "bn-128"
    elif r1cs.prime == hc.BLS12_381.fr.p:
        curve = "bls12-381"
    else:
        curve = f"unknown (prime {r1cs.prime})"
    info = {
        "curve": curve,
        "nWires": r1cs.n_wires,
        "nConstraints": r1cs.n_constraints,
        "nPrvInputs": r1cs.n_prv_in,
        "nPubInputs": r1cs.n_pub_in,
        "nLabels": r1cs.n_labels,
        "nOutputs": r1cs.n_pub_out,
    }
    if logger:
        logger.info(f"Curve: {curve}")
        logger.info(f"# of Wires: {r1cs.n_wires}")
        logger.info(f"# of Constraints: {r1cs.n_constraints}")
        logger.info(f"# of Private Inputs: {r1cs.n_prv_in}")
        logger.info(f"# of Public Inputs: {r1cs.n_pub_in}")
        logger.info(f"# of Labels: {r1cs.n_labels}")
        logger.info(f"# of Outputs: {r1cs.n_pub_out}")
    return info


def _constraint_lcs(r1cs: R1cs, fr):
    """Flat entry arrays -> per-constraint [lcA, lcB, lcC] dicts."""
    vals = ftorch.np_to_ints(fr, r1cs.vals)
    lcs = [[{}, {}, {}] for _ in range(r1cs.n_constraints)]
    for mi, ci, si, v in zip(r1cs.m, r1cs.c, r1cs.s, vals):
        d = lcs[int(ci)][int(mi)]
        d[int(si)] = (d.get(int(si), 0) + v) % fr.p
    return lcs


def r1cs_export_json(r1cs: R1cs) -> dict:
    """reference src/r1cs_export_json.js (r1csfile exportJson shape)."""
    lcs = _constraint_lcs(r1cs, _fr_of(r1cs.prime))
    return {
        "n8": r1cs.n8,
        "prime": str(r1cs.prime),
        "nVars": r1cs.n_wires,
        "nOutputs": r1cs.n_pub_out,
        "nPubInputs": r1cs.n_pub_in,
        "nPrvInputs": r1cs.n_prv_in,
        "nLabels": r1cs.n_labels,
        "nConstraints": r1cs.n_constraints,
        "constraints": [[{str(s): str(v) for s, v in lc.items()}
                         for lc in c] for c in lcs],
        "map": ([int(x) for x in r1cs.map]
                if r1cs.map is not None else None),
    }


def load_syms(path_or_text) -> dict:
    """circom .sym parser (reference src/loadsyms.js:22-56)."""
    if isinstance(path_or_text, str) and "\n" not in path_or_text:
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    sym = {"labelIdx2Name": {0: "one"}, "varIdx2Name": {0: "one"},
           "componentIdx2Name": {}}
    for line in text.split("\n"):
        arr = line.split(",")
        if len(arr) != 4:
            continue
        lab, var, comp, name = int(arr[0]), int(arr[1]), int(arr[2]), arr[3]
        if var in sym["varIdx2Name"]:
            sym["varIdx2Name"][var] += "|" + name
        else:
            sym["varIdx2Name"][var] = name
        sym["labelIdx2Name"][lab] = name
        if comp not in sym["componentIdx2Name"]:
            sym["componentIdx2Name"][comp] = ".".join(name.split(".")[:-1])
    return sym


def r1cs_print(r1cs: R1cs, syms: dict, logger=None) -> list[str]:
    """reference src/r1cs_print.js:20-50."""
    fr = _fr_of(r1cs.prime)
    p = fr.p
    lcs = _constraint_lcs(r1cs, fr)

    def fr_str(v):
        return str(v - p) if v > p // 2 else str(v)

    def lc2str(lc):
        s = ""
        for k in lc:
            name = syms["varIdx2Name"].get(k, f"v{k}")
            if name == "one":
                name = "1"
            vs = fr_str(lc[k])
            if vs == "1":
                vs = ""
            if vs == "-1":
                vs = "-"
            if s != "" and not vs.startswith("-"):
                vs = "+" + vs
            if s != "":
                vs = " " + vs
            s += vs + name
        return s

    out = []
    for c in lcs:
        line = f"[ {lc2str(c[0])} ] * [ {lc2str(c[1])} ] - [ {lc2str(c[2])} ] = 0"
        out.append(line)
        if logger:
            logger.info(line)
    return out


def wtns_export_json(witness: wtns_fmt.Witness) -> list[str]:
    """reference src/wtns_export_json.js."""
    return [str(x) for x in ftorch.np_to_ints(_fr_of(witness.q), witness.values)]


def wtns_check(r1cs: R1cs, witness: wtns_fmt.Witness, logger=None,
               device=None) -> bool:
    """Re-evaluate every constraint A*B - C == 0 against the witness
    (reference src/wtns_check.js:26-150), on `device` (None means the card;
    raises without one).  Per-entry gather, Montgomery products and segment
    sums per constraint: 16 K-field launches whatever the size."""
    from .protocols.groth16 import _segment_field_sum

    dev = devmod.resolve(device)
    if witness.q != r1cs.prime:
        if logger:
            logger.error("Curve of the witness does not match the r1cs curve")
        return False
    if witness.n != r1cs.n_wires:
        if logger:
            logger.error(f"Invalid witness length. Circuit: {r1cs.n_wires}, "
                         f"witness: {witness.n}")
        return False

    ctx = ftorch.get_ctx(_fr_of(r1cs.prime).name)
    nc = r1cs.n_constraints
    if nc == 0:
        return True

    wit = ftorch.to_tensor(witness.values, dev)
    s = torch.from_numpy(r1cs.s.astype(np.int64)).to(dev)
    vals_m = ftorch.to_mont(ctx, ftorch.to_tensor(r1cs.vals, dev))  # coefs * R
    # (coef * R) * w * R^-1: the plain product of each entry
    prod = ftorch.mont_mul(ctx, vals_m, wit[:, s].contiguous())
    m = torch.from_numpy(r1cs.m.astype(np.int64)).to(dev)
    c = torch.from_numpy(r1cs.c.astype(np.int64)).to(dev)
    drop = torch.full_like(c, nc)
    A, B, C = (_segment_field_sum(ctx, prod, torch.where(m == k, c, drop), nc)
               for k in range(3))
    lhs = ftorch.mont_mul(ctx, ftorch.to_mont(ctx, A), B)   # plain A*B
    bad = ~ftorch.eq(ctx, lhs, C).cpu().numpy()
    if bad.any():
        if logger:
            idx = int(np.nonzero(bad)[0][0])
            logger.error(f"Constraint {idx} does not match")
        return False
    if logger:
        logger.info("WITNESS IS CORRECT")
    return True


def wtns_debug(input_map: dict, wasm_path_or_bytes, sym_path=None,
               logger=None, log_get=True, log_set=True, log_trigger=True,
               **options) -> bytes:
    """Witness calculation with signal get/set/trigger logging (reference
    src/wtns_debug.js:29-72: options.logGetSignal/logSetSignal/
    logStartComponent/logFinishComponent).  Returns the .wtns bytes; log
    lines go to `logger` when given, signal ids resolved through the .sym
    file when available.  The hooks need the Python VM, which runs whenever
    a logger is given."""
    from .wasm.witness_calculator import WitnessCalculator

    if isinstance(wasm_path_or_bytes, str):
        with open(wasm_path_or_bytes, "rb") as f:
            wasm_path_or_bytes = f.read()

    names = {}
    if sym_path:
        syms = load_syms(sym_path)
        names = syms.get("varIdx2Name", {})

    def nm(sig):
        return names.get(sig, names.get(str(sig), str(sig)))

    hooks = {}
    if logger:
        if log_get:
            hooks["get"] = lambda s_, v: logger.info(f"GET {nm(s_)} --> {v}")
        if log_set:
            hooks["set"] = lambda s_, v: logger.info(f"SET {nm(s_)} <-- {v}")
        if log_trigger:
            hooks["start"] = lambda c: logger.info(f"START: {c}")
            hooks["finish"] = lambda c: logger.info(f"FINISH: {c}")
    wc = WitnessCalculator(wasm_path_or_bytes, sanity_check=True, hooks=hooks)
    return wc.calculate_wtns_bin(input_map, sanity_check=True)


def zkey_export_json(zkey_path_or_bytes) -> dict:
    """Full Groth16 zkey dump as a JSON-ready object (reference
    src/zkey_export_json.js:1-11 over zkey_utils.readZKey:340-444, which
    only supports the Groth16 layout; stringified bigints, Fr coefficient
    values un-Montgomeried twice — readFr2 multiplies by Rri^2)."""
    from .formats import zkey as zkey_fmt

    zk = zkey_fmt.read_groth16_zkey(zkey_path_or_bytes)
    fq, fr = zk.curve.fq, zk.curve.fr

    def g1o(p):
        return ["0", "1", "0"] if p is None else [str(p[0]), str(p[1]), "1"]

    def g2o(p):
        if p is None:
            return [["0", "0"], ["1", "0"], ["0", "0"]]
        return [[str(p[0][0]), str(p[0][1])],
                [str(p[1][0]), str(p[1][1])], ["1", "0"]]

    def g1_list(pts):
        x, y, inf = pts
        xs = ftorch.np_to_ints(fq, np.asarray(x))
        ys = ftorch.np_to_ints(fq, np.asarray(y))
        return [g1o(None if inf[i] else (fq.from_mont(int(xs[i])),
                                         fq.from_mont(int(ys[i]))))
                for i in range(len(xs))]

    def g2_list(pts):
        (x0, x1), (y0, y1), inf = pts
        c = [ftorch.np_to_ints(fq, np.asarray(a)) for a in (x0, x1, y0, y1)]
        return [g2o(None if inf[i] else
                    ((fq.from_mont(int(c[0][i])), fq.from_mont(int(c[1][i]))),
                     (fq.from_mont(int(c[2][i])), fq.from_mont(int(c[3][i])))))
                for i in range(len(c[0]))]

    co = zk.coeffs
    vals = ftorch.np_to_ints(fr, np.asarray(co["val"]))
    ccoefs = [{
        "matrix": int(co["m"][i]),
        "constraint": int(co["c"][i]),
        "signal": int(co["s"][i]),
        # stored value*R^2 -> plain (reference readFr2, zkey_utils.js:443-446)
        "value": str(fr.from_mont(fr.from_mont(int(vals[i])))),
    } for i in range(len(co["m"]))]

    # C is indexed from nPublic+1 in the reference's sparse JS array; JSON
    # renders the missing prefix as nulls (stringifyBigInts keeps them).
    c_list = [None] * (zk.n_public + 1) + g1_list(zk.c_points)

    return {
        "protocol": "groth16",
        "curve": zk.curve.name,
        "q": str(fq.p),
        "n8q": zk.n8q,
        "r": str(fr.p),
        "n8r": zk.n8r,
        "nVars": zk.n_vars,
        "nPublic": zk.n_public,
        "domainSize": zk.domain_size,
        "power": zk.power,
        "vk_alpha_1": g1o(zk.vk_alpha_1),
        "vk_beta_1": g1o(zk.vk_beta_1),
        "vk_beta_2": g2o(zk.vk_beta_2),
        "vk_gamma_2": g2o(zk.vk_gamma_2),
        "vk_delta_1": g1o(zk.vk_delta_1),
        "vk_delta_2": g2o(zk.vk_delta_2),
        "IC": [g1o(p) for p in zk.ic],
        "ccoefs": ccoefs,
        "A": g1_list(zk.a_points),
        "B1": g1_list(zk.b1_points),
        "B2": g2_list(zk.b2_points),
        "C": c_list,
        "hExps": g1_list(zk.h_points),
    }
