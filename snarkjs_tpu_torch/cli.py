"""Command-line interface mirroring the reference's command surface (port
of snarkjs_tpu/cli.py; reference cli.js:55-345 + src/clprocessor.js):
`python -m snarkjs_tpu_torch <cmd> ...`.

Commands accept the same positional arguments as snarkjs; dispatch is a
longest-prefix match over the registered command words with the same
aliases (ptau/powersoftau, g16, ...).  Every command that computes runs on
the card unless `--device=cpu` asks for the plain versions, and raises
without a card.  `wtns calculate` and the three `fullprove` commands take
`--vm=python` for the Python WASM VM (the C++ one is the default), as the
API's `vm` keyword does.
"""

from __future__ import annotations

import functools
import json
import sys

_VERBOSE = False


def _log():
    import logging

    logger = logging.getLogger("snarkjs_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[%(levelname)s]  %(message)s"))
        logger.addHandler(h)
    logger.setLevel(logging.DEBUG if _VERBOSE else logging.INFO)
    return logger


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_bytes(path, data):
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# powers of tau

def ptau_new(curve, power, out="powersoftau_0000.ptau", **kw):
    from .ceremony import ptau_ops
    from .curves import host_curve as hc

    ptau_ops.new_accumulator(hc.get_curve(curve), int(power)).save(out)
    return 0


def ptau_contribute(old, new, name="", entropy=None, device="cuda", **kw):
    from .ceremony import ptau_ops
    from .formats import ptau as ptau_fmt

    pt2, resp = ptau_ops.contribute(ptau_fmt.read_ptau(old), name=name,
                                    entropy=entropy, device=device)
    pt2.save(new)
    print(ptau_fmt.format_hash(resp, "Contribution Response Hash:"))
    return 0


def ptau_beacon(old, new, beacon_hash, num_iterations_exp, name="",
                device="cuda", **kw):
    from .ceremony import ptau_ops
    from .formats import ptau as ptau_fmt

    pt2, _ = ptau_ops.beacon(ptau_fmt.read_ptau(old),
                             ptau_ops.parse_beacon_hash(beacon_hash),
                             int(num_iterations_exp), name=name, device=device)
    pt2.save(new)
    return 0


def ptau_export_challenge(ptau_path, challenge="challenge", device="cuda", **kw):
    from .ceremony import ptau_ops
    from .formats import ptau as ptau_fmt

    _write_bytes(challenge, ptau_ops.export_challenge(
        ptau_fmt.read_ptau(ptau_path), device=device))
    return 0


def ptau_challenge_contribute(curve, challenge, response="response",
                              entropy=None, device="cuda", **kw):
    from .ceremony import ptau_ops
    from .curves import host_curve as hc

    _write_bytes(response, ptau_ops.challenge_contribute(
        hc.get_curve(curve), _read_bytes(challenge), entropy=entropy,
        device=device))
    return 0


def ptau_import_response(old, response, new, name="", device="cuda", **kw):
    from .ceremony import ptau_ops
    from .formats import ptau as ptau_fmt

    ptau_ops.import_response(ptau_fmt.read_ptau(old), _read_bytes(response),
                             name=name, device=device).save(new)
    return 0


def ptau_prepare_phase2(old, new, device="cuda", **kw):
    from .ceremony import ptau_ops
    from .formats import ptau as ptau_fmt

    ptau_ops.prepare_phase2(ptau_fmt.read_ptau(old), logger=_log(),
                            device=device).save(new)
    return 0


def ptau_convert(old, new, device="cuda", **kw):
    from .ceremony import ptau_ops
    from .formats import ptau as ptau_fmt

    ptau_ops.convert(ptau_fmt.read_ptau(old), device=device).save(new)
    return 0


def ptau_truncate(ptau_path, **kw):
    from .ceremony import ptau_ops
    from .formats import ptau as ptau_fmt

    pt = ptau_fmt.read_ptau(ptau_path)
    base = ptau_path[:-5] if ptau_path.endswith(".ptau") else ptau_path
    for p in range(1, pt.power):
        ptau_ops.truncate(pt, p).save(f"{base}_{p:02d}.ptau")
    return 0


def ptau_verify(ptau_path, device="cuda", **kw):
    from .ceremony import ptau_ops
    from .formats import ptau as ptau_fmt

    ok = ptau_ops.verify(ptau_fmt.read_ptau(ptau_path), logger=_log(),
                         device=device)
    print("Powers of Tau Ok!" if ok else "INVALID")
    return 0 if ok else 1


def ptau_export_json(ptau_path, out, **kw):
    from .ceremony import ptau_ops
    from .formats import ptau as ptau_fmt

    _write_json(out, ptau_ops.export_json(ptau_fmt.read_ptau(ptau_path)))
    return 0


# ---------------------------------------------------------------------------
# r1cs / wtns

def r1cs_info_cmd(r1cs_path="circuit.r1cs", **kw):
    from . import tools
    from .formats.r1cs import read_r1cs

    tools.r1cs_info(read_r1cs(r1cs_path), logger=_log())
    return 0


def r1cs_print_cmd(r1cs_path="circuit.r1cs", sym_path="circuit.sym", **kw):
    from . import tools
    from .formats.r1cs import read_r1cs

    syms = tools.load_syms(sym_path)
    for line in tools.r1cs_print(read_r1cs(r1cs_path), syms):
        print(line)
    return 0


def r1cs_export_json_cmd(r1cs_path="circuit.r1cs", out="circuit.json", **kw):
    from . import tools
    from .formats.r1cs import read_r1cs

    _write_json(out, tools.r1cs_export_json(read_r1cs(r1cs_path)))
    return 0


def wtns_calculate_cmd(wasm="circuit.wasm", input_json="input.json",
                       wtns_out="witness.wtns", vm="native", **kw):
    from .wasm.witness_calculator import calculate_wtns

    _write_bytes(wtns_out, calculate_wtns(_read_json(input_json), wasm, vm=vm))
    return 0


def wtns_debug_cmd(wasm="circuit.wasm", input_json="input.json",
                   wtns_out="witness.wtns", sym="circuit.sym", **kw):
    from . import tools

    _write_bytes(wtns_out, tools.wtns_debug(_read_json(input_json), wasm,
                                            sym_path=sym, logger=_log()))
    return 0


def wtns_export_json_cmd(wtns_path="witness.wtns", out="witness.json", **kw):
    from . import tools
    from .formats import wtns as wtns_fmt

    _write_json(out, tools.wtns_export_json(wtns_fmt.read_wtns(wtns_path)))
    return 0


def wtns_check_cmd(r1cs_path="circuit.r1cs", wtns_path="witness.wtns",
                   device="cuda", **kw):
    from . import tools
    from .formats import wtns as wtns_fmt
    from .formats.r1cs import read_r1cs

    ok = tools.wtns_check(read_r1cs(r1cs_path), wtns_fmt.read_wtns(wtns_path),
                          logger=_log(), device=device)
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# zkey (phase 2)

def zkey_contribute(old, new, name="", entropy=None, device="cuda", **kw):
    from .ceremony import zkey_mpc
    from .formats import ptau as ptau_fmt

    out, chash = zkey_mpc.contribute(_read_bytes(old), name=name,
                                     entropy=entropy, device=device)
    _write_bytes(new, out)
    print(ptau_fmt.format_hash(chash, "Contribution Hash:"))
    return 0


def zkey_beacon(old, new, beacon_hash, num_iterations_exp, name="",
                device="cuda", **kw):
    from .ceremony import ptau_ops, zkey_mpc

    out, _ = zkey_mpc.beacon(_read_bytes(old), ptau_ops.parse_beacon_hash(beacon_hash),
                             int(num_iterations_exp), name=name, device=device)
    _write_bytes(new, out)
    return 0


def zkey_verify_r1cs(r1cs_path, ptau_path, zkey_path, device="cuda", **kw):
    from .ceremony import zkey_mpc
    from .formats import ptau as ptau_fmt
    from .formats.r1cs import read_r1cs

    ok = zkey_mpc.verify_from_r1cs(read_r1cs(r1cs_path),
                                   ptau_fmt.read_ptau(ptau_path),
                                   _read_bytes(zkey_path), logger=_log(),
                                   device=device)
    print("ZKey Ok!" if ok else "INVALID")
    return 0 if ok else 1


def zkey_verify_init(init_path, ptau_path, zkey_path, device="cuda", **kw):
    from .ceremony import zkey_mpc
    from .formats import ptau as ptau_fmt

    ok = zkey_mpc.verify_from_init(_read_bytes(init_path),
                                   ptau_fmt.read_ptau(ptau_path),
                                   _read_bytes(zkey_path), logger=_log(),
                                   device=device)
    print("ZKey Ok!" if ok else "INVALID")
    return 0 if ok else 1


def zkey_export_bellman(zkey_path, mpc_path="circuit.mpcparams", device="cuda",
                        **kw):
    """reference cli.js:190 'zkey export bellman'."""
    from .ceremony import bellman

    _write_bytes(mpc_path, bellman.export_mpc_params(_read_bytes(zkey_path),
                                                     device=device))
    return 0


def zkey_import_bellman(old_zkey, mpc_path, new_zkey, name="", device="cuda",
                        **kw):
    """reference cli.js:204 'zkey import bellman'."""
    from .ceremony import bellman

    res = bellman.import_mpc_params(_read_bytes(old_zkey), _read_bytes(mpc_path),
                                    name=name, logger=_log(), device=device)
    if res is False:
        print("INVALID MPC params")
        return 1
    _write_bytes(new_zkey, res)
    return 0


def zkey_bellman_contribute(curve, mpc_in, mpc_out, entropy=None, device="cuda",
                            **kw):
    """reference cli.js:197 'zkey bellman contribute'."""
    from .ceremony import bellman
    from .curves import host_curve as hc
    from .formats import ptau as ptau_fmt

    out, chash = bellman.bellman_contribute(hc.get_curve(curve), _read_bytes(mpc_in),
                                            entropy=entropy, device=device)
    _write_bytes(mpc_out, out)
    print(ptau_fmt.format_hash(chash, "Contribution Hash:"))
    return 0


def _read_zkey_any(zkey_path):
    from .formats import zkey as zkey_fmt
    from .formats.binfile import BinFile

    bf = BinFile.load(zkey_path, "zkey")
    pid = zkey_fmt.read_header(bf)
    if pid == zkey_fmt.GROTH16_PROTOCOL_ID:
        return "groth16", zkey_fmt.read_groth16_zkey(zkey_path)
    if pid == zkey_fmt.PLONK_PROTOCOL_ID:
        return "plonk", zkey_fmt.read_plonk_zkey(zkey_path)
    if pid == zkey_fmt.FFLONK_PROTOCOL_ID:
        return "fflonk", zkey_fmt.read_fflonk_zkey(zkey_path)
    raise ValueError("zkey file protocol unrecognized")


def zkey_export_json(zkey_path="circuit.zkey", out="circuit.zkey.json", **kw):
    """Dump a Groth16 zkey as JSON (reference cli.js:238,
    src/zkey_export_json.js:1-11)."""
    from . import tools

    _write_json(out, tools.zkey_export_json(zkey_path))
    return 0


def zkey_export_verificationkey(zkey_path="circuit_final.zkey",
                                out="verification_key.json", **kw):
    proto, zk = _read_zkey_any(zkey_path)
    _write_json(out, _proto_module(proto).export_verification_key(zk))
    return 0


def zkey_export_solidityverifier(zkey_path="circuit_final.zkey",
                                 out="verifier.sol", **kw):
    from .export import solidity

    proto, zk = _read_zkey_any(zkey_path)
    vk = _proto_module(proto).export_verification_key(zk)
    with open(out, "w") as f:
        f.write(solidity.export_verifier(vk))
    return 0


def zkey_export_soliditycalldata(public_json="public.json",
                                 proof_json="proof.json", **kw):
    proof = _read_json(proof_json)
    publics = _read_json(public_json)
    print(_proto_module(proof["protocol"]).export_solidity_calldata(proof, publics))
    return 0


# ---------------------------------------------------------------------------
# protocols

def _proto_module(name):
    if name == "groth16":
        from .protocols import groth16 as m
    elif name == "plonk":
        from .protocols import plonk as m
    elif name == "fflonk":
        from .protocols import fflonk as m
    else:
        raise ValueError(f"unknown protocol {name}")
    return m


def groth16_setup(r1cs_path, ptau_path, zkey_out, device="cuda", **kw):
    from .formats import ptau as ptau_fmt
    from .formats.r1cs import read_r1cs
    from .protocols import groth16_setup as gs

    _write_bytes(zkey_out, gs.setup_from_ptau(
        read_r1cs(r1cs_path), ptau_fmt.read_ptau(ptau_path), logger=_log(),
        device=device))
    return 0


def plonk_setup_cmd(r1cs_path, ptau_path, zkey_out, device="cuda", **kw):
    from .formats import ptau as ptau_fmt
    from .formats.r1cs import read_r1cs
    from .protocols import plonk_setup as ps

    _write_bytes(zkey_out, ps.setup_from_ptau(
        read_r1cs(r1cs_path), ptau_fmt.read_ptau(ptau_path), device=device))
    return 0


def fflonk_setup_cmd(r1cs_path, ptau_path, zkey_out, device="cuda", **kw):
    from .formats import ptau as ptau_fmt
    from .formats.r1cs import read_r1cs
    from .protocols import fflonk_setup as fs

    _write_bytes(zkey_out, fs.setup_from_ptau(
        read_r1cs(r1cs_path), ptau_fmt.read_ptau(ptau_path), logger=_log(),
        device=device))
    return 0


def _rank_devices(devices, device):
    """--devices N -> one device per rank (cuda:0 .. cuda:N-1, or N CPU
    ranks with --device=cpu); None/1 -> one process, no mesh.  Raises
    before any rank starts when fewer cards are visible."""
    if not devices or int(devices) <= 1:
        return None
    import torch

    n = int(devices)
    if torch.device(device).type == "cpu":
        return ["cpu"] * n
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n:
        raise ValueError(f"--devices {n}: only {visible} devices visible")
    return [f"cuda:{r}" for r in range(n)]


def _prove_rank(rank, proto, zkey_path, wtns_path, proof_out, public_out):
    """One rank of `--devices N`: the prove over the mesh of all ranks;
    rank 0 alone writes the files."""
    from .parallel import distributed as pdist

    proof, publics = _proto_module(proto).prove_files(
        zkey_path, wtns_path, logger=_log(), device=pdist.device(),
        mesh=pdist.prover_mesh())
    if rank == 0:
        _write_json(proof_out, proof)
        _write_json(public_out, publics)


def _prove(proto, zkey_path, wtns_path, proof_out="proof.json",
           public_out="public.json", devices=None, device="cuda", **kw):
    """Prove with an existing zkey + witness; --devices N shards the
    MSMs/NTTs over N ranks (`parallel.distributed.spawn`: one process a
    device, joined within its time limit)."""
    ranks = _rank_devices(devices, device)
    if ranks is not None:
        from .parallel import distributed as pdist

        pdist.spawn(_prove_rank, len(ranks), args=(proto, zkey_path, wtns_path,
                                                   proof_out, public_out),
                    devices=ranks)
        return 0
    proof, publics = _proto_module(proto).prove_files(
        zkey_path, wtns_path, logger=_log(), device=device)
    _write_json(proof_out, proof)
    _write_json(public_out, publics)
    return 0


def _verify(proto, vk_json, public_json, proof_json, **kw):
    ok = _proto_module(proto).verify(_read_json(vk_json), _read_json(public_json),
                                     _read_json(proof_json), logger=_log())
    print("OK!" if ok else "INVALID proof")
    return 0 if ok else 1


def _fullprove(proto, input_json, wasm_path, zkey_path, proof_out,
               public_out, device="cuda", vm="native", **kw):
    """reference src/groth16_fullprove.js / plonk_fullprove.js /
    fflonk_full_prove.js: witness calc (in memory) + prove."""
    from .formats import wtns as wtns_fmt
    from .formats import zkey as zkey_fmt
    from .wasm.witness_calculator import calculate_wtns

    wtns_bytes = calculate_wtns(_read_json(input_json), wasm_path, vm=vm)
    read = {"groth16": zkey_fmt.read_groth16_zkey, "plonk": zkey_fmt.read_plonk_zkey,
            "fflonk": zkey_fmt.read_fflonk_zkey}[proto]
    proof, publics = _proto_module(proto).prove(
        read(zkey_path), wtns_fmt.read_wtns(wtns_bytes), device=device)
    _write_json(proof_out, proof)
    _write_json(public_out, publics)
    return 0


def file_info(path, **kw):
    """binfile inspector (reference cli.js:1265-1312)."""
    from .formats.binfile import BinFile

    bf = BinFile(_read_bytes(path))
    print(f"type: {bf.ftype}")
    print(f"version: {bf.version}")
    for stype in sorted(bf.sections):
        for idx, sec in enumerate(bf.sections[stype]):
            print(f"  section {stype}.{idx}: {sec.size} bytes at {sec.pos}")
    return 0


# ---------------------------------------------------------------------------
# dispatch table: (command words) -> handler

COMMANDS = [
    (("powersoftau", "new"), ptau_new),
    (("powersoftau", "contribute"), ptau_contribute),
    (("powersoftau", "export", "challenge"), ptau_export_challenge),
    (("powersoftau", "challenge", "contribute"), ptau_challenge_contribute),
    (("powersoftau", "import", "response"), ptau_import_response),
    (("powersoftau", "beacon"), ptau_beacon),
    (("powersoftau", "prepare", "phase2"), ptau_prepare_phase2),
    (("powersoftau", "convert"), ptau_convert),
    (("powersoftau", "truncate"), ptau_truncate),
    (("powersoftau", "verify"), ptau_verify),
    (("powersoftau", "export", "json"), ptau_export_json),
    (("r1cs", "info"), r1cs_info_cmd),
    (("r1cs", "print"), r1cs_print_cmd),
    (("r1cs", "export", "json"), r1cs_export_json_cmd),
    (("wtns", "calculate"), wtns_calculate_cmd),
    (("wtns", "debug"), wtns_debug_cmd),
    (("wtns", "export", "json"), wtns_export_json_cmd),
    (("wtns", "check"), wtns_check_cmd),
    (("zkey", "contribute"), zkey_contribute),
    (("zkey", "beacon"), zkey_beacon),
    (("zkey", "verify", "r1cs"), zkey_verify_r1cs),
    (("zkey", "export", "bellman"), zkey_export_bellman),
    (("zkey", "import", "bellman"), zkey_import_bellman),
    (("zkey", "bellman", "contribute"), zkey_bellman_contribute),
    (("zkey", "verify", "init"), zkey_verify_init),
    (("zkey", "verify"), zkey_verify_r1cs),
    (("zkey", "export", "json"), zkey_export_json),
    (("zkey", "export", "verificationkey"), zkey_export_verificationkey),
    (("zkey", "export", "solidityverifier"), zkey_export_solidityverifier),
    (("zkey", "export", "soliditycalldata"), zkey_export_soliditycalldata),
    (("groth16", "setup"), groth16_setup),
    (("groth16", "prove"), functools.partial(_prove, "groth16")),
    (("groth16", "fullprove"), functools.partial(_fullprove, "groth16")),
    (("groth16", "verify"), functools.partial(_verify, "groth16")),
    (("plonk", "setup"), plonk_setup_cmd),
    (("plonk", "prove"), functools.partial(_prove, "plonk")),
    (("plonk", "fullprove"), functools.partial(_fullprove, "plonk")),
    (("plonk", "verify"), functools.partial(_verify, "plonk")),
    (("fflonk", "setup"), fflonk_setup_cmd),
    (("fflonk", "prove"), functools.partial(_prove, "fflonk")),
    (("fflonk", "fullprove"), functools.partial(_fullprove, "fflonk")),
    (("fflonk", "verify"), functools.partial(_verify, "fflonk")),
    (("file", "info"), file_info),
]

ALIASES = {"ptau": "powersoftau", "g16": "groth16", "pt": "powersoftau",
           "zk": "zkey", "w": "wtns", "f": "file"}


def _unwrap(fn):
    while isinstance(fn, functools.partial):
        fn = fn.func
    return fn


def main(argv=None) -> int:
    import inspect

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    words = []
    for a in argv:
        if a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
                opts[k] = v
            else:
                opts[a[2:]] = True
        elif a in ("-v", "--verbose"):
            opts["verbose"] = True
        elif a.startswith("-e"):
            opts["entropy"] = a[2:] or True
        else:
            words.append(a)
    if words:
        words[0] = ALIASES.get(words[0], words[0])
    if not words:
        print("usage: python -m snarkjs_tpu_torch <command> ... "
              "(commands mirror iden3/snarkjs cli.js; --device=cpu runs the "
              "plain versions)")
        for cmd, _fn in COMMANDS:
            print("  " + " ".join(cmd))
        return 0
    if opts.get("help"):
        matches = [(cmd, fn) for cmd, fn in COMMANDS
                   if cmd[:len(words)] == tuple(words[:len(cmd)])]
        if not matches:
            print(f"unknown command: {' '.join(words)}", file=sys.stderr)
            return 1
        for cmd, fn in matches:
            target = _unwrap(fn)
            print(f"snarkjs_tpu_torch {' '.join(cmd)} {inspect.signature(target)}")
            doc = inspect.getdoc(target)
            if doc:
                print("  " + doc.splitlines()[0])
        return 0

    # longest-prefix match
    best = None
    for cmd, fn in COMMANDS:
        if tuple(words[:len(cmd)]) == cmd:
            if best is None or len(cmd) > len(best[0]):
                best = (cmd, fn)
    if best is None:
        print(f"unknown command: {' '.join(words)}", file=sys.stderr)
        return 1
    cmd, fn = best
    if opts.get("verbose"):
        global _VERBOSE
        _VERBOSE = True
    args = words[len(cmd):]
    # forward every --opt that names a parameter of the handler (reference
    # clprocessor.js:43-59 parses per-command option strings into argv)
    target = _unwrap(fn)
    sig = inspect.signature(fn)
    params = set(inspect.signature(target).parameters)
    kwargs = {}
    for k, v in opts.items():
        key = k.replace("-", "_")
        if key in params and key != "kw":
            kwargs[key] = v
    if "entropy" in opts and opts["entropy"] is not True:
        kwargs["entropy"] = opts["entropy"]
    # usage errors are detected by binding BEFORE the call, so a TypeError
    # raised inside a running command is a real error, not bad arguments
    try:
        sig.bind(*args, **kwargs)
    except TypeError as e:
        print(f"usage error: {' '.join(cmd)}: {e}", file=sys.stderr)
        doc = inspect.getdoc(target)
        if doc:
            print(doc.splitlines()[0], file=sys.stderr)
        print(f"  parameters: {sig}", file=sys.stderr)
        return 1
    return fn(*args, **kwargs) or 0
