"""Public API facade mirroring snarkjs' exported namespaces (port of
snarkjs_tpu/api.py; reference main.js:1-8, src/groth16.js:20-23,
src/plonk.js, src/fflonk.js, src/powersoftau.js:20-30, src/zkey.js:21-31,
src/wtns.js, src/r1cs.js).

Each namespace exposes the same operations as the reference module, taking
file paths (like the CLI) or already-parsed objects.  Both snake_case and
the reference's camelCase names are provided.  Every call that computes
takes the port's keywords through `**kw`: `device` (None means the card;
"cpu" runs the plain versions), and `vm` ("native" or "python") where a
witness is calculated.
"""

from __future__ import annotations

import json


class _NS:
    """Namespace that aliases camelCase -> snake_case lazily."""

    def __getattr__(self, name):
        # camelCase fallback: fullProve -> full_prove
        snake = "".join(
            "_" + c.lower() if c.isupper() else c for c in name)
        if snake != name and hasattr(self, snake):
            return getattr(self, snake)
        raise AttributeError(name)


def _load_json(obj):
    if isinstance(obj, str):
        with open(obj) as f:
            return json.load(f)
    return obj


def _load_bytes(obj):
    if isinstance(obj, str):
        with open(obj, "rb") as f:
            return f.read()
    return obj


def _wtns_of(input_map, wasm, kw) -> bytes:
    """The witness of a full prove; `vm` leaves kw, the rest goes on."""
    from .wasm.witness_calculator import calculate_wtns

    return calculate_wtns(_load_json(input_map), wasm, vm=kw.pop("vm", "native"))


class _Groth16(_NS):
    @staticmethod
    def prove(zkey, wtns, **kw):
        from .formats import wtns as wtns_fmt
        from .formats import zkey as zkey_fmt
        from .protocols import groth16

        if isinstance(zkey, (str, bytes)):
            zkey = zkey_fmt.read_groth16_zkey(zkey)
        if isinstance(wtns, (str, bytes)):
            wtns = wtns_fmt.read_wtns(wtns)
        return groth16.prove(zkey, wtns, **kw)

    @staticmethod
    def full_prove(input_map, wasm, zkey, **kw):
        return _Groth16.prove(zkey, _wtns_of(input_map, wasm, kw), **kw)

    @staticmethod
    def verify(vk, publics, proof, logger=None):
        from .protocols import groth16

        return groth16.verify(_load_json(vk), _load_json(publics),
                              _load_json(proof), logger=logger)

    @staticmethod
    def export_solidity_call_data(proof, publics):
        from .protocols import groth16

        return groth16.export_solidity_calldata(
            _load_json(proof), _load_json(publics))


class _Plonk(_NS):
    @staticmethod
    def setup(r1cs, ptau, **kw):
        from .formats import ptau as ptau_fmt
        from .formats.r1cs import read_r1cs
        from .protocols import plonk_setup

        if isinstance(r1cs, (str, bytes)):
            r1cs = read_r1cs(r1cs)
        if isinstance(ptau, (str, bytes)):
            ptau = ptau_fmt.read_ptau(ptau)
        return plonk_setup.setup_from_ptau(r1cs, ptau, **kw)

    @staticmethod
    def prove(zkey, wtns, **kw):
        from .formats import wtns as wtns_fmt
        from .formats import zkey as zkey_fmt
        from .protocols import plonk

        if isinstance(zkey, (str, bytes)):
            zkey = zkey_fmt.read_plonk_zkey(zkey)
        if isinstance(wtns, (str, bytes)):
            wtns = wtns_fmt.read_wtns(wtns)
        return plonk.prove(zkey, wtns, **kw)

    @staticmethod
    def full_prove(input_map, wasm, zkey, **kw):
        return _Plonk.prove(zkey, _wtns_of(input_map, wasm, kw), **kw)

    @staticmethod
    def verify(vk, publics, proof, logger=None):
        from .protocols import plonk

        return plonk.verify(_load_json(vk), _load_json(publics),
                            _load_json(proof), logger=logger)

    @staticmethod
    def export_solidity_call_data(proof, publics):
        from .protocols import plonk

        return plonk.export_solidity_calldata(
            _load_json(proof), _load_json(publics))


class _Fflonk(_NS):
    @staticmethod
    def setup(r1cs, ptau, **kw):
        from .formats import ptau as ptau_fmt
        from .formats.r1cs import read_r1cs
        from .protocols import fflonk_setup

        if isinstance(r1cs, (str, bytes)):
            r1cs = read_r1cs(r1cs)
        if isinstance(ptau, (str, bytes)):
            ptau = ptau_fmt.read_ptau(ptau)
        return fflonk_setup.setup_from_ptau(r1cs, ptau, **kw)

    @staticmethod
    def prove(zkey, wtns, **kw):
        from .formats import wtns as wtns_fmt
        from .formats import zkey as zkey_fmt
        from .protocols import fflonk

        if isinstance(zkey, (str, bytes)):
            zkey = zkey_fmt.read_fflonk_zkey(zkey)
        if isinstance(wtns, (str, bytes)):
            wtns = wtns_fmt.read_wtns(wtns)
        return fflonk.prove(zkey, wtns, **kw)

    @staticmethod
    def full_prove(input_map, wasm, zkey, **kw):
        return _Fflonk.prove(zkey, _wtns_of(input_map, wasm, kw), **kw)

    @staticmethod
    def verify(vk, publics, proof, logger=None):
        from .protocols import fflonk

        return fflonk.verify(_load_json(vk), _load_json(publics),
                             _load_json(proof), logger=logger)

    @staticmethod
    def export_solidity_call_data(proof, publics):
        from .protocols import fflonk

        return fflonk.export_solidity_calldata(
            _load_json(proof), _load_json(publics))


def _ptau(ptau):
    from .formats import ptau as ptau_fmt

    return ptau_fmt.read_ptau(ptau) if isinstance(ptau, (str, bytes)) else ptau


class _PowersOfTau(_NS):
    @staticmethod
    def new_accumulator(curve, power, filename=None):
        from .ceremony import ptau_ops
        from .curves import host_curve as hc

        if isinstance(curve, str):
            curve = hc.get_curve(curve)
        pt = ptau_ops.new_accumulator(curve, int(power))
        if filename:
            pt.save(filename)
        return pt

    @staticmethod
    def contribute(old, new=None, **kw):
        from .ceremony import ptau_ops

        out, _chash = ptau_ops.contribute(_ptau(old), **kw)
        if new:
            out.save(new)
        return out

    @staticmethod
    def beacon(old, beacon_hash, num_iterations_exp, new=None, **kw):
        from .ceremony import ptau_ops

        if isinstance(beacon_hash, str):
            beacon_hash = ptau_ops.parse_beacon_hash(beacon_hash)
        out, _chash = ptau_ops.beacon(_ptau(old), beacon_hash,
                                      int(num_iterations_exp), **kw)
        if new:
            out.save(new)
        return out

    @staticmethod
    def prepare_phase2(old, new=None, logger=None, **kw):
        from .ceremony import ptau_ops

        out = ptau_ops.prepare_phase2(_ptau(old), logger=logger, **kw)
        if new:
            out.save(new)
        return out

    @staticmethod
    def verify(ptau, logger=None, **kw):
        from .ceremony import ptau_ops

        return ptau_ops.verify(_ptau(ptau), logger=logger, **kw)

    @staticmethod
    def truncate(ptau, power, logger=None):
        from .ceremony import ptau_ops

        return ptau_ops.truncate(_ptau(ptau), power)

    @staticmethod
    def export_challenge(ptau, out=None, **kw):
        from .ceremony import ptau_ops

        data = ptau_ops.export_challenge(_ptau(ptau), **kw)
        if out:
            with open(out, "wb") as f:
                f.write(data)
        return data

    @staticmethod
    def challenge_contribute(curve, challenge, response=None, **kw):
        from .ceremony import ptau_ops
        from .curves import host_curve as hc

        if isinstance(curve, str):
            curve = hc.get_curve(curve)
        data = ptau_ops.challenge_contribute(curve, _load_bytes(challenge), **kw)
        if response:
            with open(response, "wb") as f:
                f.write(data)
        return data

    @staticmethod
    def import_response(old, response, new=None, **kw):
        from .ceremony import ptau_ops

        out = ptau_ops.import_response(_ptau(old), _load_bytes(response), **kw)
        if new:
            out.save(new)
        return out

    @staticmethod
    def convert(old, new=None, logger=None, **kw):
        from .ceremony import ptau_ops

        out = ptau_ops.convert(_ptau(old), logger=logger, **kw)
        if new:
            out.save(new)
        return out

    @staticmethod
    def export_json(ptau, logger=None):
        from .ceremony import ptau_ops

        return ptau_ops.export_json(_ptau(ptau))


def _r1cs(r1cs):
    from .formats.r1cs import read_r1cs

    return read_r1cs(r1cs) if isinstance(r1cs, (str, bytes)) else r1cs


class _Zkey(_NS):
    @staticmethod
    def new_zkey(r1cs, ptau, zkey_path=None, logger=None, **kw):
        from .protocols import groth16_setup

        data = groth16_setup.setup_from_ptau(_r1cs(r1cs), _ptau(ptau),
                                             logger=logger, **kw)
        if zkey_path:
            with open(zkey_path, "wb") as f:
                f.write(data)
        return data

    @staticmethod
    def contribute(old, new=None, name="", entropy=None, logger=None, **kw):
        from .ceremony import zkey_mpc

        data, _chash = zkey_mpc.contribute(_load_bytes(old), name=name,
                                           entropy=entropy, **kw)
        if new:
            with open(new, "wb") as f:
                f.write(data)
        return data

    @staticmethod
    def beacon(old, beacon_hash, num_iterations_exp=10, new=None, name="",
               logger=None, **kw):
        from .ceremony import ptau_ops, zkey_mpc

        if isinstance(beacon_hash, str):
            beacon_hash = ptau_ops.parse_beacon_hash(beacon_hash)
        data, _chash = zkey_mpc.beacon(_load_bytes(old), beacon_hash,
                                       int(num_iterations_exp), name=name, **kw)
        if new:
            with open(new, "wb") as f:
                f.write(data)
        return data

    @staticmethod
    def verify_from_r1cs(r1cs, ptau, zkey, logger=None, **kw):
        from .ceremony import zkey_mpc

        return zkey_mpc.verify_from_r1cs(_r1cs(r1cs), _ptau(ptau),
                                         _load_bytes(zkey), logger=logger, **kw)

    @staticmethod
    def verify_from_init(init_zkey, ptau, zkey, logger=None, **kw):
        from .ceremony import zkey_mpc

        return zkey_mpc.verify_from_init(_load_bytes(init_zkey), _ptau(ptau),
                                         _load_bytes(zkey), logger=logger, **kw)

    @staticmethod
    def export_verification_key(zkey, out=None):
        from .formats import zkey as zkey_fmt
        from .protocols import fflonk, groth16, plonk

        proto = zkey_fmt.zkey_protocol(zkey)
        if proto == "groth16":
            vk = groth16.export_verification_key(
                zkey_fmt.read_groth16_zkey(zkey))
        elif proto == "plonk":
            vk = plonk.export_verification_key(zkey_fmt.read_plonk_zkey(zkey))
        else:
            vk = fflonk.export_verification_key(
                zkey_fmt.read_fflonk_zkey(zkey))
        if out:
            with open(out, "w") as f:
                json.dump(vk, f, indent=1)
        return vk

    @staticmethod
    def export_solidity_verifier(zkey, out=None):
        from .export import solidity

        vk = _Zkey.export_verification_key(zkey)
        src = solidity.export_verifier(vk)
        if out:
            with open(out, "w") as f:
                f.write(src)
        return src


class _Wtns(_NS):
    @staticmethod
    def calculate(input_map, wasm, wtns_path=None, **kw):
        from .wasm.witness_calculator import calculate_wtns

        data = calculate_wtns(_load_json(input_map), wasm, **kw)
        if wtns_path:
            with open(wtns_path, "wb") as f:
                f.write(data)
        return data

    @staticmethod
    def check(r1cs, wtns, logger=None, **kw):
        from . import tools
        from .formats import wtns as wtns_fmt

        if isinstance(wtns, (str, bytes)):
            wtns = wtns_fmt.read_wtns(wtns)
        return tools.wtns_check(_r1cs(r1cs), wtns, logger=logger, **kw)

    @staticmethod
    def debug(input_map, wasm, sym=None, logger=None, **kw):
        from . import tools

        return tools.wtns_debug(_load_json(input_map), wasm, sym_path=sym,
                                logger=logger, **kw)

    @staticmethod
    def export_json(wtns):
        from . import tools
        from .formats import wtns as wtns_fmt

        if isinstance(wtns, (str, bytes)):
            wtns = wtns_fmt.read_wtns(wtns)
        return tools.wtns_export_json(wtns)


class _R1cs(_NS):
    @staticmethod
    def info(r1cs, logger=None):
        from . import tools

        return tools.r1cs_info(_r1cs(r1cs), logger=logger)

    @staticmethod
    def print_constraints(r1cs, sym, logger=None):
        from . import tools

        return tools.r1cs_print(_r1cs(r1cs), tools.load_syms(sym), logger=logger)

    @staticmethod
    def export_json(r1cs):
        from . import tools

        return tools.r1cs_export_json(_r1cs(r1cs))


groth16 = _Groth16()
plonk = _Plonk()
fflonk = _Fflonk()
powersOfTau = _PowersOfTau()
powers_of_tau = powersOfTau
zKey = _Zkey()
zkey = zKey
wtns = _Wtns()
r1cs = _R1cs()
