"""snarkjs_tpu_torch's Solidity verifier export (`export/solidity.py`)
against snarkjs_tpu on the CPU.  Tolerance: none; the rendered contracts
are string-equal.

Each key under snarkjs_tpu_torch/fixtures/ gives its verification key
through each package's own `export_verification_key`, and each package
renders its own; the Groth16 case also renders the key that phase 2
(contribute -> beacon, tests/_torch_phase2.py) leaves, whose delta is no
longer the generator.
"""

import re

import pytest

from snarkjs_tpu.export import solidity as JS
from snarkjs_tpu.formats import zkey as jzkey
from snarkjs_tpu.protocols import fflonk as jff
from snarkjs_tpu.protocols import groth16 as jg
from snarkjs_tpu.protocols import plonk as jp
from snarkjs_tpu_torch.ceremony import zkey_mpc as T
from snarkjs_tpu_torch.export import solidity as TS
from snarkjs_tpu_torch.formats import zkey as tzkey
from snarkjs_tpu_torch.protocols import fflonk as tff
from snarkjs_tpu_torch.protocols import groth16 as tg
from snarkjs_tpu_torch.protocols import plonk as tp
from snarkjs_tpu_torch.utils.chacha import ChaCha
from tests import _torch_phase2 as p2
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

PROTOCOLS = {
    "groth16": (jzkey.read_groth16_zkey, jg, tzkey.read_groth16_zkey, tg),
    "plonk": (jzkey.read_plonk_zkey, jp, tzkey.read_plonk_zkey, tp),
    "fflonk": (jzkey.read_fflonk_zkey, jff, tzkey.read_fflonk_zkey, tff),
}
KEYS = [("groth16", "tiny_bn128.zkey"), ("plonk", "tiny_plonk_bn128.zkey"),
        ("plonk", "tiny_plonk_bls12381.zkey"), ("fflonk", "tiny_fflonk_bn128.zkey"),
        ("fflonk", "tiny_fflonk_adds_bn128.zkey")]


def _vks(protocol, data):
    jread, jmod, tread, tmod = PROTOCOLS[protocol]
    return jmod.export_verification_key(jread(data)), tmod.export_verification_key(tread(data))


def _constants(src) -> dict:
    return dict(re.findall(r"constant (\w+) = (\d+);", src))


@pytest.mark.parametrize("protocol,name", KEYS)
def test_render_equals_jax(protocol, name):
    jvk, tvk = _vks(protocol, p2.fixture(name))
    got = TS.export_verifier(tvk)
    assert got == JS.export_verifier(jvk)
    assert got == getattr(TS, f"export_{protocol}_verifier")(tvk)
    assert not re.findall(r"\{[a-zA-Z_]+\}", got)


def test_phase2_key_render_embeds_its_constants():
    """The Groth16 key after a contribution and a beacon: the render equals
    the JAX package's and embeds the key's delta and IC points."""
    final = p2.chain(T, ChaCha, p2.fixture(p2.CASES["bn128_d8"][0]), device="cpu")[-1][0]
    jvk, tvk = _vks("groth16", final)
    got = TS.export_verifier(tvk)
    assert got == JS.export_verifier(jvk)
    consts = _constants(got)
    (dx1, dx2), (dy1, dy2) = tvk["vk_delta_2"][0], tvk["vk_delta_2"][1]
    assert [consts[k] for k in ("deltax1", "deltax2", "deltay1", "deltay2")] == \
        [dx1, dx2, dy1, dy2]
    assert tvk["vk_delta_2"] != tg.export_verification_key(
        tzkey.read_groth16_zkey(p2.fixture(p2.CASES["bn128_d8"][0])))["vk_delta_2"]
    for i, ic in enumerate(tvk["IC"]):
        assert (consts[f"IC{i}x"], consts[f"IC{i}y"]) == (ic[0], ic[1])


def test_unknown_protocol_raises_as_jax():
    for mod in (JS, TS):
        with pytest.raises(NotImplementedError, match="for marlin is not implemented"):
            mod.export_verifier({"protocol": "marlin"})


def test_templates_equal_jax():
    for name in ("_GROTH16_TEMPLATE", "_PLONK_TEMPLATE", "_FFLONK_TEMPLATE"):
        assert getattr(TS, name) == getattr(JS, name), name
