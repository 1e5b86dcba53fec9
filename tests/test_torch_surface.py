"""The port's public surface against snarkjs_tpu's, and the last helpers.

- Every public top-level name of each snarkjs_tpu/ module, and every
  keyword of its public functions and of the public methods of its public
  classes, exists in the port's counterpart module, but for the by-design
  differences listed in BY_DESIGN with their reasons (read from the sources'
  syntax trees; nothing of either package is run).
- The provers' MSM keywords: each prover called with msm_c=4, msm_cw=8
  gives the JAX package's stored proof byte for byte (`msm_c` is read by
  the legacy Pippenger only; the window width does not change the sum), and
  `prove_files` and the API pass both keywords through.
- `ftorch.scalar_mul_small`, `np_from_bytes_le`, `np_to_bytes_le`,
  `FieldCtx.pinv` and `Blake2b.length_compressed` against the JAX functions
  on the same inputs (numpy seeds).  Tolerance: none; limbs, bytes and
  counts exactly.
"""

import ast
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from snarkjs_tpu.fields import fjnp
from snarkjs_tpu.utils import blake2b as jblake
from snarkjs_tpu_torch import api as tapi
from snarkjs_tpu_torch.fields import ftorch
from snarkjs_tpu_torch.protocols import fflonk, groth16, plonk
from snarkjs_tpu_torch.utils import blake2b as tblake
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")

# snarkjs_tpu module -> the port's module, where the name differs
COUNTERPART = {"fields/fjnp.py": "fields/ftorch.py", "fields/fpal.py": "fields/fcuda.py",
               "curves/msm_tpu.py": "curves/msm_gpu.py", "ntt/ntt_mxu.py": "ntt/ntt_mm.py"}

# (module, name or "function:keyword") -> why the port has no counterpart
BY_DESIGN = {
    ("fields/fjnp.py", "U32"): "the port's limbs are int32 tensors (ftorch.DTYPE)",
    ("fields/fjnp.py", "UNROLL_LIMBS"): "an XLA unrolling knob; PyTorch runs eagerly",
    ("fields/fpal.py", "LANE"): "the TPU's 128-lane tiling",
    ("fields/fpal.py", "U32"): "the port's limbs are int32 tensors",
    ("fields/fpal.py", "PalField"): "the Pallas field class; K-field is fcuda.launch",
    ("fields/fpal.py", "KernelField"): "a Pallas field class; K-field is fcuda.launch",
    ("fields/fpal.py", "KernelField2"): "a Pallas field class; K-field is fcuda.launch",
    ("fields/fpal.py", "get_pal"): "returns a Pallas class; ftorch dispatches by device",
    ("curves/msm_tpu.py", "U32"): "the port's limbs are int32 tensors",
    ("curves/msm_tpu.py", "SB"): "the TPU's sublane block",
    ("curves/msm_tpu.py", "R_LANES"): "the TPU's lane count; msm_gpu._lanes fills the SMs",
    ("curves/msm_tpu.py", "NB"): "the bucket count is GpuMSM.nb, per window width",
    ("curves/msm_tpu.py", "TpuMSM"): "its counterpart is msm_gpu.GpuMSM",
    ("curves/msm.py", "segmented_msm:R"): "the port picks its lanes from the batch",
    ("ntt/ntt_mxu.py", "I8"): "a dtype alias",
    ("ntt/ntt_mxu.py", "I32"): "a dtype alias",
    ("ntt/ntt_mxu.py", "U32"): "a dtype alias",
    ("parallel/sharded.py", "shard_map"): "JAX's primitive; the port runs SPMD over "
                                          "torch.distributed",
    ("parallel/distributed.py", "init:coordinator_address"):
        "jax.distributed's rendezvous; the port's init takes url, world_size, rank",
    ("parallel/distributed.py", "init:num_processes"): "as coordinator_address",
    ("parallel/distributed.py", "init:process_id"): "as coordinator_address",
    ("utils/blake2b.py", "MASK64"): "the compression is host C++ (csrc/blake2b.cpp)",
    ("utils/blake2b.py", "SIGMA"): "the compression is host C++ (csrc/blake2b.cpp)",
    ("wasm/native.py", "available"): "reads SNARKJS_NO_NATIVE_WASM; the port picks its "
                                     "VM by vm= and reads no switch",
}


def _args(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs], a.kwarg is not None


def _surface(path):
    """{public name: ("def", (args, **kw)) | ("class", {method: (args, **kw)})
    | ("var", None)} of a module's top level."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("def", _args(node))
        elif isinstance(node, ast.ClassDef):
            out[node.name] = ("class", {
                m.name: _args(m) for m in node.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                and (m.name == "__init__" or not m.name.startswith("_"))})
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                if isinstance(t, ast.Name):
                    out[t.id] = ("var", None)
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _missing_keywords(jax_fn, port_fn):
    (jargs, _), (targs, tkw) = jax_fn, port_fn
    return [] if tkw else [a for a in jargs if a not in targs]


def _gaps():
    """Every (module, name) of snarkjs_tpu/ that its counterpart lacks;
    keywords as "function:keyword" or "Class.method:keyword"."""
    gaps = []
    jroot = os.path.join(ROOT, "snarkjs_tpu")
    for base, _, files in os.walk(jroot):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(base, fn), jroot).replace(os.sep, "/")
            port = os.path.join(ROOT, "snarkjs_tpu_torch", COUNTERPART.get(rel, rel))
            if not os.path.exists(port):
                gaps.append((rel, "<module>"))
                continue
            theirs, ours = _surface(os.path.join(base, fn)), _surface(port)
            for name, (kind, info) in theirs.items():
                if name not in ours or ours[name][0] != kind:
                    gaps.append((rel, name))
                elif kind == "def":
                    gaps += [(rel, f"{name}:{k}")
                             for k in _missing_keywords(info, ours[name][1])]
                elif kind == "class":
                    for meth, sig in info.items():
                        if meth not in ours[name][1]:
                            gaps.append((rel, f"{name}.{meth}"))
                        else:
                            gaps += [(rel, f"{name}.{meth}:{k}") for k in
                                     _missing_keywords(sig, ours[name][1][meth])]
    return gaps


def test_public_surface_matches_but_by_design():
    gaps = _gaps()
    assert [g for g in gaps if g not in BY_DESIGN] == []
    # an entry of the list that no longer differs goes too
    assert sorted(set(BY_DESIGN) - set(gaps)) == []


def test_surface_finds_a_missing_method_and_keyword(tmp_path):
    """The extraction sees methods and keywords, not only top-level names."""
    a, b = tmp_path / "a.py", tmp_path / "b.py"
    a.write_text("class C:\n    def pinv(self, x): pass\ndef f(x, msm_c=8): pass\n")
    b.write_text("class C:\n    def p(self, x): pass\ndef f(x): pass\n")
    theirs, ours = _surface(str(a)), _surface(str(b))
    assert "pinv" in theirs["C"][1] and "pinv" not in ours["C"][1]
    assert _missing_keywords(theirs["f"][1], ours["f"][1]) == ["msm_c"]


# ------------------------------------------------- the provers' MSM keywords

PROOFS = {   # stored JAX proof -> (the port's prover, its blinders, route, MSMs)
    "tiny_bn128": (groth16, ("r", "s"), "prove_files", 5),
    "tiny_plonk_bn128": (plonk, ("b",), "api", 9),
    "tiny_plonk_bls12381": (plonk, ("b",), "prove_files", 9),
    "tiny_fflonk_bn128": (fflonk, ("b",), "api", 4),
}
API = {groth16: tapi.groth16, plonk: tapi.plonk, fflonk: tapi.fflonk}


@pytest.mark.parametrize("stem", sorted(PROOFS))
def test_prover_with_msm_keywords_gives_stored_jax_proof(monkeypatch, stem):
    """Every MSM of the prove gets c=4, cw=8, and the proof is the stored one."""
    from snarkjs_tpu_torch.curves import msm as msm_mod

    mod, blinders, route, n_msm = PROOFS[stem]
    calls = []
    run = msm_mod.MSMContext.run

    def spy(self, *a, **kw):
        calls.append((kw.get("c"), kw.get("cw")))
        return run(self, *a, **kw)

    monkeypatch.setattr(msm_mod.MSMContext, "run", spy)
    with open(os.path.join(FIXTURES, f"{stem}_proof.json")) as f:
        want = json.load(f)
    zk, wt = (os.path.join(FIXTURES, f"{stem}.{ext}") for ext in ("zkey", "wtns"))
    fn = mod.prove_files if route == "prove_files" else API[mod].prove
    proof, publics = fn(zk, wt, device="cpu", msm_c=4, msm_cw=8,
                        **{k: want[k] for k in blinders})
    assert json.dumps(proof) == json.dumps(want["proof"])
    assert publics == want["publicSignals"]
    assert calls == [(4, 8)] * n_msm


@pytest.mark.parametrize("mod", [groth16, plonk, fflonk], ids=["groth16", "plonk", "fflonk"])
@pytest.mark.parametrize("route", ["prove_files", "api"])
def test_msm_keywords_reach_the_prover(monkeypatch, mod, route):
    seen = {}
    monkeypatch.setattr(mod, "prove", lambda zk, w, **kw: seen.update(kw) or ("p", "w"))
    stem = {groth16: "tiny_bn128", plonk: "tiny_plonk_bn128", fflonk: "tiny_fflonk_bn128"}[mod]
    zk, wt = (os.path.join(FIXTURES, f"{stem}.{ext}") for ext in ("zkey", "wtns"))
    fn = mod.prove_files if route == "prove_files" else API[mod].prove
    assert fn(zk, wt, msm_c=4, msm_cw=8, device="cpu") == ("p", "w")
    assert seen == {"msm_c": 4, "msm_cw": 8, "device": "cpu"}


# ------------------------------------------------------- the last helpers

def _limbs(fp, seed, n=13):
    rng = np.random.default_rng(seed)
    vals = [0, 1, fp.p - 1] + [int.from_bytes(rng.bytes(fp.n8), "little") % fp.p
                               for _ in range(n - 3)]
    return ftorch.np_from_ints(fp, vals)


@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fq"])
def test_scalar_mul_small_equals_jax(name):
    cj, ct = fjnp.get_ctx(name), ftorch.get_ctx(name)
    a = _limbs(ct.fp, 3)
    for k in range(16):
        want = np.asarray(fjnp.scalar_mul_small(cj, jnp.asarray(a), k))
        got = ftorch.to_numpy(ftorch.scalar_mul_small(ct, ftorch.to_tensor(a, "cpu"), k))
        assert np.array_equal(got, want), k
        assert ftorch.np_to_ints(ct.fp, got) == [v * k % ct.fp.p
                                                for v in ftorch.np_to_ints(ct.fp, a)]
    with pytest.raises(ValueError):
        ftorch.scalar_mul_small(ct, ftorch.to_tensor(a, "cpu"), 16)


@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fq"])
def test_bytes_le_equal_jax_and_round_trip(name):
    fp = ftorch.get_ctx(name).fp
    n = 9
    data = np.random.default_rng(11).bytes(n * fp.n8)
    got = ftorch.np_from_bytes_le(fp, data + b"tail", n)
    want = fjnp.np_from_bytes_le(fp, data + b"tail", n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert ftorch.np_to_bytes_le(fp, got) == fjnp.np_to_bytes_le(fp, want) == data
    assert ftorch.np_to_bytes_le(fp, ftorch.to_tensor(got, "cpu")) == data
    shaped = got.reshape(fp.nl, 3, 3)
    assert ftorch.np_to_bytes_le(fp, shaped) == fjnp.np_to_bytes_le(fp, shaped) == data
    one = got[:, 0]
    assert ftorch.np_to_bytes_le(fp, one) == fjnp.np_to_bytes_le(fp, one) == data[:fp.n8]


@pytest.mark.parametrize("name", ["bn254_fr", "bn254_fq", "bls12_381_fr", "bls12_381_fq"])
def test_field_ctx_pinv_equals_jax(name):
    cj, ct = fjnp.get_ctx(name), ftorch.get_ctx(name)
    x = _limbs(ct.fp, 5, 4).reshape(ct.nl, 2, 2)
    want = np.asarray(cj.pinv(jnp.asarray(x)))
    got = ct.pinv(ftorch.to_tensor(x, "cpu"))
    assert got.shape == ct.p(ftorch.to_tensor(x, "cpu")).shape == want.shape
    assert np.array_equal(ftorch.to_numpy(got), want)
    R = 1 << (16 * ct.nl)
    assert ftorch.np_to_ints(ct.fp, got.reshape(ct.nl, -1)[:, :1])[0] == (
        -pow(ct.fp.p, -1, R)) % R


@pytest.mark.parametrize("size", [0, 1, 127, 128, 129, 256, 257, 1000])
def test_blake2b_length_compressed_equals_jax(size):
    data = np.random.default_rng(size).bytes(size)
    hj, ht = jblake.Blake2b(), tblake.Blake2b()
    assert ht.length_compressed() == hj.length_compressed() == 0
    hj.update(data)
    ht.update(data)
    assert ht.length_compressed() == hj.length_compressed()
    assert ht.digest() == hj.digest() == hashlib.blake2b(data).digest()
    assert ht.length_compressed() == hj.length_compressed()   # digest works on a copy
    for part in (data[:size // 3], data[size // 3:], b"x" * 128):  # a sequence of updates
        hj.update(part)
        ht.update(part)
        assert ht.length_compressed() == hj.length_compressed()
    back = tblake.Blake2b.from_partial(ht.to_partial())
    assert back.length_compressed() == ht.length_compressed()
