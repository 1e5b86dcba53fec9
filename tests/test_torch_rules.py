"""Rules of the snarkjs_tpu_torch port: no JAX, no snarkjs_tpu, the card by
default.  Also the kernel tests that need an NVIDIA card (marker `cuda`):
they skip here and run on the card with `python -m pytest --noconftest
-m cuda tests/test_torch_rules.py` (this file imports no jax)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from snarkjs_tpu_torch import device as devmod
from snarkjs_tpu_torch.fields import ftorch
from snarkjs_tpu_torch.protocols import groth16_setup as g16setup
from snarkjs_tpu_torch.protocols import plonk_setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, sys
{imports}
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "snarkjs_tpu" or m.startswith("snarkjs_tpu.")]
print("BAD", bad)
"""

PORT_MODULES = [
    "snarkjs_tpu_torch", "snarkjs_tpu_torch.protocols.groth16",
    "snarkjs_tpu_torch.convert", "snarkjs_tpu_torch.ntt.ntt_mm",
    "snarkjs_tpu_torch.curves.msm_gpu", "snarkjs_tpu_torch.fields.fcuda",
    "snarkjs_tpu_torch._build", "snarkjs_tpu_torch.protocols.plonk",
    "snarkjs_tpu_torch.protocols.plonk_setup",
    "snarkjs_tpu_torch.protocols.groth16_setup", "snarkjs_tpu_torch.poly.fops",
    "snarkjs_tpu_torch.utils.keccak", "snarkjs_tpu_torch.formats.r1cs",
    "snarkjs_tpu_torch.formats.zkey", "snarkjs_tpu_torch.ntt.ntt",
    "snarkjs_tpu_torch.curves.gops", "snarkjs_tpu_torch.curves.jac",
    "snarkjs_tpu_torch.curves.msm", "snarkjs_tpu_torch.formats.ptau",
    "snarkjs_tpu_torch.utils.blake2b", "snarkjs_tpu_torch.ceremony.ptau_ops",
    "snarkjs_tpu_torch.protocols.fflonk", "snarkjs_tpu_torch.protocols.fflonk_setup",
    "snarkjs_tpu_torch.ceremony.keypair", "snarkjs_tpu_torch.utils.chacha",
    "snarkjs_tpu_torch.utils.spool", "snarkjs_tpu_torch.ceremony.zkey_mpc",
    "snarkjs_tpu_torch.ceremony.bellman", "snarkjs_tpu_torch.export.solidity",
    "snarkjs_tpu_torch.wasm.interp", "snarkjs_tpu_torch.wasm.native",
    "snarkjs_tpu_torch.wasm.witness_calculator", "snarkjs_tpu_torch.tools",
    "snarkjs_tpu_torch.api", "snarkjs_tpu_torch.cli", "snarkjs_tpu_torch.__main__",
]


def test_rule_covers_every_module_of_the_port():
    """Every .py file of the package is imported by the rule above, by name or
    by a listed module that imports it."""
    pkg = os.path.join(ROOT, "snarkjs_tpu_torch")
    names = []
    for base, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py") and fn != "__init__.py":
                rel = os.path.relpath(os.path.join(base, fn), ROOT)
                names.append(rel[:-3].replace(os.sep, "."))
    imports = "\n".join(f"importlib.import_module({m!r})" for m in PORT_MODULES)
    out = subprocess.run(
        [sys.executable, "-c", "import importlib, sys\n" + imports
         + "\nprint([m for m in %r if m not in sys.modules])" % names],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _bad_modules(imports: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _CHECK.format(imports=imports)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_port_imports_no_jax_and_no_snarkjs_tpu():
    imports = "\n".join(f"importlib.import_module({m!r})" for m in PORT_MODULES)
    assert _bad_modules(imports) == "BAD []"


def test_chip_smoke_imports_no_jax_and_no_snarkjs_tpu():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    lines = [ln for ln in src.splitlines()
             if ln.startswith(("import ", "from ")) and "__future__" not in ln]
    assert any("snarkjs_tpu_torch" in ln for ln in lines)
    assert _bad_modules("\n".join(lines)) == "BAD []"


def test_default_device_raises_without_cuda(monkeypatch):
    from snarkjs_tpu_torch.protocols import groth16 as tg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devmod.resolve(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.prove_files(os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures",
                                    "tiny_bn128.zkey"),
                       os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures",
                                    "tiny_bn128.wtns"), r=1, s=2)
    r1cs, pt = _setup_inputs()
    for setup in (g16setup.setup_from_ptau, plonk_setup.setup_from_ptau):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            setup(r1cs, pt)
    assert devmod.resolve("cpu").type == "cpu"


def _setup_inputs():
    """A bn128 r1cs with one public input and no constraint, and the stored
    power-4 .ptau."""
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.formats import ptau as tptau
    from snarkjs_tpu_torch.formats import r1cs as tr1cs

    r1cs = tr1cs.R1cs(n8=32, prime=hc.BN254.fr.p, n_wires=2, n_pub_out=0, n_pub_in=1,
                      n_prv_in=0, n_labels=2, n_constraints=0,
                      m=np.zeros(0, np.int32), c=np.zeros(0, np.int32),
                      s=np.zeros(0, np.int32), vals=np.zeros((16, 0), np.uint32))
    with open(os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures",
                           "tiny_p4_bn128.ptau"), "rb") as f:
        return r1cs, tptau.read_ptau(f.read())


def test_plonk_default_device_raises_without_cuda(monkeypatch):
    from snarkjs_tpu_torch.formats import r1cs as tr1cs
    from snarkjs_tpu_torch.protocols import plonk as tp
    from snarkjs_tpu_torch.protocols import plonk_setup as tsetup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fx = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.prove_files(os.path.join(fx, "tiny_plonk_bn128.zkey"),
                       os.path.join(fx, "tiny_plonk_bn128.wtns"),
                       b=list(range(1, 13)))
    empty = tr1cs.R1cs(n8=32, prime=0, n_wires=1, n_pub_out=0, n_pub_in=0,
                       n_prv_in=0, n_labels=1, n_constraints=0,
                       m=np.zeros(0, np.int32), c=np.zeros(0, np.int32),
                       s=np.zeros(0, np.int32), vals=np.zeros((16, 0), np.uint32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsetup.setup_from_secrets(empty, 5)


def test_fflonk_default_device_raises_without_cuda(monkeypatch):
    """FFLONK's prove and its three setups default to the card and raise
    without one."""
    from snarkjs_tpu_torch.protocols import fflonk, fflonk_setup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fx = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
    r1cs, pt = _setup_inputs()
    for call in (lambda: fflonk.prove_files(os.path.join(fx, "tiny_fflonk_bn128.zkey"),
                                            os.path.join(fx, "tiny_fflonk_bn128.wtns"),
                                            b=list(range(1, 11))),
                 lambda: fflonk_setup.setup_from_secrets(r1cs, 5),
                 lambda: fflonk_setup.setup_from_ptau(r1cs, pt),
                 lambda: fflonk_setup.setup_from_srs(r1cs, b"", None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_setup_parts_raise_without_cuda(monkeypatch):
    """Groth16's `setup_from_secrets`, `_points_from_scalars` (whatever the
    number of scalars) and `lem_to_u` default to the card and raise without
    one."""
    from snarkjs_tpu_torch.ceremony import ptau_ops
    from snarkjs_tpu_torch.curves import host_curve as hc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r1cs, _ = _setup_inputs()
    for call in (lambda: g16setup.setup_from_secrets(r1cs, 5, 6, 7),
                 lambda: g16setup._points_from_scalars(hc.BN254, [1]),
                 lambda: ptau_ops.lem_to_u(hc.BN254, bytes(64), 1, False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_ceremony_entry_points_raise_without_cuda(monkeypatch):
    """The ceremony's entry points default to the card and raise without
    one, whatever the number of points; the host-only ones (new_accumulator, truncate, export_json) take no
    device."""
    from snarkjs_tpu_torch.ceremony import ptau_ops
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.utils.chacha import ChaCha

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pt = _setup_inputs()
    acc = ptau_ops.new_accumulator(hc.BN254, 2)
    cv = hc.BN254
    calls = [
        lambda: ptau_ops.contribute(acc, rng=ChaCha([1] * 8)),
        lambda: ptau_ops.beacon(acc, b"\x01" * 32, 3),
        lambda: ptau_ops.export_challenge(acc),
        lambda: ptau_ops.challenge_contribute(cv, b"\0" * 64, rng=ChaCha([1] * 8)),
        lambda: ptau_ops.import_response(acc, b""),
        lambda: ptau_ops.verify(pt),
        lambda: ptau_ops.prepare_phase2(pt),
        lambda: ptau_ops.convert(pt),
        lambda: ptau_ops.group_lagrange_lem(cv, bytes(pt.sections[2]), 4, False),
        lambda: ptau_ops.apply_key_g1(cv, bytes(pt.sections[2]), 65, 1, 2),
        # sizes that a CPU device takes to host bigints raise all the same
        lambda: ptau_ops.apply_key_g1(cv, bytes(pt.sections[2]), 64, 1, 2),
        lambda: ptau_ops.apply_key_g2(cv, bytes(pt.sections[3]), 1, 1, 2),
        lambda: ptau_ops._msm_lem(cv, bytes(pt.sections[2]), [1, 2], False),
        lambda: ptau_ops.lem_to_c(cv, bytes(64), 1, False),
        lambda: ptau_ops.c_to_lem(cv, bytes(32), 1, False),
        lambda: ptau_ops.u_to_lem(cv, bytes(64), 1, False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ptau_ops.export_json(ptau_ops.truncate(pt, 1))["power"] == 1


def test_phase2_entry_points_raise_without_cuda(monkeypatch):
    """Phase 2's entry points (zkey contribute, beacon, verify, the Bellman
    export / contribute / import) default to the card and raise without one,
    however small the key."""
    from snarkjs_tpu_torch.ceremony import bellman, zkey_mpc
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.utils.chacha import ChaCha

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pt = _setup_inputs()
    with open(os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures",
                           "tiny3_bn128_from_ptau.zkey"), "rb") as f:
        zk = f.read()
    calls = [
        lambda: zkey_mpc.contribute(zk, rng=ChaCha([1] * 8)),
        lambda: zkey_mpc.beacon(zk, b"\x01" * 32, 3),
        lambda: zkey_mpc.verify_from_init(zk, pt, zk),
        lambda: zkey_mpc.verify_from_r1cs(_setup_inputs()[0], pt, zk),
        lambda: bellman.export_mpc_params(zk),
        lambda: bellman.import_mpc_params(zk, b""),
        lambda: bellman.bellman_contribute(hc.BN254, b"", rng=ChaCha([1] * 8)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_witness_check_defaults_to_the_card(monkeypatch):
    """`tools.wtns_check` (and the API's `wtns.check` over it) default to the
    card and raise without one."""
    from snarkjs_tpu_torch import api, tools
    from snarkjs_tpu_torch.formats import wtns as twtns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r1cs, _ = _setup_inputs()
    wit = twtns.Witness(n8=32, q=r1cs.prime, n=2, values=np.zeros((16, 2), np.uint32))
    for call in (lambda: tools.wtns_check(r1cs, wit), lambda: api.wtns.check(r1cs, wit)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_failed_blake2b_build_raises(monkeypatch, tmp_path):
    """A failed g++ build raises; there is no pure-Python BLAKE2b to fall
    back to."""
    from snarkjs_tpu_torch import _build
    from snarkjs_tpu_torch.utils import blake2b as tblake

    monkeypatch.setattr(_build, "OUT", str(tmp_path))
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("--no-such-flag",))
    monkeypatch.delitem(_build._libs, "host:blake2b", raising=False)
    tblake._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed for blake2b"):
            tblake.Blake2b(64)
        assert not list(tmp_path.glob("*.so"))
    finally:
        tblake._lib.cache_clear()


def test_kernel_wrappers_do_not_fall_back_on_cuda_tensors(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with the build made to
    fail, the wrapper of K-mm-norm raises and never takes the plain version."""
    from snarkjs_tpu_torch.ntt import ntt_mm

    def boom(name):
        raise RuntimeError("nvcc failed for " + name)

    monkeypatch.setattr(ntt_mm._build, "library", boom)
    monkeypatch.setattr(ntt_mm.ftorch, "use_kernel", lambda t: True)
    monkeypatch.setattr(ntt_mm, "digit_mm_norm_plain",
                        lambda *a: pytest.fail("took the plain version"))
    ntt_mm._norm_lib.cache_clear()
    fp = ftorch.get_ctx("bn254_fr").fp
    W8 = torch.zeros((33, 4, 4), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ntt_mm.digit_mm_norm(fp, W8, W8)
    ntt_mm._norm_lib.cache_clear()


def test_no_module_reads_the_environment_for_a_route():
    """One NTT route, chosen by keyword: no module of the port reads
    os.environ, but for the build's NVCC (where the compiler is)."""
    pkg = os.path.join(ROOT, "snarkjs_tpu_torch")
    hits = []
    for base, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(base, fn)
                for n, line in enumerate(open(path), 1):
                    if "environ" in line or "getenv" in line:
                        hits.append((os.path.relpath(path, pkg), line.strip()))
    assert [h[0] for h in hits] == ["_build.py"], hits
    assert "NVCC" in hits[0][1]
    for fn in os.listdir(os.path.join(pkg, "csrc")):
        assert "getenv" not in open(os.path.join(pkg, "csrc", fn)).read(), fn


def test_no_module_reads_the_native_wasm_switch():
    """The JAX package's SNARKJS_NO_NATIVE_WASM picks its WASM VM; the port's
    caller picks it by argument (`vm=`), and no module of the port names the
    switch."""
    pkg = os.path.join(ROOT, "snarkjs_tpu_torch")
    for base, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith((".py", ".cpp", ".cu", ".cuh")):
                with open(os.path.join(base, fn)) as f:
                    assert "SNARKJS_NO_NATIVE_WASM" not in f.read(), fn


def test_importing_main_runs_nothing():
    """`import snarkjs_tpu_torch.__main__` neither prints the usage nor
    exits; `python -m snarkjs_tpu_torch` runs the CLI."""
    out = subprocess.run(
        [sys.executable, "-c", "import snarkjs_tpu_torch.__main__ as m; print('IMPORTED', m.main)"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("IMPORTED <function main") and "usage" not in out.stdout


def test_plain_versions_only_inside_context():
    t = torch.zeros(4, 2, dtype=torch.int32)
    assert not ftorch.use_kernel(t)
    with ftorch.plain_versions():
        assert not ftorch.use_kernel(t)


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bn254_fr", "bn254_fq", "bls12_381_fq"])
def test_k_field_matches_plain_on_card(card, name):
    ctx = ftorch.get_ctx(name)
    fp = ctx.fp
    rng = np.random.default_rng(7)
    vals = [0, 1, fp.p - 1] + [int.from_bytes(rng.bytes(fp.n8), "little") % fp.p
                               for _ in range(4093)]
    a = ftorch.to_tensor(ftorch.np_from_ints(fp, vals), card)
    b = a.flip(1).contiguous()
    for op in ("add", "sub", "mont_mul"):
        got = getattr(ftorch, op)(ctx, a, b)
        with ftorch.plain_versions():
            want = getattr(ftorch, op)(ctx, a, b)
        assert torch.equal(got, want), op
    with ftorch.plain_versions():
        want = ftorch.neg(ctx, a)
    assert torch.equal(ftorch.neg(ctx, a), want)


MM_SHAPES = [(64, 64, 96), (4, 4, 256), (256, 256, 4), (5, 10, 6),
             (256, 256, 1024), (1024, 1024, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [1, 2])
def test_jac_add_through_k_field_matches_plain_on_card(card, ext):
    """The setup's Jacobian add (every special case) on the card, where each
    field op is a K-field launch, against the plain versions."""
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.curves import jac
    from snarkjs_tpu_torch.curves.gops import field_ops
    from snarkjs_tpu_torch.fields import fcuda

    cv = hc.BN254
    fq = cv.fq
    ks, qs = [3, 5, 7, 0, 0, 11], [3, cv.fr.p - 5, 0, 9, 0, 13]
    mul, gen = (hc.g1_mul, cv.g1) if ext == 1 else (hc.g2_mul, cv.g2)

    def pts(vs):
        ps = [mul(cv, gen, k) if k else None for k in vs]
        col = lambda f: ftorch.to_tensor(ftorch.np_from_ints(
            fq, [0 if p is None else fq.to_mont(f(p)) for p in ps]), card)
        inf = torch.tensor([p is None for p in ps], device=card)
        if ext == 1:
            return col(lambda p: p[0]), col(lambda p: p[1]), inf
        return ((col(lambda p: p[0][0]), col(lambda p: p[0][1])),
                (col(lambda p: p[1][0]), col(lambda p: p[1][1])), inf)

    f = field_ops(ftorch.get_ctx(fq.name), ext, card)
    P, Q = jac.from_affine(f, *pts(ks)), jac.from_affine(f, *pts(qs))
    before = sum(fcuda.LAUNCHES.values())
    got = jac.jac_add(f, jac.jac_dbl(f, P), Q)
    assert sum(fcuda.LAUNCHES.values()) > before
    with ftorch.plain_versions():
        want = jac.jac_add(f, jac.jac_dbl(f, P), Q)
    flat = lambda t: [y for x in t for y in (flat(x) if isinstance(x, tuple) else [x])]
    for a, b in zip(flat(got), flat(want)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("r,q,m", MM_SHAPES)
def test_k_mm_matches_plain_on_card(card, r, q, m):
    from snarkjs_tpu_torch.ntt import ntt_mm

    g = torch.Generator().manual_seed(3)
    W8 = torch.randint(-128, 128, (33, r, q), generator=g, dtype=torch.int8)
    D8 = torch.randint(-128, 128, (33, q, m), generator=g, dtype=torch.int8)
    before = ntt_mm.LAUNCHES[0]
    got = ntt_mm.digit_mm(W8.to(card), D8.to(card))
    assert ntt_mm.LAUNCHES[0] == before + 1
    assert torch.equal(got, ntt_mm.digit_mm_plain(W8.to(card), D8.to(card)))


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["bn254_fr", "bls12_381_fr"])
@pytest.mark.parametrize("r,q,m", MM_SHAPES)
def test_k_mm_norm_matches_plain_on_card(card, field, r, q, m):
    from snarkjs_tpu_torch.ntt import ntt_mm

    fp = ftorch.get_ctx(field).fp
    g = torch.Generator().manual_seed(r + m)
    W8 = torch.randint(-128, 128, (33, r, q), generator=g, dtype=torch.int8)
    limbs = torch.randint(0, 1 << 16, (fp.nl, q, m), generator=g,
                          dtype=torch.int32)
    D8 = ntt_mm._to_digits(fp, limbs)
    before = ntt_mm.NORM_LAUNCHES[0]
    got = ntt_mm.digit_mm_norm(fp, W8.to(card), D8.to(card))
    assert ntt_mm.NORM_LAUNCHES[0] == before + 1
    assert torch.equal(got, ntt_mm.digit_mm_norm_plain(fp, W8.to(card), D8.to(card)))


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("n,lanes", [(512, 128), (512, 200), (300, 300)])
def test_k_scan_matches_plain_on_card(card, curve, group, n, lanes):
    """Every instantiation (N = 8, 12 words; G1, G2), on whole blocks of 128
    lanes, on a lane count that is no multiple of 128, and with C = 1."""
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.curves import msm_gpu

    cv = getattr(hc, curve)
    fq = cv.fq
    m = msm_gpu.get_msm(cv.name, group, cw=8)
    pts, acc = [], cv.g1 if group == "g1" else cv.g2
    add = hc.g1_add if group == "g1" else hc.g2_add
    for _ in range(n):
        pts.append(acc)
        acc = add(cv, acc, cv.g1 if group == "g1" else cv.g2)
    coord = lambda f: ftorch.to_tensor(
        ftorch.np_from_ints(fq, [fq.to_mont(f(p)) for p in pts]), card)
    if group == "g1":
        px, py = coord(lambda p: p[0]), coord(lambda p: p[1])
    else:
        px = (coord(lambda p: p[0][0]), coord(lambda p: p[0][1]))
        py = (coord(lambda p: p[1][0]), coord(lambda p: p[1][1]))
    rng = np.random.default_rng(9)
    scal = torch.from_numpy(rng.integers(0, 256, (4, n)).astype(np.int32)).to(card)
    xyT = m.scan_input(px, py, torch.zeros(n, dtype=torch.bool, device=card),
                       scal, lanes=lanes)
    assert xyT.shape[1] == -(-n // lanes) and xyT.shape[3] == lanes
    before = msm_gpu.LAUNCHES[0]
    got = msm_gpu.scan(fq, m.b, m.ext, xyT)
    assert msm_gpu.LAUNCHES[0] == before + 1
    assert torch.equal(got, msm_gpu.scan_plain(fq, m.b, m.ext, xyT))


@pytest.mark.cuda
def test_fflonk_prove_on_card_equals_stored_proof(card):
    """The stored FFLONK key with additions, proved on the card (K-field,
    K-scan), gives the proof the JAX package made on the CPU, byte for byte."""
    import json

    from snarkjs_tpu_torch.protocols import fflonk

    fx = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
    with open(os.path.join(fx, "tiny_fflonk_adds_bn128_proof.json")) as f:
        want = json.load(f)
    got = fflonk.prove_files(os.path.join(fx, "tiny_fflonk_adds_bn128.zkey"),
                             os.path.join(fx, "tiny_fflonk_adds_bn128.wtns"),
                             b=want["b"], device=card)
    assert json.dumps(list(got)) == json.dumps([want["proof"], want["publicSignals"]])


@pytest.mark.cuda
def test_ceremony_on_card_equals_stored_jax(card):
    """preparePhase2 of the stored bn128 power-4 file on the card (every
    block through the batched group iNTT, K-field) gives the JAX package's
    file byte for byte, and verify accepts it there (K-scan, K-mm-norm)."""
    from snarkjs_tpu_torch.ceremony import ptau_ops
    from snarkjs_tpu_torch.fields import fcuda
    from snarkjs_tpu_torch.formats import ptau as tptau
    from tests import _torch_ceremony as tc

    pt = tptau.read_ptau(tc.stored_beacon_file())
    before = sum(fcuda.LAUNCHES.values())
    prep = ptau_ops.prepare_phase2(pt, device=card)
    assert sum(fcuda.LAUNCHES.values()) > before
    assert tc.sha(prep.tobytes()) == tc.stored()["bn128_p4"]["sha256"]["prepared"]
    assert ptau_ops.verify(prep, rng=np.random.default_rng(tc.VERIFY_SEED), device=card)


@pytest.mark.cuda
def test_ceremony_chain_on_card_equals_stored_jax(card):
    """The whole bn128 power-4 chain on the card, where every apply-key and
    MSM has 64 points or fewer and still goes through the kernels (K-field,
    K-scan): every file, hash and verify result equals the JAX run."""
    from snarkjs_tpu_torch.ceremony import ptau_ops
    from snarkjs_tpu_torch.curves import host_curve as thc
    from snarkjs_tpu_torch.curves import msm_gpu
    from snarkjs_tpu_torch.fields import fcuda
    from snarkjs_tpu_torch.formats import ptau as tptau
    from snarkjs_tpu_torch.utils.chacha import ChaCha
    from tests import _torch_ceremony as tc

    curve, power = tc.CASES["bn128_p4"]
    fcuda.reset_counts()
    scans = msm_gpu.LAUNCHES[0]
    got, _ = tc.run_chain(ptau_ops, tptau, ChaCha, getattr(thc, curve), power,
                          {"device": card})
    assert sum(fcuda.LAUNCHES.values()) > 0 and msm_gpu.LAUNCHES[0] > scans
    want = tc.stored()["bn128_p4"]
    assert got == {k: want[k] for k in got}


@pytest.mark.cuda
def test_phase2_chain_on_card_equals_cpu(card):
    """Phase 2 on the bn128 domain-8 key on the card, where every apply-key,
    group iNTT and MSM goes through the kernels whatever its size (K-field,
    K-scan): contribute, beacon, verify, the Bellman export, round and
    import equal the CPU run's, which tests/test_torch_zkey_mpc.py and
    tests/test_torch_bellman.py hold equal to the JAX package's."""
    from snarkjs_tpu_torch.ceremony import bellman, zkey_mpc
    from snarkjs_tpu_torch.curves import host_curve as thc
    from snarkjs_tpu_torch.curves import msm_gpu
    from snarkjs_tpu_torch.fields import fcuda
    from snarkjs_tpu_torch.formats import ptau as tptau
    from snarkjs_tpu_torch.utils.chacha import ChaCha
    from tests import _torch_phase2 as p2

    zk, pt, _, _ = p2.CASES["bn128_d8"]
    init, ptau = p2.fixture(zk), tptau.read_ptau(p2.fixture(pt))

    def run(dev):
        (z1, h1), (z2, h2) = p2.chain(zkey_mpc, ChaCha, init, device=dev)
        ok = zkey_mpc.verify_from_init(init, ptau, z2,
                                       rng=np.random.default_rng(p2.VERIFY_SEED), device=dev)
        mpc = bellman.export_mpc_params(z2, device=dev)
        resp, h = bellman.bellman_contribute(thc.BN254, mpc, rng=ChaCha(p2.SEED_BELLMAN),
                                             device=dev)
        return z1, h1, z2, h2, ok, mpc, resp, h, bellman.import_mpc_params(z2, resp, device=dev)

    fcuda.reset_counts()
    scans = msm_gpu.LAUNCHES[0]
    got = run(card)
    assert sum(fcuda.LAUNCHES.values()) > 0 and msm_gpu.LAUNCHES[0] == scans + 4
    assert got == run("cpu")
    assert got[4] is True and got[-1] is not False
