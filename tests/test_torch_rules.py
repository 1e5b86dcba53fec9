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
    assert devmod.resolve("cpu").type == "cpu"


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
