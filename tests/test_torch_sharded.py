"""The port's multi-device layer (snarkjs_tpu_torch/parallel/sharded.py,
GpuMSM.run_sharded, the legacy Pippenger, the sharded apply-key) against
the JAX package and the port's unsharded results, exactly.

The port's side runs in worlds of 1 and 4 Gloo ranks on the CPU
(tests/_torch_dist.py: one spawn a world size for every case); the JAX side
runs here on the conftest's 8 virtual CPU devices, as tests/test_sharded.py
runs it, on the same inputs.
"""

import functools
import threading

import numpy as np
import pytest

from snarkjs_tpu.ceremony import ptau_ops as jops
from snarkjs_tpu.curves import host_curve as jhc
from snarkjs_tpu.fields import fjnp
from snarkjs_tpu.parallel import sharded as jsharded
from snarkjs_tpu_torch.ceremony import ptau_ops as tops
from snarkjs_tpu_torch.curves import host_curve as thc
from snarkjs_tpu_torch.fields import ftorch
from snarkjs_tpu_torch.formats import points as tpcodec
from snarkjs_tpu_torch.ntt import ntt as tntt
from snarkjs_tpu_torch.ntt import ntt_mm
from snarkjs_tpu_torch.parallel import sharded as tsharded
from tests import _torch_ceremony as tc
from tests import _torch_dist as td
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

WORLDS = (1, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds at once, in threads of this process, while the JAX and
    host references are made here (`refs`)."""
    out, threads = {}, []
    for ws in WORLDS:
        d = tmp_path_factory.mktemp(f"world{ws}")

        def run(ws=ws, d=d):
            try:
                out[ws] = td.run_world(ws, td.SHARDED_CASES[ws], d)
            except BaseException as e:      # handed to the tests below
                out[ws] = e

        threads.append(threading.Thread(target=run))
        threads[-1].start()
    refs()
    for t in threads:
        t.join()
    for ws, v in out.items():
        if isinstance(v, BaseException):
            raise v
    return out


@functools.lru_cache(maxsize=None)
def refs():
    """The JAX ntt_sharded outputs (8 virtual devices) and the host
    oracles, made once for both worlds."""
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    jctx = fjnp.get_ctx("bn254_fr")
    out = {"ntt": {logn: np.asarray(jsharded.ntt_sharded(mesh, jctx, td.ntt_input(logn)))
                   for logn in td.NTT_LOGS}}
    cv = thc.BN254
    pts, _, _, scal = td.msm_sharded_input(cv)
    out["msm_sharded"] = _host_msm(cv, pts, scal)
    out["legacy"] = _host_msm(cv, [p for i, p in enumerate(pts[:50]) if i != 7],
                              [k for i, k in enumerate(scal[:50]) if i != 7])
    pts, _, _, ints, _ = td.run_sharded_input(cv)
    out["run_sharded"] = _host_msm(cv, pts, ints)
    pts, _, _, ints = td.g2_input(cv)
    want = None
    for p, k in zip(pts, ints):
        want = thc.g2_add(cv, want, thc.g2_mul(cv, p, k))
    out["run_sharded_g2"] = want
    out["group"] = _lagrange_oracle(cv)
    return out


def _lagrange_oracle(cv):
    """The group iNTT of td.group_input by linearity: the input's point i is
    tau^i G1 (0 at the infinity), so output j is (1/n sum_i s_i w^-ij) G1,
    one host scalar multiplication a point."""
    fr = cv.fr
    n = 1 << td.GROUP_K
    s = [pow(td.GROUP_TAU, i, fr.p) for i in range(n)]
    s[5] = 0
    winv, ninv = fr.winv[td.GROUP_K], pow(n, fr.p - 2, fr.p)
    ks = [sum(v * pow(winv, i * j, fr.p) for i, v in enumerate(s)) * ninv % fr.p
          for j in range(n)]
    return [None if k == 0 else thc.g1_mul(cv, cv.g1, k) for k in ks]


def _same_on_every_rank(ranks, case):
    first = repr(ranks[0][case])
    return all(repr(r[case]) == first for r in ranks[1:])


def _host_msm(cv, pts, ks):
    want = None
    for p, k in zip(pts, ks):
        if k:
            want = thc.g1_add(cv, want, thc.g1_mul(cv, p, k))
    return want


@pytest.mark.parametrize("logn", td.NTT_LOGS)
@pytest.mark.parametrize("ws", WORLDS)
def test_ntt_sharded_equals_jax_and_unsharded(worlds, ws, logn):
    """Forward and inverse, limb for limb: n1 = n2 at 2^8, n1 != n2 at 2^9
    (a transposed all-to-all would show there); the JAX ntt_sharded's
    forward output, the port's ntt.ntt / ntt.intt."""
    ranks = worlds[ws]
    assert _same_on_every_rank(ranks, "ntt_case")
    y, z = ranks[0]["ntt_case"][logn]
    x = td.ntt_input(logn)
    ctx = ftorch.get_ctx("bn254_fr")
    np.testing.assert_array_equal(y, ftorch.to_numpy(tntt.ntt(ctx, ftorch.to_tensor(x, "cpu"))))
    np.testing.assert_array_equal(z, x)
    np.testing.assert_array_equal(z, ftorch.to_numpy(tntt.intt(ctx, ftorch.to_tensor(y, "cpu"))))
    np.testing.assert_array_equal(y, refs()["ntt"][logn])


@pytest.mark.parametrize("inverse", [False, True])
def test_axis_ntt_matmul_stages_equal_butterflies(inverse, monkeypatch):
    """A rank's axis NTT (`sharded._ntt_axis`) through the digit matmul with
    stages of at most 2^3, so its 2^7 axes take 2 + 2 + 3: limb-equal to
    its butterflies, over either axis of the block (on the CPU the matmul
    route is taken only where `_use_mm` is patched)."""
    ctx = ftorch.get_ctx("bn254_fr")
    x = ftorch.to_tensor(td.ntt_input(10), "cpu")
    blocks = ((x[:, :768].reshape(ctx.nl, 128, 6), 1), (x[:, :640].reshape(ctx.nl, 5, 128), 2))
    want = [tsharded._ntt_axis(ctx, b, 128, inverse, ax) for b, ax in blocks]
    monkeypatch.setattr(ntt_mm, "MAX_LOG_R", 3)
    monkeypatch.setattr(tntt, "_use_mm", lambda a, k: True)
    for (b, ax), w in zip(blocks, want):
        np.testing.assert_array_equal(
            ftorch.to_numpy(tsharded._ntt_axis(ctx, b, 128, inverse, ax)), ftorch.to_numpy(w))


@pytest.mark.parametrize("ws", WORLDS)
def test_msm_sharded_equals_host(worlds, ws):
    """test_sharded.py's inputs (64 points, c = 8, R = 4): the point its
    JAX msm_sharded gives there, the host bigint sum."""
    ranks = worlds[ws]
    assert _same_on_every_rank(ranks, "msm_sharded_case")
    assert ranks[0]["msm_sharded_case"] == refs()["msm_sharded"]


@pytest.mark.parametrize("part", ["full", "block", "g2"])
@pytest.mark.parametrize("ws", WORLDS)
def test_run_sharded_equals_host(worlds, ws, part):
    """GpuMSM.run_sharded at cw = 8 on test_sharded.py's 200 points (the
    JAX run_sharded's result there), from the full point arrays and from
    the rank's block; a G2 MSM through MSMContext.run(mesh=...)."""
    ranks = worlds[ws]
    assert _same_on_every_rank(ranks, "run_sharded_case")
    want = refs()["run_sharded_g2" if part == "g2" else "run_sharded"]
    assert ranks[0]["run_sharded_case"][part] == want


def test_legacy_pippenger_equals_default_engine(worlds):
    got = worlds[1][0]["legacy_case"]
    assert got["legacy"] == got["default"] == refs()["legacy"]


@pytest.mark.parametrize("ws", WORLDS)
def test_group_intt_sharded_equals_host_ifft(worlds, ws):
    """k = 6 with an infinity inside (test_sharded.py's case): the points
    host_group_ifft gives, from the Lagrange scalars on the host.  On four
    ranks the twiddle step (16 lanes a rank) goes through the batched
    double-and-add, the stages' lanes through host bigints."""
    cv = thc.BN254
    ranks = worlds[ws]
    assert _same_on_every_rank(ranks, "group_case")
    got = tpcodec.g1_lem_to_ints(cv.fq, ranks[0]["group_case"]["lem"], 1 << td.GROUP_K)
    assert got == refs()["group"]
    assert ranks[0]["group_case"]["batched"] == ([16] if ws == 4 else [])


def test_host_group_iffts_agree_with_the_oracle():
    """The oracle above is what both packages' host_group_ifft give, on a
    smaller block of the same kind (k = 3, an infinity inside)."""
    cv = thc.BN254
    k, fr = 3, thc.BN254.fr
    pts = [thc.g1_mul(cv, cv.g1, pow(td.GROUP_TAU, i, fr.p)) for i in range(1 << k)]
    pts[5] = None
    want = tops.host_group_ifft(cv, False, pts, k)
    assert want == jops.host_group_ifft(jhc.BN254, False, pts, k)
    saved = td.GROUP_K
    try:
        td.GROUP_K = k
        assert _lagrange_oracle(cv) == want
    finally:
        td.GROUP_K = saved


def test_apply_key_sharded_equals_unsharded_and_jax(worlds):
    """Four ranks: apply_key_g1 at 300 points over the mesh == the
    unsharded call; the module cases (G1 127 points with one infinity, G2
    65) == the stored JAX digests.  Each rank applied the key to its own
    block of each (the ladder restarted at the block's first point)."""
    ranks = worlds[4]
    per = lambda n, r: min((r + 1) * -(-n // 4), n) - r * -(-n // 4)
    for r, got in enumerate(ranks):
        mesh_blocks = [b for i, b in enumerate(got["apply_key_case"]["blocks"])
                       if not (r == 0 and i == 1)]              # rank 0's unsharded call
        assert mesh_blocks == [per(td.AK_N, r), per(tc.AK_G1, r), per(tc.AK_G2, r)]
    out = ranks[0]["apply_key_case"]
    for key in ("g1", "module_g1", "module_g2"):
        assert all(r["apply_key_case"][key] == out[key] for r in ranks)
    assert out["g1"] == out["g1_alone"]
    stored = tc.stored()["modules"]
    assert (out["module_g1"], out["module_g2"]) == (stored["apply_key_g1"],
                                                    stored["apply_key_g2"])
