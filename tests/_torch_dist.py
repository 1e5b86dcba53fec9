"""Shared by tests/test_torch_sharded.py, test_torch_mesh.py and
test_torch_distributed.py: worlds of Gloo ranks on the CPU and the cases
they run.

`run_world(world_size, cases, store_dir)` starts `world_size` processes
(start method `spawn`, a `file://` store in `store_dir`) through
`parallel.distributed.spawn`, joined within JOIN_LIMIT_S; each rank runs
the named case functions of this module one after another and returns
their results, so a test module pays for the processes' start-up once.
This module imports only torch, numpy and the port, never a test module
(the ranks import it, and the test modules import jax).
"""

import json
import os
import random

import numpy as np
import torch

from snarkjs_tpu_torch.parallel import distributed as pdist

JOIN_LIMIT_S = 120.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "snarkjs_tpu_torch", "fixtures")
NTT_LOGS = (8, 9)          # n1 = n2 = 16, and n1 = 16 != n2 = 32
GROUP_K, GROUP_TAU = 6, 55443322
AK_N, AK_FIRST, AK_INC = 300, 987654, 13579


def run_world(world_size: int, cases, store_dir: str, timeout: float = JOIN_LIMIT_S):
    """[{case name: result}] of every rank, in rank order."""
    return pdist.spawn(_run_cases, world_size, args=(tuple(cases),),
                       devices=["cpu"] * world_size, timeout=timeout,
                       store_dir=str(store_dir))


def _run_cases(rank, cases):
    torch.set_num_threads(1)
    mesh = pdist.prover_mesh()
    return {name: globals()[name](rank, mesh) for name in cases}


def _t(a):
    from snarkjs_tpu_torch.fields import ftorch

    return ftorch.to_tensor(a, "cpu")


# ------------------------------------------------------------------ inputs

def ntt_input(logn: int):
    """Montgomery limbs (uint32 numpy) of 2^logn random Fr values."""
    from snarkjs_tpu_torch.fields.params import get_params

    fp = get_params("bn254_fr")
    rng = random.Random(21 + logn)
    vals = [fp.to_mont(rng.randrange(fp.p)) for _ in range(1 << logn)]
    from snarkjs_tpu_torch.fields import ftorch

    return ftorch.np_from_ints(fp, vals)


def msm_points(cv, n, seed):
    """n affine multiples of G1 (host ints) and their Montgomery limbs."""
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.fields import ftorch

    rng = random.Random(seed)
    pts = [hc.g1_mul(cv, cv.g1, rng.randrange(1, cv.fr.p)) for _ in range(n)]
    fq = cv.fq
    px = ftorch.np_from_ints(fq, [fq.to_mont(p[0]) for p in pts])
    py = ftorch.np_from_ints(fq, [fq.to_mont(p[1]) for p in pts])
    return pts, px, py, rng


def msm_sharded_input(cv):
    """test_sharded.py's msm_sharded inputs: 64 points, 64 scalars."""
    pts, px, py, rng = msm_points(cv, 64, 23)
    scal = [rng.randrange(cv.fr.p) for _ in range(64)]
    return pts, px, py, scal


def run_sharded_input(cv):
    """test_sharded.py's run_sharded inputs: 200 points, two 8-bit windows."""
    n, nw, cw = 200, 2, 8
    pts, px, py, rng = msm_points(cv, n, 31)
    ints = [rng.randrange(0, 1 << (cw * nw)) for _ in range(n)]
    scal = np.zeros((nw, n), dtype=np.uint32)
    for j, v in enumerate(ints):
        for w in range(nw):
            scal[w, j] = (v >> (cw * w)) & ((1 << cw) - 1)
    return pts, px, py, ints, scal


def g2_input(cv, n=40):
    """n multiples of G2, their limbs (pairs), and scalars below 2^16."""
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.fields import ftorch

    fq = cv.fq
    pts = [hc.g2_mul(cv, cv.g2, 3 + 11 * i) for i in range(n)]
    m = lambda vs: ftorch.np_from_ints(fq, [fq.to_mont(v) for v in vs])
    px = (m([p[0][0] for p in pts]), m([p[0][1] for p in pts]))
    py = (m([p[1][0] for p in pts]), m([p[1][1] for p in pts]))
    ints = [(7919 * i + 13) % 65536 for i in range(n)]
    return pts, px, py, ints


def group_input(cv):
    """test_sharded.py's group iNTT input: tau powers of G1, one infinity."""
    from snarkjs_tpu_torch.curves import host_curve as hc

    n = 1 << GROUP_K
    pts = [hc.g1_mul(cv, cv.g1, pow(GROUP_TAU, i, cv.fr.p)) for i in range(n)]
    pts[5] = None
    return pts


# ------------------------------------------------------------------ cases: sharded

def ntt_case(rank, mesh):
    from snarkjs_tpu_torch.fields import ftorch
    from snarkjs_tpu_torch.parallel import sharded

    ctx = ftorch.get_ctx("bn254_fr")
    out = {}
    for logn in NTT_LOGS:
        x = _t(ntt_input(logn))
        y = sharded.ntt_sharded(mesh, ctx, x)
        z = sharded.ntt_sharded(mesh, ctx, y, inverse=True)
        out[logn] = (ftorch.to_numpy(y), ftorch.to_numpy(z))
    return out


def msm_sharded_case(rank, mesh):
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.curves import msm
    from snarkjs_tpu_torch.curves.gops import FqOps
    from snarkjs_tpu_torch.fields import ftorch
    from snarkjs_tpu_torch.parallel import sharded

    cv = hc.BN254
    fq = cv.fq
    _, px, py, scal = msm_sharded_input(cv)
    ctx = ftorch.get_ctx(fq.name)
    ws = sharded.msm_sharded(mesh, FqOps(ctx, "cpu"), _t(px), _t(py),
                             torch.zeros(64, dtype=torch.bool),
                             _t(ftorch.np_from_ints(cv.fr, scal)), c=8, nbits=256, R=4)
    mctx = msm.MSMContext(ctx, fq, extension=1)
    return msm.host_jac_to_affine(fq, mctx._finish(ws, 8, 256), 1)


def run_sharded_case(rank, mesh):
    """GpuMSM.run_sharded on G1 (cw = 8, two windows, full point arrays),
    G1 again from this rank's block of the points, and G2 through
    MSMContext.run(mesh=...)."""
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.curves import msm, msm_gpu
    from snarkjs_tpu_torch.fields import ftorch

    cv = hc.BN254
    fq = cv.fq
    _, px, py, _, scal = run_sharded_input(cv)
    m = msm_gpu.GpuMSM(cv.fq, cv.fr, cv.b, ext=1, cw=8)
    inf = torch.zeros(200, dtype=torch.bool)
    full = msm.host_jac_to_affine(fq, m.run_sharded(mesh, _t(px), _t(py), inf, _t(scal)))
    sl = pdist.local_shard_slice(200, mesh)
    block = msm.host_jac_to_affine(fq, m.run_sharded(mesh, _t(px)[:, sl], _t(py)[:, sl],
                                                     inf[sl], _t(scal)))
    _, gx, gy, ints = g2_input(cv)
    ctx = ftorch.get_ctx(fq.name)
    g2m = msm.MSMContext(ctx, fq, extension=2)
    g2 = msm.host_jac_to_affine(fq, g2m.run(
        tuple(_t(a) for a in gx), tuple(_t(a) for a in gy),
        torch.zeros(len(ints), dtype=torch.bool), _t(ftorch.np_from_ints(cv.fr, ints)),
        mesh=mesh), 2)
    return {"full": full, "block": block, "g2": g2}


def legacy_case(rank, mesh):
    """MSMContext.run(legacy=True) and the default engine on 50 points, one
    at infinity."""
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.curves import msm
    from snarkjs_tpu_torch.fields import ftorch

    cv = hc.BN254
    fq = cv.fq
    _, px, py, scal = msm_sharded_input(cv)
    n = 50
    inf = torch.zeros(n, dtype=torch.bool)
    inf[7] = True
    s = _t(ftorch.np_from_ints(cv.fr, scal[:n]))
    mctx = msm.MSMContext(ftorch.get_ctx(fq.name), fq, extension=1)
    args = (_t(px[:, :n]), _t(py[:, :n]), inf, s)
    return {"legacy": msm.host_jac_to_affine(fq, mctx.run(*args, legacy=True, R=8), 1),
            "default": msm.host_jac_to_affine(fq, mctx.run(*args), 1)}


GROUP_HOST_LANES = 8    # on several ranks: the cutover of ptau_ops._scale_lanes


def group_case(rank, mesh):
    """group_intt_sharded of group_input: its LEM output, and the lanes of
    each batched scalar multiplication (`ptau_ops._scale_batch`) it made.
    On several ranks the host cutover is GROUP_HOST_LANES, so the twiddle
    step's 16 lanes a rank take the batched route and the stages' 4 and 6
    lanes host bigints; on one rank every step takes host bigints."""
    from snarkjs_tpu_torch.ceremony import ptau_ops
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.fields import ftorch
    from snarkjs_tpu_torch.formats import points as pcodec
    from snarkjs_tpu_torch.parallel import sharded

    cv = hc.BN254
    fq = cv.fq
    pts = group_input(cv)
    px = _t(ftorch.np_from_ints(fq, [fq.to_mont(p[0]) if p else 0 for p in pts]))
    py = _t(ftorch.np_from_ints(fq, [fq.to_mont(p[1]) if p else 0 for p in pts]))
    pinf = torch.tensor([p is None for p in pts])
    batched, inner, cutover = [], ptau_ops._scale_batch, ptau_ops.HOST_IFFT_MAX_CPU

    def counted(f, P, idx, scal):
        batched.append(idx.shape[0])
        return inner(f, P, idx, scal)

    ptau_ops._scale_batch = counted
    if pdist.mesh_size(mesh) > 1:
        ptau_ops.HOST_IFFT_MAX_CPU = GROUP_HOST_LANES
    try:
        ox, oy, oinf = sharded.group_intt_sharded(mesh, cv, False, px, py, pinf)
    finally:
        ptau_ops._scale_batch, ptau_ops.HOST_IFFT_MAX_CPU = inner, cutover
    return {"lem": pcodec.g1_lem_to_bytes(fq, ftorch.to_numpy(ox), ftorch.to_numpy(oy),
                                          oinf.numpy()),
            "batched": batched}


def apply_key_case(rank, mesh):
    """apply_key_g1 at AK_N points over the mesh and alone, and the stored
    module cases (G1 127, G2 65 points), each rank's blocks on host bigints
    (ptau_ops.HOST_MAX raised: the device route is another file's); with
    the number of points of each `_apply_keys` call ("blocks")."""
    from snarkjs_tpu_torch.ceremony import ptau_ops
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.formats import points as pcodec

    from . import _torch_ceremony as tc

    ptau_ops.HOST_MAX = 512
    blocks, inner = [], ptau_ops._apply_keys

    def counted(cv, g2, parts, device=None):
        blocks.append(sum(n for _, n, _, _ in parts))
        return inner(cv, g2, parts, device)

    ptau_ops._apply_keys = counted
    cv = hc.BN254
    pts = [hc.g1_mul(cv, cv.g1, 7 + i) for i in range(AK_N)]
    lem = pcodec.g1_lem_from_ints(cv.fq, pts)
    out = {"g1": ptau_ops.apply_key_g1(cv, lem, AK_N, AK_FIRST, AK_INC, device="cpu",
                                       mesh=mesh)}
    if rank == 0:
        out["g1_alone"] = ptau_ops.apply_key_g1(cv, lem, AK_N, AK_FIRST, AK_INC, device="cpu")
    lem1, lem2 = tc.module_inputs(cv, pcodec, hc)
    out["module_g1"] = tc.sha(ptau_ops.apply_key_g1(cv, lem1, tc.AK_G1, tc.AK_FIRST,
                                                    tc.AK_INC, device="cpu", mesh=mesh))
    out["module_g2"] = tc.sha(ptau_ops.apply_key_g2(cv, lem2, tc.AK_G2, tc.AK_FIRST,
                                                    tc.AK_INC, device="cpu", mesh=mesh))
    out["blocks"] = blocks
    return out


# the cases of each world of test_torch_sharded.py: the legacy Pippenger is
# unsharded (one rank is enough), the sharded apply-key's cut points show only
# on several ranks
SHARDED_CASES = {1: ("ntt_case", "msm_sharded_case", "run_sharded_case", "group_case",
                     "legacy_case"),
                 4: ("ntt_case", "msm_sharded_case", "run_sharded_case", "group_case",
                     "apply_key_case")}


# ------------------------------------------------------------------ cases: mesh

PROVERS = {"groth16": ("tiny_bn128", lambda j: {"r": j["r"], "s": j["s"]}),
           "plonk": ("tiny_plonk_bn128", lambda j: {"b": j["b"]}),
           "fflonk": ("tiny_fflonk_bn128", lambda j: {"b": j["b"]})}


def stored_proof(what):
    with open(os.path.join(FIXTURES, PROVERS[what][0] + "_proof.json")) as f:
        return json.load(f)


def prove_case(rank, mesh):
    """The three provers over the mesh with the stored blinders, and a
    Groth16 proof whose r, s are drawn."""
    import importlib

    out = {}
    for what, (stem, blinders) in PROVERS.items():
        mod = importlib.import_module(f"snarkjs_tpu_torch.protocols.{what}")
        zk, wt = (os.path.join(FIXTURES, stem + ext) for ext in (".zkey", ".wtns"))
        out[what] = mod.prove_files(zk, wt, device="cpu", mesh=mesh,
                                    **blinders(stored_proof(what)))
    from snarkjs_tpu_torch.protocols import groth16

    out["groth16_drawn"] = groth16.prove_files(
        os.path.join(FIXTURES, "tiny_bn128.zkey"), os.path.join(FIXTURES, "tiny_bn128.wtns"),
        device="cpu", mesh=mesh)
    return out


def ceremony_case(rank, mesh):
    """contribute (bn128 power 4, the stored chain's seed) and prepare_phase2
    of the stored beacon file, over the mesh: SHA-256 of each file."""
    from snarkjs_tpu_torch.ceremony import ptau_ops
    from snarkjs_tpu_torch.curves import host_curve as hc
    from snarkjs_tpu_torch.formats import ptau as ptau_fmt
    from snarkjs_tpu_torch.utils.chacha import ChaCha

    from . import _torch_ceremony as tc

    acc = ptau_ops.new_accumulator(hc.BN254, 4)
    c1, _ = ptau_ops.contribute(acc, name="first", rng=ChaCha(tc.SEED_CONTRIB), device="cpu",
                                mesh=mesh)
    prep = ptau_ops.prepare_phase2(ptau_fmt.read_ptau(tc.stored_beacon_file()), device="cpu",
                                   mesh=mesh)
    return {"contributed": tc.sha(c1.tobytes()), "prepared": tc.sha(prep.tobytes())}


MESH_CASES = ("prove_case", "ceremony_case")


# ------------------------------------------------------------------ cases: failures

def mesh_case(rank, mesh):
    """What this rank's mesh is: its type, size, rank, device type and the
    ranges local_shard_slice gives it."""
    return {"type": type(mesh).__name__, "size": pdist.mesh_size(mesh),
            "rank": pdist.mesh_rank(mesh), "device_type": mesh.device_type,
            "slices": {n: pdist.local_shard_slice(n, mesh) for n in SLICE_NS}}


SLICE_NS = (0, 1, 2, 10, 11, 200, 301)


def raising_case(rank, mesh):
    """Rank 1 raises; the others wait in a collective that never completes."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    pdist.all_gather(mesh, torch.zeros(1))
    return "unreachable"


def sleeping_case(rank, mesh):
    """Every rank outlasts any join limit a test gives it."""
    import time

    time.sleep(600)
