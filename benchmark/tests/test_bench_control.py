"""A run whose timed path is broken underneath comes out not correct: the
control (the reference with the blinding left out) and each fault a
Groth16 cell can have.  The harness's look for a card is skipped: the runs
go through the port's plain versions on the CPU at a tiny size."""

import pytest

from benchmark import control
from benchmark.harness import spec
from benchmark.tests.conftest import run_tiny

CELL = "groth16_bn128.tiny"


def _make(root):
    return spec.config(root, "groth16_bn128")[0].make


def _with_op(root, wrap):
    """A configuration whose cell's op is wrap(cell, the sound op)."""
    make = _make(root)

    def make_broken(config, mix, seed, device):
        cell = make(config, mix, seed, device)
        cell.op = wrap(cell, cell.op)
        return cell

    return make_broken


def _wrong(out):
    assert out["correct"] is False
    return out["compared"]["wrong_values"]["value"]


def test_the_sound_run_is_correct(tiny_root):
    out = run_tiny(tiny_root, CELL)
    assert out["correct"] is True and out["compared"]["wrong_values"]["value"] == 0


def test_the_control_is_not_correct(tiny_root):
    """Zero knowledge broken: r = s = 0.  pi_a, pi_b and pi_c all differ."""
    out = run_tiny(tiny_root, CELL, make_cell=control.unblinded(_make(tiny_root)))
    assert _wrong(out) == 3 * out["compared"]["checked_ops"]["value"]


def test_an_answer_altered_where_it_is_produced(tiny_root):
    def wrap(cell, op):
        def altered(request, logger=None):
            proof, publics = op(request, logger)
            proof = dict(proof, pi_a=[str(int(proof["pi_a"][0]) + 1)] + proof["pi_a"][1:])
            return proof, publics
        return altered

    assert _wrong(run_tiny(tiny_root, CELL, make_cell=_with_op(tiny_root, wrap))) >= 1


def test_a_stale_answer(tiny_root):
    """The state left unchanged: each call answers with what the call before
    it computed (the first with a proof made for another request)."""
    def wrap(cell, op):
        last = []

        def stale(request, logger=None):
            prev = last[-1] if last else type(request)(request.index, request.item,
                                                       request.bits ^ 1)
            last.append(request)
            return op(prev, logger)
        return stale

    assert _wrong(run_tiny(tiny_root, CELL, make_cell=_with_op(tiny_root, wrap))) >= 1


def test_half_of_each_msm_left_out(tiny_root, monkeypatch):
    from snarkjs_tpu_torch.curves import msm

    sound = msm.MSMContext.run

    def half(self, px, py, pinf, scalars, *a, **kw):
        scalars = scalars.clone()
        scalars[:, scalars.shape[1] // 2:] = 0
        return sound(self, px, py, pinf, scalars, *a, **kw)

    monkeypatch.setattr(msm.MSMContext, "run", half)
    assert _wrong(run_tiny(tiny_root, CELL)) >= 1


def test_the_bases_of_a_and_b1_swapped(tiny_root, monkeypatch):
    """Each section has bases of its own: the A multiexp on B1's points and
    B1's on A's changes pi_a and pi_c."""
    from snarkjs_tpu_torch.protocols import groth16

    sound = groth16._dev_points

    def swapped(zkey, dev, mesh=None):
        a, b1, b2, c, h = sound(zkey, dev, mesh)
        return b1, a, b2, c, h

    monkeypatch.setattr(groth16, "_dev_points", swapped)
    out = run_tiny(tiny_root, CELL)
    assert _wrong(out) == 2 * out["compared"]["checked_ops"]["value"]


@pytest.mark.cuda
def test_the_control_is_not_correct_on_card(tiny_root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = run_tiny(tiny_root, CELL, make_cell=control.unblinded(_make(tiny_root)),
                   device="cuda")
    assert _wrong(out) == 3 * out["compared"]["checked_ops"]["value"]
