"""snarkjs_tpu_torch's preparePhase2 (`ceremony/ptau_ops.py:prepare_phase2`)
with every block of every group through the batched group iNTT, against the
JAX package on the CPU.  Tolerance: none; sections 12-15 byte for byte.

The input is the stored bn128 power-4 file after a contribution, an imported
response and a beacon (tests/_torch_ceremony.py); the JAX prepared file's
SHA-256 is stored with it.  On CPU tensors the port sends blocks up to
HOST_IFFT_MAX_CPU points to host bigints; here the cutover is 0, so G1 runs
its 4 batched stages (blocks of up to 2^5 points) and G2 its 3, which is the
route every block takes on the card.
"""

from snarkjs_tpu_torch.ceremony import ptau_ops as T
from snarkjs_tpu_torch.formats import ptau as tptau
from tests import _torch_ceremony as tc
from tests._torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def test_prepare_phase2_batched_route_matches_jax(monkeypatch):
    monkeypatch.setattr(T, "HOST_IFFT_MAX_CPU", 0)
    pt = tptau.read_ptau(tc.stored_beacon_file())
    calls = []
    stage = T._intt_stage
    monkeypatch.setattr(T, "_intt_stage", lambda *a: calls.append(a[4]) or stage(*a))
    prep = T.prepare_phase2(pt, device="cpu")
    assert tc.sha(prep.tobytes()) == tc.stored()["bn128_p4"]["sha256"]["prepared"]
    # one pass over the stages a group: G1 up to 2^5 points, G2 up to 2^4
    assert calls == list(range(5)) + list(range(4))
