"""snarkjs_tpu_torch: the PyTorch/CUDA port of snarkjs_tpu for NVIDIA Hopper.

Entry points (`protocols.groth16.prove`, `prove_files`) run on the card by
default (`device=None` means "cuda") and raise when no CUDA device is
present; pass `device="cpu"` for the plain PyTorch versions of the kernels.
"""
