"""snarkjs_tpu_torch: the PyTorch/CUDA port of snarkjs_tpu for NVIDIA Hopper.

The iden3/snarkjs API surface (reference main.js:1-8):
`snarkjs_tpu_torch.groth16.fullProve(...)`, `snarkjs_tpu_torch.wtns.check(...)`,
etc. (api.py); the CLI is `python -m snarkjs_tpu_torch <command> ...`
(cli.py).  Namespaces import lazily, so `import snarkjs_tpu_torch` stays
cheap.

Entry points run on the card by default (`device=None` means "cuda"; the
CLI's `--device` defaults to cuda) and raise when no CUDA device is present;
pass `device="cpu"` (`--device=cpu`) for the plain PyTorch versions of the
kernels.
"""

_NAMESPACES = ("groth16", "plonk", "fflonk", "powersOfTau", "powers_of_tau",
               "zKey", "zkey", "wtns", "r1cs")

__all__ = list(_NAMESPACES)


def __getattr__(name):
    if name in _NAMESPACES:
        from . import api

        return getattr(api, name)
    raise AttributeError(name)
