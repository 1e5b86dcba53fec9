"""Carry a prover's state from the JAX package into the port.

For a prover the "weights" are the proving key and the witness.  These
functions take any object with the fields of snarkjs_tpu's `Groth16Zkey`,
`PlonkZkey` or `FflonkZkey` (formats/zkey.py) or `Witness`
(formats/wtns.py), duck-typed: arrays as numpy (or anything `np.asarray`
takes), points as host ints, the curve by name.  Nothing of snarkjs_tpu is
imported.
"""

from __future__ import annotations

import numpy as np

from .curves.host_curve import get_curve
from .formats.wtns import Witness
from .formats.zkey import FflonkZkey, Groth16Zkey, PlonkZkey


def _arrays(t):
    if isinstance(t, tuple):
        return tuple(_arrays(x) for x in t)
    return np.array(t)


def zkey_from_numpy(src, device=None) -> Groth16Zkey:
    """The port's Groth16Zkey from a JAX-package one.  With `device`, the MSM
    bases are uploaded there at once (else at the first proof)."""
    zk = Groth16Zkey(
        curve=get_curve(src.curve.name), n8q=int(src.n8q), n8r=int(src.n8r),
        n_vars=int(src.n_vars), n_public=int(src.n_public),
        domain_size=int(src.domain_size), power=int(src.power),
        vk_alpha_1=src.vk_alpha_1, vk_beta_1=src.vk_beta_1,
        vk_beta_2=src.vk_beta_2, vk_gamma_2=src.vk_gamma_2,
        vk_delta_1=src.vk_delta_1, vk_delta_2=src.vk_delta_2,
        ic=list(src.ic),
        coeffs={k: np.array(v) for k, v in src.coeffs.items()},
        a_points=_arrays(src.a_points), b1_points=_arrays(src.b1_points),
        b2_points=_arrays(src.b2_points), c_points=_arrays(src.c_points),
        h_points=_arrays(src.h_points), raw=None)
    if device is not None:
        from . import device as devmod
        from .protocols.groth16 import _dev_points

        _dev_points(zk, devmod.resolve(device))
    return zk


def plonk_zkey_from_numpy(src, device=None) -> PlonkZkey:
    """The port's PlonkZkey from a JAX-package one.  With `device`, the key's
    sections and SRS are uploaded there at once (else at the first proof)."""
    ints = ("n8q", "n8r", "n_vars", "n_public", "domain_size", "power",
            "n_additions", "n_constraints", "k1", "k2")
    pts = ("qm", "ql", "qr", "qo", "qc", "s1", "s2", "s3", "x_2")
    arrays = ("a_map", "b_map", "c_map", "qm_p4", "ql_p4", "qr_p4", "qo_p4",
              "qc_p4", "sigma1_p4", "sigma2_p4", "sigma3_p4", "lagrange", "ptau")
    zk = PlonkZkey(
        curve=get_curve(src.curve.name),
        **{k: int(getattr(src, k)) for k in ints},
        **{k: getattr(src, k) for k in pts},
        additions={k: np.array(v) for k, v in src.additions.items()},
        **{k: _arrays(getattr(src, k)) for k in arrays})
    if device is not None:
        from . import device as devmod
        from .protocols.plonk import _dev_key

        _dev_key(zk, devmod.resolve(device),
                 min(zk.domain_size + 6, zk.ptau[2].shape[0]))
    return zk


def fflonk_zkey_from_numpy(src, device=None) -> FflonkZkey:
    """The port's FflonkZkey from a JAX-package one.  With `device`, the key's
    sections and SRS are uploaded there at once (else at the first proof)."""
    ints = ("n8q", "n8r", "n_vars", "n_public", "domain_size", "power",
            "n_additions", "n_constraints", "k1", "k2", "w3", "w4", "w8", "wr")
    arrays = ("a_map", "b_map", "c_map", "ql_p4", "qr_p4", "qm_p4", "qo_p4",
              "qc_p4", "sigma1_p4", "sigma2_p4", "sigma3_p4", "lagrange", "ptau",
              "c0_coefs")
    zk = FflonkZkey(
        curve=get_curve(src.curve.name),
        **{k: int(getattr(src, k)) for k in ints}, x_2=src.x_2, c0=src.c0,
        additions={k: np.array(v) for k, v in src.additions.items()},
        **{k: _arrays(getattr(src, k)) for k in arrays})
    if device is not None:
        from . import device as devmod
        from .protocols.fflonk import _dev_key

        _dev_key(zk, devmod.resolve(device))
    return zk


def witness_from_numpy(src) -> Witness:
    return Witness(n8=int(src.n8), q=int(src.q), n=int(src.n),
                   values=np.array(src.values, dtype=np.uint32))
