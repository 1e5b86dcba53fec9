"""BLAKE2b-512 for the port (port of what snarkjs_tpu/utils/blake2b.py
serves so far).

The Groth16 setup's circuit hash (csHash) and the .ptau challenge hash only
absorb bytes and read the digest, which `hashlib.blake2b` gives bit for bit.
The JAX package's pure-Python class exists to export and resume a midstate
(the 216-byte partial hash of a ceremony contribution); that part comes with
the ceremony (ROADMAP A4).
"""

from __future__ import annotations

import hashlib


def Blake2b(digest_size: int = 64):
    """A fresh BLAKE2b hasher with `update` and `digest`."""
    return hashlib.blake2b(digest_size=digest_size)
