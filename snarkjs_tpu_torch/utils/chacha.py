"""ChaCha20-based deterministic PRNG (port of snarkjs_tpu/utils/chacha.py),
bit-compatible with ffjavascript's `ChaCha` (consumed by the reference via
`src/misc.js:182-228`, `src/keypair.js:22-35`, `src/powersoftau_verify.js:428`).

State = [4 ChaCha constants, 8 seed words, 4 zero words(ctr/nonce)]; each
update runs 10 double-rounds and emits 16 u32 words; the 64-bit counter at
words 12/13 increments per block.  nextU64 returns hi*2^32 + lo.
"""

from __future__ import annotations

MASK32 = 0xFFFFFFFF


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & MASK32


def _quarter(st, a, b, c, d):
    st[a] = (st[a] + st[b]) & MASK32
    st[d] = _rotl(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & MASK32
    st[b] = _rotl(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b]) & MASK32
    st[d] = _rotl(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & MASK32
    st[b] = _rotl(st[b] ^ st[c], 7)


class ChaCha:
    def __init__(self, seed=None):
        seed = list(seed) if seed is not None else [0] * 8
        assert len(seed) == 8
        self.state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
                      *[s & MASK32 for s in seed], 0, 0, 0, 0]
        self.idx = 16
        self.buff = [0] * 16

    def _update(self):
        st = list(self.state)
        for _ in range(10):
            _quarter(st, 0, 4, 8, 12)
            _quarter(st, 1, 5, 9, 13)
            _quarter(st, 2, 6, 10, 14)
            _quarter(st, 3, 7, 11, 15)
            _quarter(st, 0, 5, 10, 15)
            _quarter(st, 1, 6, 11, 12)
            _quarter(st, 2, 7, 8, 13)
            _quarter(st, 3, 4, 9, 14)
        self.buff = [(st[i] + self.state[i]) & MASK32 for i in range(16)]
        self.idx = 0
        self.state[12] = (self.state[12] + 1) & MASK32
        if self.state[12] == 0:
            self.state[13] = (self.state[13] + 1) & MASK32

    def next_u32(self) -> int:
        if self.idx == 16:
            self._update()
        v = self.buff[self.idx]
        self.idx += 1
        return v

    def next_u64(self) -> int:
        hi = self.next_u32()
        return hi * 0x100000000 + self.next_u32()

    def next_bool(self) -> bool:
        return (self.next_u32() & 1) == 1


def seed_from_hash_be(digest: bytes) -> list[int]:
    """8 u32 seed words read big-endian from a 32+-byte hash (the reference's
    DataView.getUint32 default, src/keypair.js:26-29, src/misc.js:193-196)."""
    return [int.from_bytes(digest[4 * i:4 * i + 4], "big") for i in range(8)]
