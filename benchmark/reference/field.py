"""Plain prime-field arithmetic on torch tensors, for the benchmark's reference.

An element is a column of 16-bit limbs in an int64 tensor of shape (L, n),
least significant limb first, canonical (< p).  Products are schoolbook
over limbs with a digit-by-digit Montgomery reduction (R = 2^(16 L)); every
intermediate stays below 2^40, so int64 holds it exactly.  Nothing here
comes from the measured program: the constants are derived from p alone.
"""

from __future__ import annotations

import numpy as np
import torch

BITS = 16
MASK = (1 << BITS) - 1


class Field:
    """GF(p) with L = nbytes / 2 limbs; roots of unity as ffjavascript defines
    them (nqr the least quadratic non-residue, w[s] = nqr^((p-1)/2^s),
    w[i] = w[i+1]^2), which is what snarkjs's domains are built on."""

    def __init__(self, p: int, nbytes: int):
        self.p = p
        self.nbytes = nbytes
        self.L = nbytes * 8 // BITS
        self.R = (1 << (BITS * self.L)) % p
        self.R2 = self.R * self.R % p
        self.pinv0 = (-pow(p, -1, 1 << BITS)) % (1 << BITS)
        s, t = 0, p - 1
        while t % 2 == 0:
            s, t = s + 1, t // 2
        self.s = s
        nqr = 2
        while pow(nqr, (p - 1) // 2, p) != p - 1:
            nqr += 1
        self.nqr = nqr
        self.shift = nqr * nqr % p
        w = [0] * (s + 1)
        w[s] = pow(nqr, t, p)
        for i in range(s - 1, -1, -1):
            w[i] = w[i + 1] * w[i + 1] % p
        self.w = w
        self._p_cache = {}

    # ---------------------------------------------------- host conversions
    def limbs(self, v: int) -> list:
        return [(v >> (BITS * i)) & MASK for i in range(self.L)]

    def const(self, v: int, device) -> torch.Tensor:
        """(L, 1) limbs of v mod p."""
        return torch.tensor(self.limbs(v % self.p), dtype=torch.int64,
                            device=device)[:, None]

    def from_ints(self, vs, device) -> torch.Tensor:
        buf = b"".join((int(v) % self.p).to_bytes(self.nbytes, "little") for v in vs)
        u16 = np.frombuffer(buf, dtype="<u2").reshape(len(vs), self.L)
        return torch.from_numpy(u16.T.astype(np.int64)).to(device)

    def to_ints(self, t: torch.Tensor) -> list:
        a = t.detach().cpu().numpy().astype("<u2").T
        data = np.ascontiguousarray(a).tobytes()
        n = self.nbytes
        return [int.from_bytes(data[j * n:(j + 1) * n], "little") for j in range(a.shape[0])]

    def _pl(self, like: torch.Tensor) -> torch.Tensor:
        """p as limbs shaped to broadcast against `like` (rows >= L)."""
        key = (like.shape[0], like.dim(), str(like.device))
        if key not in self._p_cache:
            limbs = self.limbs(self.p) + [0] * (like.shape[0] - self.L)
            self._p_cache[key] = torch.tensor(limbs, dtype=torch.int64, device=like.device
                                              ).reshape((-1,) + (1,) * (like.dim() - 1))
        return self._p_cache[key]

    # ------------------------------------------------------------ carries
    @staticmethod
    def _carry(t: torch.Tensor) -> torch.Tensor:
        """Propagate carries (or borrows) up the limbs; the top limb keeps the
        rest, with its sign."""
        t = t.clone()
        for i in range(t.shape[0] - 1):
            t[i + 1] += t[i] >> BITS
            t[i] &= MASK
        return t

    def _reduce_once(self, t: torch.Tensor) -> torch.Tensor:
        """t in [0, 2p) as carried limbs (top limb may exceed 16 bits) ->
        t mod p."""
        d = self._carry(t - self._pl(t))
        return torch.where(d[-1] < 0, t, d)

    # ---------------------------------------------------------- operations
    def add(self, a, b):
        return self._reduce_once(self._carry(a + b))

    def sub(self, a, b):
        d = self._carry(a - b)
        return torch.where(d[-1] < 0, self._carry(d + self._pl(d)), d)

    def mont_mul(self, a, b):
        """a * b / R mod p (both canonical)."""
        L = self.L
        a, b = torch.broadcast_tensors(a, b)
        t = torch.zeros((2 * L + 1,) + tuple(a.shape[1:]), dtype=torch.int64,
                        device=a.device)
        for i in range(L):
            t[i:i + L] += a[i] * b
        p = self._pl(a)
        for i in range(L):
            m = ((t[i] & MASK) * self.pinv0) & MASK
            t[i:i + L] += m * p
            t[i + 1] += t[i] >> BITS
        return self._reduce_once(self._carry(t[L:]))[:L]

    def to_mont(self, a):
        return self.mont_mul(a, self.const(self.R2, a.device))

    def from_mont(self, a):
        return self.mont_mul(a, self.const(1, a.device))

    def reduce_sums(self, t):
        """Limb-wise sums of k canonical elements (k small) -> their sum mod p."""
        t = self._carry(t)
        p = self._pl(t)
        while True:
            d = self._carry(t - p)
            keep = d[-1] < 0
            if bool(keep.all()):
                return t[:self.L]
            t = torch.where(keep, t, d)

    def powers(self, x: int, n: int, device) -> torch.Tensor:
        """Montgomery form of x^0 .. x^(n-1), by doubling the table."""
        out = self.const(self.R, device)
        step = x % self.p
        while out.shape[1] < n:
            out = torch.cat([out, self.mont_mul(out, self.const(step * self.R, device))], 1)
            step = step * step % self.p
        return out[:, :n].contiguous()

    def weighted_sums(self, t: torch.Tensor, period: int) -> tuple:
        """(sum_i x_i, sum_i (i mod period) x_i) mod p of plain elements,
        exact while n * period < 2^47 (limb sums stay below 2^63)."""
        n = t.shape[1]
        k = (torch.arange(n, device=t.device) % period)[None]
        s0 = t.sum(dim=1).tolist()
        s1 = (t * k).sum(dim=1).tolist()
        join = lambda cols: sum(int(v) << (BITS * j) for j, v in enumerate(cols)) % self.p
        return join(s0), join(s1)
