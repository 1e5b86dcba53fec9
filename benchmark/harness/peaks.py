"""The card's peaks and the roofline bound, fixed here so that every run and
every later change is held against the same numbers.

H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3, 132 SMs at a 1,980 MHz
maximum SM clock.  32-bit integer multiply-add: 64 results a clock an SM for
compute capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
throughput table).  A Montgomery product of N 32-bit words (CIOS) takes
2 N^2 wide products, each a low and a high IMAD, and N more low products:
4 N^2 + N IMADs.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_HZ = 1.98e9
IMAD_PER_CLK_SM = 64
IMAD_PER_S = IMAD_PER_CLK_SM * SMS * SM_CLOCK_HZ


def imads_per_product(words: int) -> int:
    return 4 * words * words + words


def bound_s(nbytes: float, imads: float) -> tuple:
    """(least seconds, "bytes" or "operations"): the larger of the two."""
    tb, to = nbytes / HBM_BYTES_PER_S, imads / IMAD_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")
