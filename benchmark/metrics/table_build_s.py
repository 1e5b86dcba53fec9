"""table_build_s: the time the process spent building its cached tables
(the NTTs' twiddles, DFT digit matrices, power blocks and the K-mm-norm
constants): the program's counter `table_build_ns` (snarkjs_tpu_torch.trace,
each miss of a cached builder timed on the host), the process's total when
the --trace 1 run reads it; nearly all of it falls in set-up."""

from benchmark.harness import spans


def read(run):
    if spans.roots(run) is None:
        return None
    ns = spans.counter_total("table_build_ns")
    return None if ns is None else ns / 1e9
