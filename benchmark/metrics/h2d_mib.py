"""h2d_mib: the bytes a proof copies from the host to the card, in MiB: the
program's counter `h2d_bytes` (snarkjs_tpu_torch.trace, every upload through
`device.upload`) over the root span of each profiled proof of the --trace 1
run; the median of the three."""

import statistics

from benchmark.harness import spans


def read(run):
    rs = spans.roots(run)
    if rs is None:
        return None
    return statistics.median(r[0].counters.get("h2d_bytes", 0) for r in rs) / 2**20
