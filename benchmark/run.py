#!/usr/bin/env python3
"""Run one cell of the benchmark of snarkjs_tpu_torch on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON object as the last line of
standard output (see harness/runner.py), and the numbers compared with the
reference as the last lines of standard error.  Exits non-zero and prints no
result when there is no card (or fewer than the cell asks for), or when JAX
or the JAX package has been loaded by the time the result would print.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import guard, runner, spec

    chips = spec.cell(spec.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = runner.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                        "cuda", T_START)
    bad = guard.loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
