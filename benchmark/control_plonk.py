#!/usr/bin/env python3
"""The control of a PLONK cell: a run with the reference in the program's
place, computed with the blinding left out, which the comparison has to
find.

    python3 benchmark/control_plonk.py --workload <cell> --seeds <n> [<n> ...] --seconds <s>

Each proof is the reference's for b[1..11] = 0, the step that would save a
prover its blinding (zero knowledge broken).  Prints one JSON line a seed;
`correct` must be false on every one.  The benchmark's own runs never run
this; control.py is the Groth16 cells' control.
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
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.families import plonk_chain
    from benchmark.harness import runner, spec

    bench = spec.load(ROOT)
    cfg_mod, _ = spec.config(ROOT, spec.cell(bench, args.workload)["config"])
    t = T_START
    for seed in args.seeds:
        result = runner.run(ROOT, args.workload, seed, args.seconds, False, "cuda", t,
                            make_cell=plonk_chain.unblinded(cfg_mod.make))
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "compared": result["compared"]}),
              flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
