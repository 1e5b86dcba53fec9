#!/usr/bin/env python3
"""The control: a run of a cell with the reference in the program's place,
computed with one guarantee of the configuration broken, which the
comparison has to find.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] --seconds <s>

The guarantee broken is zero knowledge: each proof is the reference's with
the caller's r and s left out (r = s = 0), the step that would save a
prover its blinding.  Prints one JSON line a seed; `correct` must be false
on every one.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def as_output(want: dict) -> tuple:
    """A reference answer in the form groth16.prove returns: snarkjs's proof
    JSON and the public signals as strings."""
    g1 = lambda P: ["0", "1", "0"] if P is None else [str(P[0]), str(P[1]), "1"]
    g2 = lambda P: ([["0", "0"], ["1", "0"], ["0", "0"]] if P is None else
                    [[str(P[0][0]), str(P[0][1])], [str(P[1][0]), str(P[1][1])], ["1", "0"]])
    proof = {"pi_a": g1(want["pi_a"]), "pi_b": g2(want["pi_b"]), "pi_c": g1(want["pi_c"]),
             "protocol": "groth16"}
    return proof, [str(v) for v in want["publics"]]


def unblinded(make):
    """Wrap a configuration's `make`: the cell's op answers with the
    reference's proof for r = s = 0."""

    def make_control(config, mix, seed, device):
        cell = make(config, mix, seed, device)

        def op(request, logger=None):
            return as_output(cell.reference([request], blind=False)[0])

        cell.op = op
        return cell

    return make_control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.harness import runner, spec

    bench = spec.load(ROOT)
    cfg_mod, _ = spec.config(ROOT, spec.cell(bench, args.workload)["config"])
    t = T_START
    for seed in args.seeds:
        result = runner.run(ROOT, args.workload, seed, args.seconds, False, "cuda", t,
                            make_cell=unblinded(cfg_mod.make))
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "compared": result["compared"]}),
              flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
