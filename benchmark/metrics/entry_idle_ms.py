"""entry_idle_ms: the card's idle time a proof under the prover's own work
outside the QAP and the MSMs: the spans `prove.witness_upload`,
`prove.affine`, `prove.blind` and the root `groth16.prove`'s own time
(snarkjs_tpu_torch.trace), over the profiled proofs of the --trace 1 run;
each idle gap is credited to the innermost host span open then
(harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    idle = spans.idle_ms(run)
    return None if idle is None else idle["entry"]
