"""launches_per_proof.single: the profiler's CUDA kernel launches in
the traced window over the proofs completed in it."""
from portbench import readers


def read(rec):
    return readers.launches_per_proof(rec)
