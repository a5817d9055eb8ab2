"""proof_s.single: the median seconds of one proof, on the host's clock,
over the proofs of the traced run's unprofiled head (stage times on)."""
from portbench import readers


def read(rec):
    return readers.head_proof_s(rec)
