"""hash_stages_s.single: seconds a proof spends in the stages that
hash (merkle #1, linear combination + merkle #2, spot-check bundles,
fri), from the prover's `timings=` in the traced run."""
from portbench import readers


def read(rec):
    return readers.hash_stages_s(rec)
