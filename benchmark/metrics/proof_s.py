"""proof_s: the window's seconds over the proofs completed in it, one
claim at a time in a closed loop with one client."""


def read(rec):
    return rec["window_s"] / rec["completed"] if rec["completed"] else None
