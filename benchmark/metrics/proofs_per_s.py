"""proofs_per_s: every proof completed in the window over the window's
seconds (whole calls only; the call that crosses the end counts, and
the window ends with it)."""


def read(rec):
    return rec["completed"] / rec["window_s"] if rec["completed"] else None
