"""setup_s: process start to the first timed proof (import, kernel
library build or load, the configuration's set-up tables, the warm-up
of the cell's own shapes), on the host's clock."""


def read(rec):
    return rec["setup_s"]
