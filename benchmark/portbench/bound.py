"""The least time of a proof's field work on the card: a frozen model.

Copied from the bound model of the repository's chip_smoke.py as it
stood when this benchmark was defined, and frozen here so that later
changes to the program or its smoke test cannot move the yardstick.

A stage's least time is the larger of its bytes over the HBM bandwidth
(3.35 TB/s, H100 SXM data sheet) and its 32-bit integer operations over
64 multiply-adds per clock per SM (CUDA C++ Programming Guide,
arithmetic instruction throughput, compute capability 9.0) times the
card's SM count and maximum SM clock. Operations per field op are the
least csrc/field.cuh can do: a modmul 64 schoolbook word products and
8 + 2 for the folds by 351, two multiply-adds each, carries left out; a
square 36 products before the same folds; an add or sub one per word.
So the model counts multiply-adds only (the scale and cube streams are
also bound by their other integer instructions) and is a least time.

The work is counted from the configuration's shapes and the protocol,
not from the kernels launched, so it reads the same whatever implements
it: the inverse NTT over the trace (with its 1/n), the 8x forward LDE
whose input is zero off every 8th point, the constraint, D/B and L maps
over the evaluation domain, and one quartic fold per FRI round.
"""

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_CLOCK_PER_SM = 64
ELEM = 32                          # bytes per field element
OPS_MUL = 2 * (64 + 8 + 2)
OPS_SQR = 2 * (36 + 8 + 2)
OPS_ADD = 8


def dif_ops(n: int, scaled: bool = True) -> int:
    """An n-point DIF transform: log n stages of n/2 butterflies of a
    modmul and two adds, the last stage's twiddle (1) not multiplied;
    with a scale, n more modmuls in that stage."""
    return ((n.bit_length() - 1) * n // 2 * (OPS_MUL + 2 * OPS_ADD)
            + (n // 2 if scaled else -n // 2) * OPS_MUL)


def dit_ops(n: int, ext: int = 1) -> int:
    """An n-point DIT transform whose input is zero off the multiples of
    ext: its first log2(ext) stages only copy."""
    stages = n.bit_length() - 1 - (ext.bit_length() - 1)
    return stages * n // 2 * (OPS_MUL + 2 * OPS_ADD)


def proof_stages(steps: int, ext: int, n_consts: int,
                 fri_base_cutoff: int) -> list:
    """(stage, bytes, operations) of one MiMC proof's field work."""
    n = steps * ext
    stages = [
        ("inverse NTT over the trace", ELEM * (2 * steps + steps // 2),
         dif_ops(steps)),
        ("LDE", ELEM * (steps + n + n // 2), dit_ops(n, ext)),
        ("D/B map", ELEM * (5 * n + ext * n_consts + ext + 3),
         n * (5 * OPS_MUL + OPS_SQR + 5 * OPS_ADD)),
        ("L map", ELEM * (4 * n + 2 * ext), n * (2 * OPS_MUL + 2 * OPS_ADD)),
    ]
    n_r, maxdeg = n, 2 * steps
    r = 0
    while maxdeg > fri_base_cutoff:
        q = n_r // 4
        stages.append((f"fold {r}", ELEM * (n_r + 2 * q + 2),
                       q * (5 * OPS_MUL + 13 * OPS_ADD)))
        n_r, maxdeg, r = q, maxdeg // 4, r + 1
    return stages


def least_seconds(nbytes: int, ops: int, sms: int, clock_mhz: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S,
               ops / (INT_OPS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6))


def proof_least_seconds(cfg: dict, sms: int, clock_mhz: float) -> float:
    """The least time of one proof's field work under `cfg` (a
    configuration file's contents) on a card of `sms` SMs."""
    return sum(least_seconds(b, o, sms, clock_mhz) for _, b, o in
               proof_stages(cfg["steps"], cfg["extension_factor"],
                            len(cfg["round_constants"]),
                            cfg["fri_base_cutoff"]))
