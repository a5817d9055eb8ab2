"""MiMC permutation: forward function and host trace.

The canonical single-register AIR instance (SURVEY §3.1 `starks/mimc.py`):
steps-1 rounds of x <- x^3 + c[i mod len(c)] (mod p). The trace is
sequential per proof, so it runs on host bigints and is uploaded whole
(2 MB at 2^16 steps).
"""

MODULUS = 2**256 - 351 * 2**32 + 1


def mimc_forward(inp: int, steps: int, round_constants) -> int:
    for i in range(steps - 1):
        inp = (inp ** 3 + round_constants[i % len(round_constants)]) % MODULUS
    return inp


def trace_host(inp: int, steps: int, round_constants) -> list:
    trace = [inp]
    for i in range(steps - 1):
        trace.append((trace[-1] ** 3
                      + round_constants[i % len(round_constants)]) % MODULUS)
    return trace
