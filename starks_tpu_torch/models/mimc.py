"""MiMC permutation: forward function and host trace.

The canonical single-register AIR instance (SURVEY §3.1 `starks/mimc.py`):
steps-1 rounds of x <- x^3 + c[i mod len(c)] (mod p). The trace is
sequential per proof, so it runs on the host, in the native runtime
(`trace_limbs`; `trace_host` is its plain bigint version), and is
uploaded whole (2 MB at 2^16 steps).
"""

from ..utils import native

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


def trace_limbs(inp: int, steps: int, round_constants):
    """The trace as a host [steps, 8] int32 array in the port's layout,
    from the native runtime (utils/native.py), as the JAX package's
    `trace_limbs` (starks_tpu/models/mimc.py:52) reads its trace."""
    return native.mimc_trace(inp, steps, round_constants)


def _air_step(state, consts):
    return [(state[0] ** 3 + consts[0]) % MODULUS]


def _air_transition(cur, nxt, consts, ops):
    return [ops.sub(nxt[0], ops.add(ops.cube(cur[0]), consts[0]))]


def _air_boundaries(steps):
    return [(0, 0), (steps - 1, 0)]


def mimc_air(round_constants):
    """MiMC as a general AIR: width 1, one periodic constant column,
    x' = x^3 + k, the input and the output pinned. The same AIR as the
    JAX package's AIR tests build (tests/_air_impl.py); its proof runs
    the cube kernel."""
    from ..air import AIR
    return AIR(width=1, step_fn=_air_step, transition=_air_transition,
               num_constraints=1, constants=[list(round_constants)],
               boundary_points=_air_boundaries)
