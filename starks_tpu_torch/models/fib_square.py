"""Fibonacci-square AIR: the two-register multi-column example
(benchmark config 3; the port's own copy of
`starks_tpu/models/fib_square.py`).

State (a, b); transition a' = b, b' = a^2 + b^2. Boundary: both registers
pinned at step 0 and register 1 pinned at the last step (the public
output). Constraint degree 2 (<= 3, so the shared deg < 2*steps FRI
bound of the AIR protocol applies)."""

from ..air import AIR

MODULUS = 2**256 - 351 * 2**32 + 1


def _step(state, consts):
    a, b = state
    return [b, (a * a + b * b) % MODULUS]


def _transition(cur, nxt, consts, ops):
    a, b = cur
    a_n, b_n = nxt
    c0 = ops.sub(a_n, b)
    c1 = ops.sub(b_n, ops.add(ops.mul(a, a), ops.mul(b, b)))
    return [c0, c1]


def _boundaries(steps):
    return [(0, 0), (0, 1), (steps - 1, 1)]


def fib_square_air() -> AIR:
    return AIR(width=2, step_fn=_step, transition=_transition,
               num_constraints=2, constants=[], boundary_points=_boundaries)


def fib_square_air_declarative() -> AIR:
    """Same AIR, but with the transition relation written as multivariate
    polynomials and lowered via `algebra.compile_transition` — the
    declarative path mirroring the reference's multivariate-constraint
    representation (`starks/multivariate_polynomial.py`, SURVEY §3.1)."""
    from ..algebra import (IntegersModP, multivariates_over,
                           compile_transition)
    F = IntegersModP(MODULUS)
    MV = multivariates_over(F, 4)               # a, b, a', b'
    a, b, a_n, b_n = MV.variables()
    constraints = [a_n - b, b_n - (a ** 2 + b ** 2)]
    transition = compile_transition(constraints, width=2, num_constants=0)
    return AIR(width=2, step_fn=_step, transition=transition,
               num_constraints=2, constants=[], boundary_points=_boundaries)


def fib_square_output(a0: int, b0: int, steps: int) -> int:
    a, b = a0 % MODULUS, b0 % MODULUS
    for _ in range(steps - 1):
        a, b = b, (a * a + b * b) % MODULUS
    return b
