"""MiMC permutation: forward and backward functions, host and device
traces.

The canonical single-register AIR instance (SURVEY §3.1 `starks/mimc.py`):
steps-1 rounds of x <- x^3 + c[i mod len(c)] (mod p); `mimc_backward`
runs them in reverse (the slow direction of the VDF). The trace is
sequential per proof, so the provers build it on the host, in the
native runtime (`trace_limbs`; `trace_host` is its plain bigint
version), and upload it whole (2 MB at 2^16 steps). `trace_batch_device`
runs the traces of a claim batch on the card instead, one thread per
claim (a step a dependent chain); the all-device proof (`prover.mk_mimc_proof_fused(device_trace=
True)`) takes its trace from it.
"""

from ..ops import plimbs
from ..utils import native
from ..utils.conversions import ints_to_tensor

MODULUS = 2**256 - 351 * 2**32 + 1

# Cube-root exponent: gcd(3, p-1) = 1 for this field, so x -> x^3 is a
# permutation and its inverse is x -> x^D with D = 3^(-1) mod (p-1).
_CUBE_ROOT_EXP = pow(3, -1, MODULUS - 1)


def mimc_forward(inp: int, steps: int, round_constants) -> int:
    for i in range(steps - 1):
        inp = (inp ** 3 + round_constants[i % len(round_constants)]) % MODULUS
    return inp


def mimc_backward(out: int, steps: int, round_constants) -> int:
    """Inverse MiMC permutation (the slow VDF direction, one 256-bit
    exponentiation a round): x_i = (x_{i+1} - c[i mod n_c])^(3^-1 mod
    p-1), run backwards. Satisfies mimc_forward(mimc_backward(y)) == y."""
    x = out % MODULUS
    for i in range(steps - 2, -1, -1):
        c = round_constants[i % len(round_constants)]
        x = pow((x - c) % MODULUS, _CUBE_ROOT_EXP, MODULUS)
    return x


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


def trace_batch_device(inps, steps: int, round_constants, device=None):
    """The traces of a claim batch on the device: [B, steps, 8] int32 in
    the port's claim-major layout, row i of claim c its state after i
    rounds from inps[c]. The counterpart of the JAX package's
    `trace_batch_device` (starks_tpu/models/mimc.py:73, a `lax.scan`
    over [steps, B, 16] limbs), run by `plimbs.mimc_trace`: one kernel
    launch, a thread per claim. The all-device proof
    (`prover.mk_mimc_proof_fused(device_trace=True)`) takes its trace
    from here, as the JAX package's device-trace core takes it from its
    scan; the other provers take theirs from `trace_limbs`. `device`
    None means "cuda"; `device="cpu"` runs the plain version. The
    inputs and constants go up through pinned memory on the current
    stream, so the host does not wait for the card."""
    from ..prover import _resolve_device, _upload
    device = _resolve_device(device)
    x0 = _upload(ints_to_tensor([x % MODULUS for x in inps]), device)
    consts = _upload(ints_to_tensor([c % MODULUS for c in round_constants]),
                     device)
    return plimbs.mimc_trace(x0, consts, steps)


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
