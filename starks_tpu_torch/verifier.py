"""MiMC STARK verifier (the port's own copy of `starks_tpu/verifier.py`).

Host-scalar implementation of `starks/stark.py :: verify_mimc_proof` and
`starks/fri.py :: verify_low_degree_proof` (SURVEY.md §4.2/§4.3): the
verifier is O(queries * polylog) bigint work, so it stays on the host.
Accepts exactly the proof objects produced by starks_tpu_torch.prover
(and, by bit-compatibility, by starks_tpu and the spec oracle)."""

import hashlib

from .transcript import (blake, pseudorandom_indices, challenge_int,
                         special_x, is_a_power_of_2)
from .utils import hostfield as hf

from .config import StarkConfig, REFERENCE

MODULUS = REFERENCE.modulus
EXTENSION_FACTOR = REFERENCE.extension_factor
SPOT_CHECK_SECURITY_FACTOR = REFERENCE.spot_checks
GENERATOR = REFERENCE.generator
FRI_QUERIES = REFERENCE.fri_queries
FRI_BASE_CUTOFF = REFERENCE.fri_base_cutoff


class VerificationError(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise VerificationError(msg)


def verify_branch(root: bytes, index: int, branch, as_int: bool = False):
    """Recompute a Merkle path bottom-up; leaf count = 2^(len-1)."""
    index += 2 ** (len(branch) - 1)
    v = branch[0]
    for sibling in branch[1:]:
        if index % 2:
            v = blake(sibling + v)
        else:
            v = blake(v + sibling)
        index //= 2
    _check(v == root, "merkle branch mismatch")
    return int.from_bytes(branch[0], 'big') if as_int else branch[0]


def _merkle_root_of(leaves) -> bytes:
    nodes = [b''] * len(leaves) + [
        x.to_bytes(32, 'big') if isinstance(x, int) else x for x in leaves]
    for i in range(len(leaves) - 1, 0, -1):
        nodes[i] = blake(nodes[2 * i] + nodes[2 * i + 1])
    return nodes[1]


def verify_low_degree_proof(merkle_root: bytes, root_of_unity: int, proof,
                            maxdeg_plus_1: int,
                            exclude_multiples_of: int = 0,
                            config: StarkConfig = REFERENCE) -> bool:
    m = config.modulus
    roudeg = 1
    testval = root_of_unity
    while testval != 1:
        roudeg *= 2
        testval = testval * testval % m

    quartic_roots = [1,
                     pow(root_of_unity, roudeg // 4, m),
                     pow(root_of_unity, roudeg // 2, m),
                     pow(root_of_unity, roudeg * 3 // 4, m)]

    for component in proof[:-1]:
        root2, branches = component
        sx = special_x(merkle_root)
        ys = pseudorandom_indices(root2, roudeg // 4, config.fri_queries,
                                  exclude_multiples_of=exclude_multiples_of)
        # One batched inversion for the whole round's row x-coordinates
        # (multi_inv, SURVEY §3.1) instead of one ext-Euclid per query.
        x1s = [pow(root_of_unity, y, m) for y in ys]
        x1_invs = hf.multi_inv(x1s, m)
        for i, y in enumerate(ys):
            row = [verify_branch(merkle_root, y + (roudeg // 4) * j,
                                 branches[i][j + 1], as_int=True)
                   for j in range(4)]
            colval = verify_branch(root2, y, branches[i][0], as_int=True)
            poly = hf.interp4_coset(x1s[i], quartic_roots[1], row,
                                    x1_inv=x1_invs[i])
            _check(hf.eval_quartic(poly, sx) == colval,
                   "FRI fold inconsistency")
        merkle_root = root2
        root_of_unity = pow(root_of_unity, 4, m)
        maxdeg_plus_1 //= 4
        roudeg //= 4

    # Final round: direct degree check of the sent values.
    data = [int.from_bytes(x, 'big') for x in proof[-1]]
    _check(maxdeg_plus_1 <= config.fri_base_cutoff, "bad FRI termination")
    _check(_merkle_root_of(data) == merkle_root, "final FRI root mismatch")
    powers = [pow(root_of_unity, i, m) for i in range(len(data))]
    if exclude_multiples_of:
        pts = [x for x in range(len(data)) if x % exclude_multiples_of]
    else:
        pts = list(range(len(data)))
    poly = hf.interp_many([powers[x] for x in pts[:maxdeg_plus_1]],
                          [data[x] for x in pts[:maxdeg_plus_1]])
    for x in pts[maxdeg_plus_1:]:
        _check(hf.eval_poly_at(poly, powers[x]) == data[x],
               "final FRI values not low-degree")
    return True


def verify_mimc_proof(inp: int, steps: int, round_constants, output: int,
                      proof, config: StarkConfig = REFERENCE) -> bool:
    m_root, l_root, main_branches, lc_branches, fri_proof = proof
    m = config.modulus
    ext = config.extension_factor
    _check(steps <= 2**32 // ext, "steps too large")
    _check(is_a_power_of_2(steps) and is_a_power_of_2(len(round_constants)),
           "steps/constants not powers of 2")
    _check(len(round_constants) < steps, "too many constants")

    precision = steps * ext
    G2 = pow(config.generator, (m - 1) // precision, m)
    skips = precision // steps
    skips2 = steps // len(round_constants)

    mini_poly = hf.host_ntt(list(round_constants),
                            pow(G2, ext * skips2, m),
                            inverse=True)

    _check(verify_low_degree_proof(l_root, G2, fri_proof, steps * 2,
                                   exclude_multiples_of=ext, config=config),
           "FRI failed")

    k1 = challenge_int(m_root, 1)
    k2 = challenge_int(m_root, 2)
    k3 = challenge_int(m_root, 3)
    k4 = challenge_int(m_root, 4)
    positions = pseudorandom_indices(l_root, precision,
                                     config.spot_checks,
                                     exclude_multiples_of=ext)
    last = pow(G2, (steps - 1) * skips, m)

    i_poly = hf.line_through(1, inp % m, last, output % m)

    xs_all = [pow(G2, pos, m) for pos in positions]
    zden_invs = hf.multi_inv([x - last for x in xs_all], m)

    for i, pos in enumerate(positions):
        x = xs_all[i]
        x_steps = pow(x, steps, m)
        leaf1 = verify_branch(m_root, pos, main_branches[2 * i])
        leaf2 = verify_branch(m_root, (pos + skips) % precision,
                              main_branches[2 * i + 1])
        l_of_x = verify_branch(l_root, pos, lc_branches[i], as_int=True)
        p_of_x = int.from_bytes(leaf1[:32], 'big')
        d_of_x = int.from_bytes(leaf1[32:64], 'big')
        b_of_x = int.from_bytes(leaf1[64:], 'big')
        p_of_g1x = int.from_bytes(leaf2[:32], 'big')

        z = (x_steps - 1) * zden_invs[i] % m
        k_of_x = hf.eval_poly_at(mini_poly, pow(x, skips2, m))

        # Transition: P(g1 x) - P(x)^3 - K(x) = Z(x) D(x).
        _check((p_of_g1x - p_of_x ** 3 - k_of_x - z * d_of_x) % m == 0,
               f"transition constraint fails at {pos}")
        # Boundary: P(x) - B(x)(x-1)(x-last) - I(x) = 0.
        z2 = (x - 1) * (x - last) % m
        _check((p_of_x - b_of_x * z2 - hf.eval_poly_at(i_poly, x)) % m == 0,
               f"boundary constraint fails at {pos}")
        # Linear combination consistency.
        _check((l_of_x - d_of_x - k1 * p_of_x - k2 * p_of_x * x_steps
                - k3 * b_of_x - k4 * b_of_x * x_steps) % m == 0,
               f"linear combination fails at {pos}")
    return True
