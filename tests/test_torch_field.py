"""The port's plain field arithmetic (starks_tpu_torch.ops.limbs) against
the JAX package's XLA limb kernels (starks_tpu.ops.limbs), exactly."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starks_tpu.ops import limbs as jfl
from starks_tpu.utils.conversions import ints_to_limbs
from starks_tpu_torch.ops import limbs as fl
from starks_tpu_torch.utils.conversions import (ints_to_tensor,
                                                tensor_to_ints)

M = fl.MODULUS
EDGE = [0, 1, 2, M - 1, M - 2, 2 ** 255, (1 << 240) - 1]


def _operands():
    """Seeded random pairs plus every pair of edge values."""
    r = random.Random(7)
    a = [r.randrange(M) for _ in range(256)]
    b = [r.randrange(M) for _ in range(256)]
    a += [x for x in EDGE for _ in EDGE]
    b += [y for _ in EDGE for y in EDGE]
    return a, b


_OPS = {
    "add": (fl.add, jax.jit(jfl.add)),
    "sub": (fl.sub, jax.jit(jfl.sub)),
    "mul": (fl.mul, jax.jit(jfl.mul)),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_binary_op_matches_jax(op):
    a, b = _operands()
    port_fn, jax_fn = _OPS[op]
    want = np.asarray(jax_fn(ints_to_limbs(a), ints_to_limbs(b)))
    got = port_fn(ints_to_tensor(a), ints_to_tensor(b))
    assert np.array_equal(fl.to_jax_limbs(got), want)


def test_cube_matches_jax():
    a, _ = _operands()
    want = np.asarray(jax.jit(jfl.cube)(ints_to_limbs(a)))
    assert np.array_equal(fl.to_jax_limbs(fl.cube(ints_to_tensor(a))), want)


def test_div4_matches_jax_mul_by_inverse_of_4():
    """The exact division fold4 ends with equals JAX's multiply by 1/4
    (the last step of its fold), on every residue of x mod 4."""
    a, _ = _operands()
    a += [M - 3, M - 4, 3, 4, 5]
    inv4 = pow(4, M - 2, M)
    want = np.asarray(jax.jit(jfl.mul)(ints_to_limbs(a),
                                       ints_to_limbs([inv4] * len(a))))
    got = fl.from_limbs16(fl.div4_16(fl.to_limbs16(ints_to_tensor(a))))
    assert np.array_equal(fl.to_jax_limbs(got), want)
    assert tensor_to_ints(got) == [x * inv4 % M for x in a]


def test_jax_limbs_round_trip():
    a, _ = _operands()
    limbs = ints_to_limbs(a)
    t = fl.from_jax_limbs(limbs)
    assert t.dtype == torch.int32 and t.shape == (len(a), 8)
    assert tensor_to_ints(t) == a
    assert np.array_equal(fl.to_jax_limbs(t), limbs)


def test_limbs16_round_trip():
    a, _ = _operands()
    t = ints_to_tensor(a)
    assert torch.equal(fl.from_limbs16(fl.to_limbs16(t)), t)


def test_cond_sub_p_canonicalizes_digests():
    vals = [0, M - 1, M, M + 5, 2 ** 256 - 1]
    got = tensor_to_ints(fl.cond_sub_p(ints_to_tensor(vals)))
    assert got == [v % M for v in vals]


# tests/test_limbs.py's inputs: its edge values, then values from its
# seeded generator.
LIMBS_EDGE = [0, 1, 2, 3, M - 1, M - 2, (M - 1) // 2, 2 ** 255, 2 ** 128,
              2 ** 16 - 1, 2 ** 16, 2 ** 255 + 2 ** 33, 351 * 2 ** 32 - 1,
              351 * 2 ** 32, M - 351 * 2 ** 32]


ROOT_64 = pow(7, (M - 1) // 64, M)


def _limbs_inputs(n):
    r = random.Random(7)
    return (LIMBS_EDGE + [r.randrange(M) for _ in range(n)])[:n]


def _helper_cases(name):
    """(port function, JAX function, JAX limbs input) for each case of
    `name`: tests/test_limbs.py's inputs and the edges 0, 1, p - 1,
    p - 2 (one array: each JAX function compiles once per shape and
    exponent)."""
    x = ints_to_limbs(_limbs_inputs(64) + [0, 1, M - 1, M - 2])
    if name == "pow_const":
        # Every exponent in one jitted function: one compile, not three.
        exps = (0xDEADBEEF12345, 0, M - 2)
        return [(lambda t: torch.stack([fl.pow_const(t, e) for e in exps]),
                 jax.jit(lambda t: jnp.stack([jfl.pow_const(t, e)
                                              for e in exps])), x)]
    if name == "powers_series":
        # Not jitted: its eager ops compile once per shape (1 and 2
        # elements) for every case, where a jitted form compiles anew
        # for each n. 4 powers take two doublings, 3 a truncation.
        return [(lambda g, n=n: fl.powers_series(g[0], n),
                 lambda g, n=n: jfl.powers_series(g[0], n),
                 ints_to_limbs([g]))
                for n in (4, 3) for g in (ROOT_64, 0, 1, M - 1, M - 2)]
    port, jax_fn = {"neg": (fl.neg, jfl.neg), "sqr": (fl.sqr, jfl.sqr),
                    "eq_zero": (fl.eq_zero, jfl.eq_zero)}[name]
    return [(port, jax.jit(jax_fn), x)]


@pytest.mark.parametrize("name", ["neg", "sqr", "pow_const", "powers_series",
                                  "eq_zero"])
def test_field_helper_matches_jax(name):
    """The port's plain neg, sqr, pow_const, powers_series and eq_zero
    equal the JAX package's (starks_tpu/ops/limbs.py) on the same
    inputs, through from_jax_limbs / to_jax_limbs."""
    for port, jax_fn, x in _helper_cases(name):
        want = np.asarray(jax_fn(x))
        got = port(fl.from_jax_limbs(x))
        if name == "eq_zero":
            assert np.array_equal(got.numpy(), want)
        else:
            assert np.array_equal(fl.to_jax_limbs(got), want)


def test_powers_series_of_a_root_of_unity():
    """The 64 powers of a 64th root of unity (tests/test_limbs.py's case),
    against Python ints: the JAX side at this size compiles for ~20 s."""
    got = tensor_to_ints(fl.powers_series(ints_to_tensor([ROOT_64]), 64))
    assert got == [pow(ROOT_64, i, M) for i in range(64)]
