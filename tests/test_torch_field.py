"""The port's plain field arithmetic (starks_tpu_torch.ops.limbs) against
the JAX package's XLA limb kernels (starks_tpu.ops.limbs), exactly."""

import random

import jax
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
