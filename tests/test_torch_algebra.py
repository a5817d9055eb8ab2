"""The port's algebra class stack (starks_tpu_torch.algebra: generic
polynomials and GF(p^m)) against the JAX package's classes, on seeded
cases: every result is compared as coefficient ints."""

import operator
import random

import pytest

from starks_tpu.algebra import finite_field as jff
from starks_tpu.algebra import IntegersModP as JIntegersModP
from starks_tpu.algebra import polynomials_over as jpolynomials_over
from starks_tpu_torch.algebra import (FiniteField, IntegersModP,
                                      polynomials_over)
from starks_tpu_torch.algebra import finite_field as ff

# (p, m, modulus coefficients or None for the generated one, seed)
CASES = [(13, 2, None, 1), (3, 2, (1, 0, 1), 2), (2 ** 31 - 1, 1, None, 3),
         (2, 4, None, 4), (7, 3, None, 5)]


def _ints(poly):
    return [int(c) for c in poly.coefficients]


def _elem(x):
    return _ints(x.poly)


@pytest.mark.parametrize("p,m,modulus,seed", CASES,
                         ids=[f"GF({p}^{m})" for p, m, _, _ in CASES])
def test_algebra_matches_jax(p, m, modulus, seed):
    rng = random.Random(seed)
    port_poly = polynomials_over(IntegersModP(p))
    jax_poly = jpolynomials_over(JIntegersModP(p))

    def rand_coeffs(deg):
        return [rng.randrange(p) for _ in range(deg + 1)]

    # Ring operations, divmod, gcd, powers and evaluation.
    for _ in range(12):
        a, b = rand_coeffs(rng.randrange(6)), rand_coeffs(rng.randrange(4))
        pa, pb, ja, jb = port_poly(a), port_poly(b), jax_poly(a), jax_poly(b)
        for op in (operator.add, operator.sub, operator.mul):
            assert _ints(op(pa, pb)) == _ints(op(ja, jb))
        assert _ints(pa ** 3) == _ints(ja ** 3)
        x = rng.randrange(p)
        assert int(pa(x)) == int(ja(x))
        if not pb.is_zero():
            (pq, pr), (jq, jr) = divmod(pa, pb), divmod(ja, jb)
            assert (_ints(pq), _ints(pr)) == (_ints(jq), _ints(jr))
            assert _ints(pa.gcd(pb)) == _ints(ja.gcd(jb))
            if pb.degree() > 0:
                assert _ints(pa.powmod(p + 2, pb)) == _ints(
                    ja.powmod(p + 2, jb))

    # Irreducibility and the seeded search for an irreducible modulus.
    if m > 1:
        for _ in range(6):
            monic = rand_coeffs(m - 1) + [1]
            assert (ff.is_irreducible(port_poly(monic), p)
                    == jff.is_irreducible(jax_poly(monic), p))
    assert _ints(ff.generate_irreducible_polynomial(p, m, seed)) == _ints(
        jff.generate_irreducible_polynomial(p, m, seed))

    # GF(p^m): the same modulus, then field operations and inverses.
    port_f, jax_f = FiniteField(p, m, modulus), jff.FiniteField(p, m,
                                                                modulus)
    assert _ints(port_f.ideal_generator) == _ints(jax_f.ideal_generator)
    for _ in range(12):
        u, v = rand_coeffs(m - 1), rand_coeffs(m - 1)
        pu, pv, ju, jv = port_f(u), port_f(v), jax_f(u), jax_f(v)
        for op in (operator.add, operator.sub, operator.mul):
            assert _elem(op(pu, pv)) == _elem(op(ju, jv))
        assert _elem(pu ** 5) == _elem(ju ** 5)
        assert (pu == pv) == (ju == jv)
        if pv:
            assert _elem(pu / pv) == _elem(ju / jv)
            assert _elem(pv.inverse()) == _elem(jv.inverse())
            assert _elem(pv ** -2) == _elem(jv ** -2)
            assert pv * pv.inverse() == port_f(1)
    with pytest.raises(ZeroDivisionError):
        port_f(0).inverse()
