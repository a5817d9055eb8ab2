"""FiniteField(p, m): GF(p^m) as polynomials modulo a generated
irreducible polynomial (the port's own copy of
`starks_tpu/algebra/finite_field.py`).

Capability-parallel to the reference's `starks/finite_field.py`
(SURVEY.md §3.1): a memoized class factory producing extension-field
element classes with full operator overloads, probabilistic (Rabin)
irreducibility testing, and deterministic-seeded irreducible-polynomial
generation so `FiniteField(p, m)` is reproducible across processes.
Inversion runs the extended Euclidean algorithm over the polynomial ring.
"""

import functools
import random

from .euclidean import poly_extended_gcd
from .modp import IntegersModP
from .polynomial import polynomials_over


def _prime_divisors(n: int):
    out, d = [], 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def is_irreducible(poly, p: int) -> bool:
    """Rabin's test: monic f of degree m over F_p is irreducible iff
    x^(p^m) == x (mod f) and gcd(x^(p^(m/d)) - x, f) == 1 for every prime
    divisor d of m."""
    Poly = poly.ring
    m = poly.degree()
    assert m >= 1
    x = Poly.x()
    for d in _prime_divisors(m):
        h = x.powmod(p ** (m // d), poly) - x
        if h.gcd(poly).degree() != 0:
            return False
    return x.powmod(p ** m, poly) == x % poly


def generate_irreducible_polynomial(p: int, m: int, seed: int = 0):
    """Deterministic search for a monic irreducible of degree m over F_p
    (seeded randomness so repeated calls agree across processes)."""
    Fp = IntegersModP(p)
    Poly = polynomials_over(Fp)
    if m == 1:
        return Poly.x()
    rng = random.Random((p, m, seed).__hash__())
    while True:
        coeffs = [Fp(rng.randrange(p)) for _ in range(m)] + [Fp(1)]
        candidate = Poly(coeffs)
        if is_irreducible(candidate, p):
            return candidate


@functools.lru_cache(maxsize=None)
def FiniteField(p: int, m: int, polynomial_coeffs: tuple = None):
    """Return the element class of GF(p^m). If `polynomial_coeffs` (tuple
    of ints, lowest-first, length m+1, monic) is given it is used as the
    field modulus; otherwise one is generated deterministically."""
    Fp = IntegersModP(p)
    Poly = polynomials_over(Fp)
    if polynomial_coeffs is not None:
        modulus_poly = Poly(polynomial_coeffs)
        assert modulus_poly.degree() == m, "modulus degree != m"
        assert is_irreducible(modulus_poly, p), "modulus is reducible"
    else:
        modulus_poly = generate_irreducible_polynomial(p, m)

    class Fq:
        field_size = p ** m
        prime_subfield = Fp
        ideal_generator = modulus_poly
        __slots__ = ("poly",)

        def __init__(self, value=0):
            if isinstance(value, Fq):
                self.poly = value.poly
            elif isinstance(value, Poly):
                self.poly = value % modulus_poly
            elif isinstance(value, (list, tuple)):
                self.poly = Poly(value) % modulus_poly
            else:
                self.poly = Poly((Fp(value),))

        def degree(self):
            return self.poly.degree()

        # -- field ops ---------------------------------------------------
        def __add__(self, other):
            return Fq(self.poly + Fq(other).poly)

        __radd__ = __add__

        def __sub__(self, other):
            return Fq(self.poly - Fq(other).poly)

        def __rsub__(self, other):
            return Fq(Fq(other).poly - self.poly)

        def __mul__(self, other):
            return Fq((self.poly * Fq(other).poly) % modulus_poly)

        __rmul__ = __mul__

        def __neg__(self):
            return Fq(-self.poly)

        def __pow__(self, e: int):
            if e < 0:
                return self.inverse() ** (-e)
            return Fq(self.poly.powmod(e, modulus_poly))

        def inverse(self):
            if not self.poly:
                raise ZeroDivisionError("inverse of 0 in GF(p^m)")
            g, x, _ = poly_extended_gcd(self.poly, modulus_poly)
            assert g.degree() == 0, "element not coprime to field modulus"
            return Fq(x * g.leading_coefficient().inverse())

        def __truediv__(self, other):
            return self * Fq(other).inverse()

        def __rtruediv__(self, other):
            return Fq(other) * self.inverse()

        def __divmod__(self, other):
            return self / other, Fq(0)

        # -- comparisons --------------------------------------------------
        def __eq__(self, other):
            if isinstance(other, (Fq, int, list, tuple, Poly)):
                return self.poly == Fq(other).poly
            return NotImplemented

        def __ne__(self, other):
            eq = self.__eq__(other)
            return NotImplemented if eq is NotImplemented else not eq

        def __hash__(self):
            return hash((p, m, self.poly))

        def __bool__(self):
            return bool(self.poly)

        def __repr__(self):
            return f"[{self.poly!r}] in GF({p}^{m})"

    Fq.__name__ = f"GF({p}^{m})"
    Fq.zero = classmethod(lambda cls: cls(0))
    Fq.one = classmethod(lambda cls: cls(1))
    return Fq
