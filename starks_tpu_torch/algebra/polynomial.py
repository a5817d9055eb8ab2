"""polynomials_over(field): generic univariate polynomials over any field
(the port's own copy of `starks_tpu/algebra/polynomial.py`).

Capability-parallel to the reference's `starks/polynomial.py`
(SURVEY.md §3.1 'Generic polynomials'): coefficient-vector polynomials
(lowest degree first, trailing zeros stripped) with +, -, *, divmod, %,
**, evaluation, and gcd — over any coefficient class exposing operator
overloads and zero/one (e.g. `IntegersModP(p)`, or GF(p^m) elements for
towers). Used by the extension-field construction and by spec-level
constraint manipulation; the prover's hot path never touches it.
"""

import functools
import itertools


@functools.lru_cache(maxsize=None)
def polynomials_over(field):

    class Polynomial:
        coefficient_field = field
        __slots__ = ("coefficients",)

        def __init__(self, coefficients=()):
            coeffs = [c if not isinstance(c, int) else field(c)
                      for c in coefficients]
            while coeffs and not coeffs[-1]:
                coeffs.pop()
            self.coefficients = tuple(coeffs)

        # `ring` lets generic euclidean code construct zero/one.
        @property
        def ring(self):
            return Polynomial

        @classmethod
        def zero(cls):
            return cls(())

        @classmethod
        def one(cls):
            return cls((field(1),))

        @classmethod
        def x(cls):
            return cls((field(0), field(1)))

        def degree(self) -> int:
            """Degree; -1 for the zero polynomial."""
            return len(self.coefficients) - 1

        def leading_coefficient(self):
            return self.coefficients[-1] if self.coefficients else field(0)

        def is_zero(self) -> bool:
            return not self.coefficients

        def __bool__(self):
            return bool(self.coefficients)

        # -- arithmetic --------------------------------------------------
        def __add__(self, other):
            other = _coerce(other)
            pairs = itertools.zip_longest(self.coefficients,
                                          other.coefficients,
                                          fillvalue=field(0))
            return Polynomial([a + b for a, b in pairs])

        __radd__ = __add__

        def __neg__(self):
            return Polynomial([-c for c in self.coefficients])

        def __sub__(self, other):
            return self + (-_coerce(other))

        def __rsub__(self, other):
            return _coerce(other) + (-self)

        def __mul__(self, other):
            other = _coerce(other)
            if self.is_zero() or other.is_zero():
                return Polynomial(())
            out = [field(0)] * (len(self.coefficients)
                                + len(other.coefficients) - 1)
            for i, a in enumerate(self.coefficients):
                for j, b in enumerate(other.coefficients):
                    out[i + j] = out[i + j] + a * b
            return Polynomial(out)

        __rmul__ = __mul__

        def __divmod__(self, divisor):
            divisor = _coerce(divisor)
            if divisor.is_zero():
                raise ZeroDivisionError("polynomial division by zero")
            rem = list(self.coefficients)
            dd = divisor.degree()
            lead_inv = divisor.leading_coefficient().inverse()
            quot = [field(0)] * max(0, len(rem) - dd)
            for i in range(len(rem) - dd - 1, -1, -1):
                q = rem[i + dd] * lead_inv
                quot[i] = q
                if q:
                    for j, c in enumerate(divisor.coefficients):
                        rem[i + j] = rem[i + j] - q * c
            return Polynomial(quot), Polynomial(rem[:dd])

        def __floordiv__(self, other):
            return divmod(self, other)[0]

        def __mod__(self, other):
            return divmod(self, other)[1]

        def __pow__(self, e: int):
            assert e >= 0
            result, base = Polynomial.one(), self
            while e:
                if e & 1:
                    result = result * base
                base = base * base
                e >>= 1
            return result

        def powmod(self, e: int, modulus):
            """self**e mod modulus without intermediate blowup."""
            assert e >= 0
            result, base = Polynomial.one(), self % modulus
            while e:
                if e & 1:
                    result = (result * base) % modulus
                base = (base * base) % modulus
                e >>= 1
            return result

        def gcd(self, other):
            """Monic gcd."""
            a, b = self, _coerce(other)
            while b:
                a, b = b, a % b
            if a.is_zero():
                return a
            return a * a.leading_coefficient().inverse()

        # -- evaluation / comparison -------------------------------------
        def __call__(self, x):
            acc = field(0)
            for c in reversed(self.coefficients):
                acc = acc * x + c
            return acc

        def __eq__(self, other):
            try:
                other = _coerce(other)
            except TypeError:
                return NotImplemented
            return self.coefficients == other.coefficients

        def __ne__(self, other):
            eq = self.__eq__(other)
            return NotImplemented if eq is NotImplemented else not eq

        def __hash__(self):
            return hash((field, self.coefficients))

        def __repr__(self):
            if self.is_zero():
                return "0"
            terms = []
            for i, c in enumerate(self.coefficients):
                if not c:
                    continue
                if i == 0:
                    terms.append(f"{c}")
                elif i == 1:
                    terms.append(f"({c}) x")
                else:
                    terms.append(f"({c}) x^{i}")
            return " + ".join(terms)

    def _coerce(x):
        if isinstance(x, Polynomial):
            return x
        if isinstance(x, (int, field)):
            return Polynomial((x,))
        raise TypeError(
            f"cannot coerce {type(x).__name__} into polynomials over "
            f"{field.__name__}")

    Polynomial.__name__ = f"Polynomial over {field.__name__}"
    return Polynomial
