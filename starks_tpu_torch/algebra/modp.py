"""IntegersModP: memoized class factory for Z/pZ with operator overloads
(the port's own copy of `starks_tpu/algebra/modp.py`).

Capability-parallel to the reference's `starks/modp.py` /
`starks/numbertype.py` (SURVEY.md §3.1 'Field/ring class stack'): calling
`IntegersModP(p)` returns a CLASS whose instances are elements of Z/pZ
with full numeric-operator semantics, so generic polynomial / extension-
field code is field-agnostic. Factory results are cached so
`IntegersModP(p) is IntegersModP(p)` and equality/isinstance checks work
across call sites.
"""

import functools

from .euclidean import mod_inverse


@functools.lru_cache(maxsize=None)
def IntegersModP(p: int):
    assert p > 1, "modulus must be > 1"

    class ModP:
        modulus = p
        __slots__ = ("value",)

        def __init__(self, value):
            if isinstance(value, ModP):
                value = value.value
            self.value = int(value) % p

        # -- ring structure --------------------------------------------
        def __add__(self, other):
            return ModP(self.value + _lift(other))

        def __radd__(self, other):
            return ModP(_lift(other) + self.value)

        def __sub__(self, other):
            return ModP(self.value - _lift(other))

        def __rsub__(self, other):
            return ModP(_lift(other) - self.value)

        def __mul__(self, other):
            return ModP(self.value * _lift(other))

        def __rmul__(self, other):
            return ModP(_lift(other) * self.value)

        def __neg__(self):
            return ModP(-self.value)

        def __pow__(self, e: int):
            if e < 0:
                return self.inverse() ** (-e)
            return ModP(pow(self.value, e, p))

        def inverse(self):
            return ModP(mod_inverse(self.value, p))

        def __truediv__(self, other):
            other = other if isinstance(other, ModP) else ModP(other)
            return self * other.inverse()

        def __rtruediv__(self, other):
            return ModP(other) * self.inverse()

        # divmod support so ModP works as a Euclidean-domain scalar in
        # generic gcd code (every nonzero element divides exactly).
        def __divmod__(self, other):
            return self / other, ModP(0)

        # -- comparisons / hashing -------------------------------------
        def __eq__(self, other):
            if isinstance(other, ModP):
                return self.value == other.value
            if isinstance(other, int):
                return self.value == other % p
            return NotImplemented

        def __ne__(self, other):
            eq = self.__eq__(other)
            return NotImplemented if eq is NotImplemented else not eq

        def __hash__(self):
            return hash((p, self.value))

        def __bool__(self):
            return self.value != 0

        def __int__(self):
            return self.value

        def __repr__(self):
            return f"{self.value} (mod {p})"

    def _lift(x):
        if isinstance(x, ModP):
            return x.value
        if isinstance(x, int):
            return x
        raise TypeError(f"cannot coerce {type(x).__name__} into Z/{p}")

    ModP.__name__ = f"IntegersMod{p}"
    ModP.zero = classmethod(lambda cls: cls(0))
    ModP.one = classmethod(lambda cls: cls(1))
    return ModP
