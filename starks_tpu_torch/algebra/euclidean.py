"""Extended Euclidean algorithms for integers and ring elements (the
port's own copy of `starks_tpu/algebra/euclidean.py`).

Equivalent capability to the reference's `starks/euclidean.py`
(SURVEY.md §3.1): gcd/Bezout over the integers (modular inverses in
Z/pZ for any modulus, prime or not) and over any Euclidean domain whose
elements support divmod (used for polynomial gcd in GF(p^m) inversion
and irreducibility testing).
"""


def extended_gcd(a: int, b: int):
    """Return (g, x, y) with a*x + b*y == g == gcd(a, b)."""
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r != 0:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t


def mod_inverse(a: int, modulus: int) -> int:
    """Inverse of a in Z/modulus; raises ZeroDivisionError if not a unit."""
    g, x, _ = extended_gcd(a % modulus, modulus)
    if g != 1 and g != -1:
        raise ZeroDivisionError(f"{a} is not invertible mod {modulus}")
    return (x * g) % modulus   # g==-1 flips the sign so the result is right


def poly_extended_gcd(a, b):
    """Extended gcd over a polynomial ring with divmod and bool-testable
    zero. Returns (g, x, y) with a*x + b*y == g; g is NOT normalized to
    monic — callers divide by the lead coefficient when they need that."""
    zero, one = a.ring.zero(), a.ring.one()
    old_r, r = a, b
    old_s, s = one, zero
    old_t, t = zero, one
    while r:
        q, rem = divmod(old_r, r)
        old_r, r = r, rem
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t
