"""The algebra class stack: Z/pZ, GF(p^m), generic univariate and
multivariate polynomials, the extended Euclidean algorithm and
`compile_transition` (the port's own copies of the `starks_tpu/algebra`
modules). Pure Python, off the hot path: constraints written here lower
to the AIR `ops` namespace (air.py), whose device form runs the kernels.
"""

from .euclidean import extended_gcd, mod_inverse
from .modp import IntegersModP
from .polynomial import polynomials_over
from .finite_field import FiniteField
from .multivariate import multivariates_over, compile_transition

__all__ = ["extended_gcd", "mod_inverse", "IntegersModP",
           "polynomials_over", "FiniteField", "multivariates_over",
           "compile_transition"]
