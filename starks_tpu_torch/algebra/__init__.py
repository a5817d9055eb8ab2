"""The algebra the declarative AIR form needs: Z/pZ, the extended
Euclidean algorithm, multivariate polynomials and `compile_transition`
(the port's own copies of the `starks_tpu/algebra` modules on that
path). Pure Python, off the hot path: constraints written here lower to
the AIR `ops` namespace (air.py), whose device form runs the kernels.
"""

from .euclidean import extended_gcd, mod_inverse
from .modp import IntegersModP
from .multivariate import multivariates_over, compile_transition

__all__ = ["extended_gcd", "mod_inverse", "IntegersModP",
           "multivariates_over", "compile_transition"]
