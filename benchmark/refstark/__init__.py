"""refstark: the benchmark's plain reference of the MiMC STARK prover.

Plain PyTorch and Python ints, written from the protocol of
ethereum/research mimc_stark/ as computablelabs/starks packages it. It
imports nothing of the program under test, of its JAX original or of
the repository's oracle, and takes nothing the program made: the
harness hands it the claims alone, and it derives everything else.
"""

from .stark import Setup, prove, mimc_trace

__all__ = ["Setup", "prove", "mimc_trace"]
