"""starks_tpu_torch: the STARK prover on PyTorch and CUDA (NVIDIA Hopper).

A port of `starks_tpu` that imports neither JAX nor `starks_tpu`. This
slice covers the single-device MiMC proof: `mk_mimc_proof` runs the
hand-written CUDA kernels of csrc/ on the card (or their plain PyTorch
versions with `device="cpu"`) and produces proofs byte-identical to the
reference; `verify_mimc_proof` checks them on the host.
"""

from .config import StarkConfig, REFERENCE
from .prover import mk_mimc_proof
from .verifier import verify_mimc_proof, VerificationError
from .models.mimc import mimc_forward

__all__ = ["StarkConfig", "REFERENCE", "mk_mimc_proof", "verify_mimc_proof",
           "VerificationError", "mimc_forward"]
