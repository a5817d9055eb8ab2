"""starks_tpu_torch: the STARK prover on PyTorch and CUDA (NVIDIA Hopper).

A port of `starks_tpu` that imports neither JAX nor `starks_tpu`. It
covers the single-device MiMC proof and general AIR proofs:
`mk_mimc_proof` and `prove_air` run the hand-written CUDA kernels of
csrc/ on the card (or their plain PyTorch versions with
`device="cpu"`) and produce proofs byte-identical to the reference;
`verify_mimc_proof` and `verify_air` check them on the host. The
Fibonacci-square AIR is in `starks_tpu_torch.models.fib_square`.
"""

from .config import StarkConfig, REFERENCE
from .prover import mk_mimc_proof
from .verifier import verify_mimc_proof, VerificationError
from .models.mimc import mimc_forward
from .air import AIR, prove_air, verify_air

__all__ = ["StarkConfig", "REFERENCE", "mk_mimc_proof", "verify_mimc_proof",
           "VerificationError", "mimc_forward", "AIR", "prove_air",
           "verify_air"]
