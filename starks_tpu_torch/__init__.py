"""starks_tpu_torch: the STARK prover on PyTorch and CUDA (NVIDIA Hopper).

A port of `starks_tpu` that imports neither JAX nor `starks_tpu`. It
covers the single-device MiMC proof, batch proving and general AIR
proofs: `mk_mimc_proof`, `mk_mimc_proof_batch_fused` and
`prove_air_batch_fused` (many claims over a claim axis) and
`prove_air` run the hand-written CUDA kernels of csrc/ on the card (or
their plain PyTorch versions with `device="cpu"`) and produce proofs
byte-identical to the reference;
`verify_mimc_proof` and `verify_air` check them on the host.
`prover.mk_mimc_proof_fused(..., device_trace=True)` is the all-device
MiMC proof: its trace is built on the card by one kernel launch, none
of it on the host. With a
`mesh` (`parallel.mesh.make_mesh` over a `torch.distributed` group),
`mk_mimc_proof`, `mk_mimc_proof_with_trace`, `prove_batch` and
`prove_low_degree` (FRI alone, checked by `verify_low_degree_proof`)
shard the evaluation domain over the mesh's ranks, with the four-step
NTT (parallel/ntt4step.py) and sharded trees and FRI rounds; `python -m
starks_tpu_torch.parallel.launch prove STEPS RANKS` proves one claim so
on new ranks, one per card, against the one-card proof.
`prove_batch` adds resume from a proof store (utils/artifacts.py),
self-verification and retries through `mk_mimc_proof_with_trace`;
`serialize_proof` and `deserialize_proof` are the wire format. The
Fibonacci-square AIR is in `starks_tpu_torch.models.fib_square`; the
MiMC permutation's backward direction (`models.mimc.mimc_backward`)
and the traces of a claim batch on the card
(`models.mimc.trace_batch_device`) in `models.mimc`; and the algebra
class stack (`IntegersModP`, `FiniteField`, `polynomials_over`,
`multivariates_over`) in `starks_tpu_torch.algebra`.
"""

from .config import StarkConfig, REFERENCE
from .prover import (MODULUS, mk_mimc_proof, mk_mimc_proof_with_trace,
                     mk_mimc_proof_batch_fused, prove_low_degree)
from .verifier import (verify_mimc_proof, verify_low_degree_proof,
                       VerificationError)
from .models.mimc import mimc_forward
from .air import AIR, prove_air, prove_air_batch_fused, verify_air
from .parallel.batch import prove_batch, verify_batch
# serialize / deserialize under other names, so that they do not shadow
# the `serialize` submodule (as in the JAX package).
from .serialize import (serialize as serialize_proof,
                        deserialize as deserialize_proof, bin_length,
                        raw_length)

__all__ = ["StarkConfig", "REFERENCE", "MODULUS", "mk_mimc_proof",
           "mk_mimc_proof_with_trace", "mk_mimc_proof_batch_fused",
           "prove_low_degree", "verify_mimc_proof",
           "verify_low_degree_proof", "VerificationError", "mimc_forward",
           "AIR", "prove_air", "prove_air_batch_fused", "verify_air",
           "prove_batch", "verify_batch", "serialize_proof",
           "deserialize_proof", "bin_length", "raw_length"]
