"""The port's whole slice on the CPU: mk_mimc_proof with the plain
versions of the kernels equals the spec oracle's proof byte for byte, and
both the port's verifier and the JAX package's verifier accept it."""

import random

import pytest

from oracle import fri as ofri
from oracle import stark as ostark
from oracle.merkle import merkelize
from starks_tpu import verifier as jverifier
import starks_tpu_torch as stt
from starks_tpu_torch.config import REFERENCE
from starks_tpu_torch.ops import fused
from starks_tpu_torch.prover import _FusedSetup
from starks_tpu_torch.utils import hostfield as hf
from starks_tpu_torch.utils.conversions import tensor_to_ints

CONSTS = [(i ** 7) ^ 42 for i in range(16)]
M = stt.MODULUS


@pytest.mark.parametrize("steps", [64, 256])
def test_proof_equals_oracle_and_verifies(steps):
    timings = {}
    got = stt.mk_mimc_proof(3, steps, CONSTS, device="cpu", timings=timings)
    assert got == ostark.mk_mimc_proof(3, steps, CONSTS)
    out = stt.mimc_forward(3, steps, CONSTS)
    assert stt.verify_mimc_proof(3, steps, CONSTS, out, got)
    assert jverifier.verify_mimc_proof(3, steps, CONSTS, out, got)
    assert {"lde", "fri", "proof transfer", "total"} <= set(timings)


def test_tampered_proof_is_rejected():
    proof = stt.mk_mimc_proof(5, 64, CONSTS, device="cpu")
    out = stt.mimc_forward(5, 64, CONSTS)
    leaf = bytearray(proof[2][0][0])
    leaf[0] ^= 1
    proof[2][0][0] = bytes(leaf)
    with pytest.raises(stt.VerificationError):
        stt.verify_mimc_proof(5, 64, CONSTS, out, proof)


def test_mesh_is_not_ported():
    """A `mesh` that is not a parallel.mesh.Mesh is refused (the name
    dates from before the sharded path was ported; that path is held to
    the oracle in tests/test_torch_parallel.py)."""
    with pytest.raises(TypeError, match="Mesh"):
        stt.mk_mimc_proof(3, 64, CONSTS, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        stt.prove_low_degree([0] * 64, 1, 32, mesh=object(), device="cpu")


def _low_degree_values(n, maxdeg, seed):
    """Evaluations over the n-th roots of unity of a random polynomial
    of degree < maxdeg, and the root."""
    g = pow(7, (M - 1) // n, M)
    rng = random.Random(seed)
    coeffs = [rng.randrange(M) for _ in range(maxdeg)] + [0] * (n - maxdeg)
    return hf.host_ntt(coeffs, g), g


@pytest.mark.parametrize("exclude", [0, 8])
def test_prove_low_degree_equals_oracle_and_verifies(exclude):
    """FRI alone at 2^10 points, maxdeg + 1 = 256: the port's proof
    equals `oracle.fri.prove_low_degree` byte for byte, and the port's
    verifier accepts it against the values' Merkle root."""
    vals, g = _low_degree_values(1024, 256, 11)
    got = stt.prove_low_degree(vals, g, 256, exclude_multiples_of=exclude,
                               device="cpu")
    assert got == ofri.prove_low_degree(vals, g, 256, M,
                                        exclude_multiples_of=exclude)
    assert stt.verify_low_degree_proof(merkelize(vals)[1], g, got, 256,
                                       exclude_multiples_of=exclude)


def test_prove_low_degree_base_case_and_tamper():
    """maxdeg + 1 <= 16 sends the values (the oracle's base case); a
    changed final value is rejected."""
    vals, g = _low_degree_values(16, 16, 12)
    got = stt.prove_low_degree(vals, g, 16, device="cpu")
    assert got == ofri.prove_low_degree(vals, g, 16, M)
    vals, g = _low_degree_values(256, 64, 13)
    proof = stt.prove_low_degree(vals, g, 64, device="cpu")
    proof[-1][0] = bytes(32)
    with pytest.raises(stt.VerificationError):
        stt.verify_low_degree_proof(merkelize(vals)[1], g, proof, 64)


@pytest.mark.parametrize("steps", [64, 2 ** 13])
def test_inv_z2_equals_multi_inv(steps):
    """The set-up's 1/Z2, built by the native runtime from the power
    table, equals `hostfield.multi_inv` of (x - 1)(x - last) over Python
    ints (zeros map to zero), as the set-up built it before."""
    su = _FusedSetup(steps, REFERENCE, "cpu")
    last = pow(su.G2, (steps - 1) * su.ext, M)
    want = hf.multi_inv([(x - 1) * (x - last) % M
                         for x in fused.powers(su.G2, su.precision)])
    assert tensor_to_ints(su.inv_z2) == want
