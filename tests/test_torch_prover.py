"""The port's whole slice on the CPU: mk_mimc_proof with the plain
versions of the kernels equals the spec oracle's proof byte for byte, and
both the port's verifier and the JAX package's verifier accept it."""

import pytest

from oracle import stark as ostark
from starks_tpu import verifier as jverifier
import starks_tpu_torch as stt

CONSTS = [(i ** 7) ^ 42 for i in range(16)]


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
    with pytest.raises(NotImplementedError):
        stt.mk_mimc_proof(3, 64, CONSTS, mesh=object(), device="cpu")
