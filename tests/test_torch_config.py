"""The port's StarkConfig (starks_tpu_torch/config.py), the counterpart
of tests/test_config.py: REFERENCE's values, invalid configs rejected,
and a custom config (4x blowup, 24 spot checks, 12 FRI queries) proved
on the CPU by the host-trace and the all-device MiMC prover, verified
under its config and rejected by the default verifier.

The proof's bytes are held to a digest of the JAX package's proof of the
same claim: the SHA-256 of `starks_tpu.serialize.serialize_v1` of JAX
`starks_tpu.prover.mk_mimc_proof(7, 64, [(i ** 7) ^ 42 for i in
range(16)], config=StarkConfig(extension_factor=4, spot_checks=24,
fri_queries=12))` on the CPU (31,736 bytes). `JAX_PLATFORMS=cpu python
tests/_torch_config_digest.py` computes it again; the JAX side takes
minutes to compile on the CPU, so this test keeps the digest instead of
running JAX."""

import dataclasses
import hashlib

import pytest

import starks_tpu_torch as stt
from starks_tpu_torch import prover
from starks_tpu_torch.config import REFERENCE, StarkConfig
from starks_tpu_torch.serialize import serialize_v1

STEPS = 64
CONSTANTS = [(i ** 7) ^ 42 for i in range(16)]
INP = 7
CUSTOM = StarkConfig(extension_factor=4, spot_checks=24, fri_queries=12)
JAX_SHA256 = ("df36ac6a331ee0c9dd2a6a18447a72cf"
              "045c5a191ca78498afec50d54f450495")
JAX_BYTES = 31736


def test_reference_values_pinned():
    assert REFERENCE.modulus == 2 ** 256 - 351 * 2 ** 32 + 1
    assert REFERENCE.generator == 7
    assert REFERENCE.extension_factor == 8
    assert REFERENCE.spot_checks == 80
    assert REFERENCE.fri_queries == 40
    assert REFERENCE.fri_fold_arity == 4
    assert REFERENCE.fri_base_cutoff == 16
    assert REFERENCE.precision(STEPS) == STEPS * 8
    assert REFERENCE == StarkConfig()


def test_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        REFERENCE.extension_factor = 4


@pytest.mark.parametrize("fields", [{"extension_factor": 6},
                                    {"fri_fold_arity": 2},
                                    {"fri_base_cutoff": 2}])
def test_invalid_config_rejected(fields):
    with pytest.raises(AssertionError):
        StarkConfig(**fields)


@pytest.mark.parametrize("device_trace", [False, True])
def test_custom_config_roundtrip(device_trace):
    """Proved by `mk_mimc_proof_fused` with the host trace (that is,
    `mk_mimc_proof`) and with the trace on the device (its plain version
    on the CPU): the JAX proof's bytes, accepted under the custom
    config, branch counts from the config, rejected by the default
    verifier."""
    proof = prover.mk_mimc_proof_fused(INP, STEPS, CONSTANTS, config=CUSTOM,
                                       device_trace=device_trace,
                                       device="cpu")
    wire = serialize_v1(proof)
    assert len(wire) == JAX_BYTES
    assert hashlib.sha256(wire).hexdigest() == JAX_SHA256
    output = stt.mimc_forward(INP, STEPS, CONSTANTS)
    assert stt.verify_mimc_proof(INP, STEPS, CONSTANTS, output, proof,
                                 config=CUSTOM)
    assert len(proof[2]) == 2 * CUSTOM.spot_checks
    assert len(proof[3]) == CUSTOM.spot_checks
    with pytest.raises(AssertionError):
        stt.verify_mimc_proof(INP, STEPS, CONSTANTS, output, proof)
