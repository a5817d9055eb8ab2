"""The port's whole slice on the CPU: mk_mimc_proof with the plain
versions of the kernels equals the spec oracle's proof byte for byte, and
both the port's verifier and the JAX package's verifier accept it; the
set-up's 1/Z2, built by the kernels, equals the JAX set-up's (computed
in a child process started with this module), the native runtime's and
`hostfield.multi_inv`'s."""

import random

import numpy as np
import pytest

from oracle import fri as ofri
from oracle import stark as ostark
from oracle.merkle import merkelize
from starks_tpu import verifier as jverifier
import starks_tpu_torch as stt
from starks_tpu_torch.config import REFERENCE
from starks_tpu_torch.ops import fused
from starks_tpu_torch.ops import limbs as fl
from starks_tpu_torch.prover import _FusedSetup
from starks_tpu_torch.utils import hostfield as hf
from starks_tpu_torch.utils import native
from starks_tpu_torch.utils.conversions import tensor_to_ints
from _torch_support import JaxChild, refusing_host_tables

CONSTS = [(i ** 7) ^ 42 for i in range(16)]
M = stt.MODULUS
SETUP_STEPS = (64, 512)
JAX_TIMEOUT_S = 600

# The set-ups compile in threads (XLA compiles without the GIL).
_JAX_SETUPS = f"""
from concurrent.futures import ThreadPoolExecutor
from starks_tpu.config import REFERENCE
from starks_tpu.prover import _FusedSetup
with ThreadPoolExecutor() as pool:
    outputs.update(zip({SETUP_STEPS}, pool.map(
        lambda steps: np.asarray(_FusedSetup(steps, REFERENCE).inv_z2),
        {SETUP_STEPS})))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_setups(tmp_path_factory):
    """JAX `_FusedSetup(steps, REFERENCE).inv_z2` for SETUP_STEPS, in a
    child process running while this module's other tests do."""
    child = JaxChild(_JAX_SETUPS, tmp_path_factory.mktemp("jax_setups"))
    yield child
    child.stop()


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
    """The set-up's 1/Z2, built by the sub, mul and batch-inverse kernels
    (their plain versions here) over the plan's power table, equals
    `hostfield.multi_inv` of (x - 1)(x - last) over Python ints (zeros
    map to zero), and the set-up builds no table on the host."""
    with refusing_host_tables():
        su = _FusedSetup(steps, REFERENCE, "cpu")
    last = pow(su.G2, (steps - 1) * su.ext, M)
    want = hf.multi_inv([(x - 1) * (x - last) % M
                         for x in fused.powers(su.G2, su.precision)])
    assert tensor_to_ints(su.inv_z2) == want


def test_setup_stage_timings():
    """With `timings`, the set-up records its stages in order (each
    non-negative, summing to no more than the total) and builds the same
    1/Z2; a cached set-up records nothing."""
    steps = 64
    stages = {}
    su = _FusedSetup(steps, REFERENCE, "cpu", timings=stages)
    assert list(stages) == ["host power tables", "upload",
                            "1/Z2 sub, sub, mul", "batch inverse", "rest",
                            "total"]
    assert all(v >= 0 for v in stages.values())
    assert sum(v for k, v in stages.items() if k != "total") <= (
        stages["total"])
    assert su.inv_z2.equal(_FusedSetup(steps, REFERENCE, "cpu").inv_z2)
    _FusedSetup.get(steps, REFERENCE, "cpu")
    again = {}
    _FusedSetup.get(steps, REFERENCE, "cpu", timings=again)
    assert again == {}


# -- against the JAX set-up (last: they wait for the child) ---------------

@pytest.mark.parametrize("steps", SETUP_STEPS)
def test_inv_z2_equals_jax_and_native(jax_setups, steps):
    """1/Z2 equals the JAX set-up's (`batch_inv_scan` on the device,
    starks_tpu/prover.py:436-449) and the native runtime's
    `inv_vanishing2` over the same power table, zeros included."""
    su = _FusedSetup(steps, REFERENCE, "cpu")
    last = pow(su.G2, (steps - 1) * su.ext, M)
    native_z2 = native.inv_vanishing2(su.plan.xs_big.numpy(), 1, last)
    assert su.inv_z2.numpy().tobytes() == native_z2.tobytes()
    assert np.array_equal(fl.to_jax_limbs(su.inv_z2),
                          jax_setups.result(JAX_TIMEOUT_S)[steps])
    assert int(fl.eq_zero(su.inv_z2).sum()) == 2         # x = 1, x = last
