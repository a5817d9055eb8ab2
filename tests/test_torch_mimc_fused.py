"""The all-device MiMC proof and the last two host functions, on the CPU.

- `prover.mk_mimc_proof_fused(device_trace=True)` (its trace from
  `models.mimc.trace_batch_device`, on the CPU the trace kernel's plain
  version) equals the spec oracle's proof and the port's
  `mk_mimc_proof` byte for byte, both verifiers accept it and a flipped
  byte is rejected; with `device_trace=False` it is `mk_mimc_proof`;
  bad claims raise as `mk_mimc_proof` does.
- `models.mimc.mimc_backward` and `utils.hostfield.interp4` equal the
  JAX package's.
"""

import numpy as np
import pytest
import torch

from oracle import stark as ostark
from starks_tpu import verifier as jverifier
from starks_tpu.models import mimc as jmimc
from starks_tpu.utils import hostfield as jhf
import starks_tpu_torch as stt
from starks_tpu_torch import prover
from starks_tpu_torch.models import mimc
from starks_tpu_torch.utils import hostfield as hf

M = stt.MODULUS
# The constants of tests/test_mimc_model.py.
CONSTS = [(i ** 7) ^ 42 for i in range(16)]


@pytest.mark.parametrize("steps,n_consts", [(64, 16), (256, 16), (512, 256)])
def test_device_trace_proof_equals_oracle_and_verifies(steps, n_consts):
    consts = [(i ** 7) ^ 42 for i in range(n_consts)]
    got = prover.mk_mimc_proof_fused(3, steps, consts, device_trace=True,
                                     device="cpu")
    assert got == ostark.mk_mimc_proof(3, steps, consts)
    assert got == stt.mk_mimc_proof(3, steps, consts, device="cpu")
    out = stt.mimc_forward(3, steps, consts)
    assert stt.verify_mimc_proof(3, steps, consts, out, got)
    assert jverifier.verify_mimc_proof(3, steps, consts, out, got)
    leaf = bytearray(got[2][0][0])
    leaf[0] ^= 1
    got[2][0][0] = bytes(leaf)
    with pytest.raises(stt.VerificationError):
        stt.verify_mimc_proof(3, steps, consts, out, got)


def test_host_trace_form_is_mk_mimc_proof():
    """device_trace=False proves from the native host trace, as
    mk_mimc_proof does (an input above p reduced)."""
    assert prover.mk_mimc_proof_fused(M + 5, 64, CONSTS, device="cpu") == \
        stt.mk_mimc_proof(M + 5, 64, CONSTS, device="cpu")


@pytest.mark.parametrize("steps,n_consts", [
    (96, 16),      # steps not a power of two
    (64, 64),      # as many constants as steps
    (64, 12),      # constants not a power of two
])
def test_bad_claims_raise_as_mk_mimc_proof(steps, n_consts):
    consts = CONSTS[:1] * n_consts
    with pytest.raises(AssertionError):
        stt.mk_mimc_proof(3, steps, consts, device="cpu")
    for device_trace in (False, True):
        with pytest.raises(AssertionError):
            prover.mk_mimc_proof_fused(3, steps, consts,
                                       device_trace=device_trace,
                                       device="cpu")


def test_timings_name_the_device_trace():
    """The device trace is a stage of its own where the host path has
    its host trace and upload; the other stages are the same."""
    host, dev = {}, {}
    prover.mk_mimc_proof_fused(3, 64, CONSTS, device="cpu", timings=host)
    prover.mk_mimc_proof_fused(3, 64, CONSTS, device_trace=True,
                               device="cpu", timings=dev)
    shared = set(host) - {"host trace", "setup + trace upload"}
    assert set(dev) == shared | {"setup", "device trace"}
    assert {"lde", "fri", "proof transfer", "total"} <= shared
    assert all(v >= 0 for v in dev.values())


def test_device_trace_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prover.mk_mimc_proof_fused(3, 64, CONSTS, device_trace=True)


# The inputs of tests/test_mimc_model.py.
@pytest.mark.parametrize("steps,inps", [
    (128, [0, 1, 3, 12345, M - 7]),   # backward of forward
    (64, [987654321]),                # forward of backward
])
def test_mimc_backward_equals_jax(steps, inps):
    for x in inps:
        y = mimc.mimc_forward(x, steps, CONSTS)
        assert mimc.mimc_backward(y, steps, CONSTS) == \
            jmimc.mimc_backward(y, steps, CONSTS) == x % M
        back = mimc.mimc_backward(x, steps, CONSTS)
        assert back == jmimc.mimc_backward(x, steps, CONSTS)
        assert mimc.mimc_forward(back, steps, CONSTS) == x % M


@pytest.mark.parametrize("seed", [0, 1])
def test_interp4_equals_jax(seed):
    """Through four random distinct points, the port's interp4 equals
    JAX's, and the cubic passes through them."""
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(32), "little") for _ in range(4)]
    ys = [int.from_bytes(rng.bytes(32), "little") for _ in range(4)]
    assert len({x % M for x in xs}) == 4
    got = hf.interp4(xs, ys)
    assert got == jhf.interp4(xs, ys)
    for x, y in zip(xs, ys):
        assert hf.eval_poly_at(got, x) == y % M
