"""The port's general AIR prover (starks_tpu_torch.air) on the CPU, at 64
steps: its fib-square proof and its proof of MiMC written as an AIR
(the path that runs the cube kernel, with a constant column) equal the
JAX package's `prove_air` byte for byte, both verifiers accept them and
reject tampered proofs, the declarative form gives the same bytes, and
the MiMC AIR's output is mimc_forward's. Over a claim axis,
`prove_air_batch_fused` gives each claim JAX `prove_air`'s bytes and
the port's `prove_air`'s.

The JAX proofs cost XLA:CPU compiles of one to two minutes, so they run
once, in a fresh interpreter (tests/_subproc.py says why), started when
this module's first test starts; the tests that compare the bytes come
last and wait for it."""

import atexit
import copy
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from starks_tpu import air as jair
from starks_tpu.models import fib_square as jfib
import starks_tpu_torch as stt
from starks_tpu_torch.air import HostOps, TorchOps, _FusedAIRSetup
from starks_tpu_torch.models import fib_square as fib
from starks_tpu_torch.models.mimc import mimc_air, mimc_forward

ROOT = Path(__file__).resolve().parent.parent
STEPS = 64
CONSTS = [(i ** 7) ^ 42 for i in range(16)]
JAX_TIMEOUT_S = 1200
BATCH_CLAIMS = [[1, 1], [2, 3], [5, 8]]     # proved in chunks of 2

# The child asks the kernel to kill it when its parent dies
# (PR_SET_PDEATHSIG), so a test run cut short never leaves the compile
# running; the pid check covers a parent that died before the request.
_JAX_PROVE = """
import ctypes, os, pickle, signal, sys
ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
if os.getppid() != int(sys.argv[3]):
    sys.exit(1)
import jax
jax.config.update("jax_platforms", "cpu")
from starks_tpu.air import AIR, prove_air
from starks_tpu.models.fib_square import fib_square_air
M = 2 ** 256 - 351 * 2 ** 32 + 1
steps = int(sys.argv[2])
# MiMC as an AIR, as tests/_air_impl.py builds it (TestMimcAsAir._air).
mimc = AIR(width=1, step_fn=lambda s, c: [(s[0] ** 3 + c[0]) % M],
           transition=lambda cur, nxt, c, ops: [
               ops.sub(nxt[0], ops.add(ops.cube(cur[0]), c[0]))],
           num_constraints=1, constants=[[(i ** 7) ^ 42 for i in range(16)]],
           boundary_points=lambda n: [(0, 0), (n - 1, 0)])
fib = fib_square_air()
proofs = {"fib": prove_air(fib, [1, 1], steps),
          "mimc": prove_air(mimc, [3], steps)}
# More claims of the same AIR and shapes: no new compile.
for claim in ([2, 3], [5, 8]):
    proofs[f"fib{claim}"] = prove_air(fib, claim, steps)
with open(sys.argv[1], "wb") as f:
    pickle.dump(proofs, f)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_air_run(tmp_path_factory):
    """JAX `prove_air` of fib-square (BATCH_CLAIMS) and of MiMC as an AIR
    ([3]) at STEPS in a subprocess, running while this module's other
    tests do: (process, proof file)."""
    out = tmp_path_factory.mktemp("jax_air") / "proof.pkl"
    # The compile is nearly all of the cost and the proof is tiny: with
    # XLA's backend optimisation off it takes half the CPU time. Integer
    # arithmetic is exact either way.
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_backend_optimization_level=0"
                        " --xla_llvm_disable_expensive_passes=true").strip()
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_PROVE, str(out), str(STEPS),
         str(os.getpid())], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    atexit.register(proc.kill)
    yield proc, out
    atexit.unregister(proc.kill)
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def fib_proof():
    timings = {}
    proof = stt.prove_air(fib.fib_square_air(), [1, 1], STEPS, device="cpu",
                          timings=timings)
    return proof, timings


VERIFIERS = {
    "port": lambda proof: stt.verify_air(fib.fib_square_air(), STEPS, proof),
    "jax": lambda proof: jair.verify_air(jfib.fib_square_air(), STEPS,
                                         proof),
}


@pytest.mark.parametrize("verifier", sorted(VERIFIERS))
def test_fib_square_proof_verifies(fib_proof, verifier):
    proof, _ = fib_proof
    assert VERIFIERS[verifier](proof)
    assert dict(proof[5])[(STEPS - 1, 1)] == fib.fib_square_output(1, 1,
                                                                   STEPS)


def test_stage_names_match_mimc_proof(fib_proof):
    _, timings = fib_proof
    assert {"host trace", "lde", "constraints/quotient/boundary",
            "merkle #1 (P||D||B)", "fri", "proof transfer",
            "total"} <= set(timings)


@pytest.mark.parametrize("verifier", sorted(VERIFIERS))
def test_wrong_boundary_rejected(fib_proof, verifier):
    bad = copy.deepcopy(fib_proof[0])
    bad[5] = [(k, (v + 1) % fib.MODULUS) if k == (STEPS - 1, 1) else (k, v)
              for k, v in bad[5]]
    with pytest.raises(AssertionError):
        VERIFIERS[verifier](bad)


@pytest.mark.parametrize("verifier", sorted(VERIFIERS))
def test_tampered_branch_rejected(fib_proof, verifier):
    bad = copy.deepcopy(fib_proof[0])
    leaf = bytearray(bad[2][0][0])
    leaf[0] ^= 1
    bad[2][0][0] = bytes(leaf)
    with pytest.raises(AssertionError):
        VERIFIERS[verifier](bad)


def test_declarative_equals_imperative(fib_proof):
    d_air = fib.fib_square_air_declarative()
    assert stt.prove_air(d_air, [1, 1], STEPS, device="cpu") == fib_proof[0]
    assert stt.verify_air(d_air, STEPS, fib_proof[0])


def test_mimc_as_air_verifies():
    proof = stt.prove_air(mimc_air(CONSTS), [3], STEPS, device="cpu")
    assert stt.verify_air(mimc_air(CONSTS), STEPS, proof)
    assert jair.verify_air(mimc_air(CONSTS), STEPS, proof)
    assert dict(proof[5])[(STEPS - 1, 0)] == mimc_forward(3, STEPS, CONSTS)
    other = mimc_air([c + 1 for c in CONSTS])
    with pytest.raises(AssertionError):
        stt.verify_air(other, STEPS, proof)


def test_setup_is_keyed_on_air_content():
    cpu = torch.device("cpu")
    a = _FusedAIRSetup.get(mimc_air(CONSTS), STEPS, stt.REFERENCE, cpu)
    assert a is _FusedAIRSetup.get(mimc_air(CONSTS), STEPS, stt.REFERENCE,
                                   cpu)
    b = _FusedAIRSetup.get(mimc_air(CONSTS[::-1]), STEPS, stt.REFERENCE,
                           cpu)
    assert a is not b and not torch.equal(a.k_tabs[0], b.k_tabs[0])


def test_const_is_one_contiguous_element():
    c = TorchOps("cpu").const(-1)
    assert c.shape == (1, 8) and c.is_contiguous()
    assert HostOps().const(-1) == fib.MODULUS - 1


def test_prove_air_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.prove_air(fib.fib_square_air(), [1, 1], STEPS)


@pytest.fixture(scope="module")
def batch_proofs():
    return stt.prove_air_batch_fused(fib.fib_square_air(), BATCH_CLAIMS,
                                     STEPS, chunk=2, device="cpu")


def test_batch_equals_serial_prove_air(batch_proofs, fib_proof):
    """Each claim of a batch in chunks of 2 (the last chunk short) is
    the port's one-claim proof of that claim."""
    assert len(batch_proofs) == len(BATCH_CLAIMS)
    assert batch_proofs[0] == fib_proof[0]
    for claim, proof in zip(BATCH_CLAIMS[1:], batch_proofs[1:]):
        assert proof == stt.prove_air(fib.fib_square_air(), claim, STEPS,
                                      device="cpu")


@pytest.mark.parametrize("verifier", sorted(VERIFIERS))
def test_batch_proofs_verify(batch_proofs, verifier):
    for (a, b), proof in zip(BATCH_CLAIMS, batch_proofs):
        assert VERIFIERS[verifier](proof)
        assert dict(proof[5]) == {(0, 0): a, (0, 1): b, (
            STEPS - 1, 1): fib.fib_square_output(a, b, STEPS)}


@pytest.mark.parametrize("verifier", sorted(VERIFIERS))
def test_batch_changed_boundary_rejected(batch_proofs, verifier):
    bad = copy.deepcopy(batch_proofs[2])
    bad[5] = [(k, (v + 1) % fib.MODULUS) if k == (0, 0) else (k, v)
              for k, v in bad[5]]
    with pytest.raises(AssertionError):
        VERIFIERS[verifier](bad)


def test_mimc_as_air_batch_equals_serial():
    """MiMC as an AIR (the cube kernel's path and a constant column)
    over 2 claims: each equals its own `prove_air`."""
    air = mimc_air(CONSTS)
    got = stt.prove_air_batch_fused(air, [[3], [4]], STEPS, device="cpu")
    for x, proof in zip((3, 4), got):
        assert proof == stt.prove_air(air, [x], STEPS, device="cpu")
        assert dict(proof[5])[(STEPS - 1, 0)] == mimc_forward(x, STEPS,
                                                              CONSTS)


def test_batch_rejects_bad_chunk_and_needs_a_card(monkeypatch):
    air = fib.fib_square_air()
    with pytest.raises(ValueError, match="chunk"):
        stt.prove_air_batch_fused(air, BATCH_CLAIMS, STEPS, chunk=0,
                                  device="cpu")
    assert stt.prove_air_batch_fused(air, [], STEPS, device="cpu") == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.prove_air_batch_fused(air, BATCH_CLAIMS, STEPS)


@pytest.fixture(scope="module")
def jax_proofs(jax_air_run):
    """The JAX proofs, once the subprocess started with this module has
    written them: {"fib": ..., "mimc": ..., "fib[2, 3]": ..., ...}."""
    proc, out = jax_air_run
    stdout, stderr = proc.communicate(timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, f"JAX prove_air failed:\n{stderr[-4000:]}"
    with open(out, "rb") as f:
        return pickle.load(f)


def test_proof_equals_jax_prove_air(fib_proof, jax_proofs):
    """Byte equality with the JAX package's prover (kept last but one:
    it waits for the subprocess started with this module)."""
    assert fib_proof[0] == jax_proofs["fib"]


def test_mimc_as_air_equals_jax_prove_air(jax_proofs):
    """MiMC as an AIR (16 constants, input 3): the cube kernel's path
    and a constant column, byte for byte with JAX `prove_air`."""
    proof = stt.prove_air(mimc_air(CONSTS), [3], STEPS, device="cpu")
    assert proof == jax_proofs["mimc"]


def test_batch_equals_jax_prove_air(batch_proofs, jax_proofs):
    """Every claim of `prove_air_batch_fused` equals JAX `prove_air` for
    that claim, byte for byte."""
    want = [jax_proofs["fib"]] + [jax_proofs[f"fib{c}"]
                                  for c in BATCH_CLAIMS[1:]]
    for proof, ref in zip(batch_proofs, want):
        assert proof == ref
