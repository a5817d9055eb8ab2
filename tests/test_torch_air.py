"""The port's general AIR prover (starks_tpu_torch.air) on the CPU, at 64
steps: its fib-square proof and its proof of MiMC written as an AIR
(the path that runs the cube kernel, with a constant column) equal the
JAX package's `prove_air` byte for byte, both verifiers accept them and
reject tampered proofs, the declarative form gives the same bytes, and
the MiMC AIR's output is mimc_forward's. Over a claim axis,
`prove_air_batch_fused` gives each claim JAX `prove_air`'s bytes and
the port's `prove_air`'s. The set-up's tables (x - last, boundary
bases, 1/Z_r), built on the device, equal the JAX set-up's.

The JAX proofs cost XLA:CPU compiles of one to two minutes, so they run
once, in a fresh interpreter (tests/_subproc.py says why;
tests/_torch_support.py's JaxChild), started when this module's first
test starts; the tests that compare the bytes come last and wait for
it."""

import copy

import numpy as np
import pytest
import torch

from starks_tpu import air as jair
from starks_tpu.models import fib_square as jfib
import starks_tpu_torch as stt
from starks_tpu_torch.air import HostOps, TorchOps, _FusedAIRSetup
from starks_tpu_torch.models import fib_square as fib
from starks_tpu_torch.models.mimc import mimc_air, mimc_forward
from starks_tpu_torch.ops import limbs as fl
from _torch_support import JaxChild, refusing_host_tables

STEPS = 64
CONSTS = [(i ** 7) ^ 42 for i in range(16)]
JAX_TIMEOUT_S = 1200
BATCH_CLAIMS = [[1, 1], [2, 3], [5, 8]]     # proved in chunks of 2

_JAX_PROVE = """
from starks_tpu.air import AIR, _FusedAIRSetup, prove_air
from starks_tpu.models.fib_square import fib_square_air
M = 2 ** 256 - 351 * 2 ** 32 + 1
steps = int(inputs["steps"])
# MiMC as an AIR, as tests/_air_impl.py builds it (TestMimcAsAir._air).
mimc = AIR(width=1, step_fn=lambda s, c: [(s[0] ** 3 + c[0]) % M],
           transition=lambda cur, nxt, c, ops: [
               ops.sub(nxt[0], ops.add(ops.cube(cur[0]), c[0]))],
           num_constraints=1, constants=[[(i ** 7) ^ 42 for i in range(16)]],
           boundary_points=lambda n: [(0, 0), (n - 1, 0)])
fib = fib_square_air()
outputs["fib"] = prove_air(fib, [1, 1], steps)
outputs["mimc"] = prove_air(mimc, [3], steps)
# More claims of the same AIR and shapes: no new compile.
for claim in ([2, 3], [5, 8]):
    outputs[f"fib{claim}"] = prove_air(fib, claim, steps)
# The set-up tables the proofs used (cached by _FusedAIRSetup.get).
for name, air in (("fib", fib), ("mimc", mimc)):
    t = _FusedAIRSetup.get(air, steps).tables
    outputs[f"tables {name}"] = {
        "x_minus_last": np.asarray(t["x_minus_last"]),
        "basis": [[np.asarray(b) for b in reg] for reg in t["basis"]],
        "inv_z": [np.asarray(z) for z in t["inv_z"]]}
"""


@pytest.fixture(scope="module", autouse=True)
def jax_air_run(tmp_path_factory):
    """JAX `prove_air` of fib-square (BATCH_CLAIMS) and of MiMC as an AIR
    ([3]) at STEPS, and the set-up tables of each, in a child process
    running while this module's other tests do."""
    child = JaxChild(_JAX_PROVE, tmp_path_factory.mktemp("jax_air"),
                     steps=np.array(STEPS))
    yield child
    child.stop()


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
    """The JAX proofs, once the child started with this module has
    written them: {"fib": ..., "mimc": ..., "fib[2, 3]": ..., ...}, and
    the set-up tables of each AIR ("tables fib", "tables mimc")."""
    return jax_air_run.result(JAX_TIMEOUT_S)


def test_proof_equals_jax_prove_air(fib_proof, jax_proofs):
    """Byte equality with the JAX package's prover (kept last but one:
    it waits for the child started with this module)."""
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


@pytest.mark.parametrize("name", ["fib", "mimc"])
def test_setup_tables_equal_jax(jax_proofs, name):
    """The set-up's x - last, boundary bases and 1/Z_r, built on the
    device by the kernels (their plain versions here) and one batch
    inverse per bounded register, equal JAX `_FusedAIRSetup.tables`
    (starks_tpu/air.py:319-376), zeros of 1/Z_r included: fib-square has
    a register with one boundary point and one with two, MiMC as an AIR
    one with two. No table is built on the host; a constant basis is
    one [1, 8] value, which JAX tiles."""
    air = fib.fib_square_air() if name == "fib" else mimc_air(CONSTS)
    with refusing_host_tables():
        su = _FusedAIRSetup(air, STEPS, stt.REFERENCE, "cpu")
    want = jax_proofs[f"tables {name}"]
    n = STEPS * 8

    def same(table, ref):
        return np.array_equal(fl.to_jax_limbs(table.expand(n, 8)), ref)

    assert same(su.x_minus_last, want["x_minus_last"])
    assert [len(b) for b in su.basis] == [len(b) for b in want["basis"]]
    for got_r, want_r in zip(su.basis, want["basis"]):
        assert all(same(g, w) for g, w in zip(got_r, want_r))
        assert all(g.shape[0] in (1, n) for g in got_r)
    assert len(su.inv_z) == len(want["inv_z"])
    for got, ref, reg in zip(su.inv_z, want["inv_z"], su.b_regs):
        assert same(got, ref)
        assert int(fl.eq_zero(got).sum()) == len(su.b_steps[reg])
