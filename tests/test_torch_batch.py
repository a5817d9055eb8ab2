"""The port's batch proving on the CPU at 64 steps: the claim-axis
prover (`mk_mimc_proof_batch_fused`) against per-claim proofs and the
spec oracle across several chunks, the per-claim trace entry point
(`mk_mimc_proof_with_trace`, which proves its trace verbatim), and
`prove_batch`'s resume, retry and self-check (the cases of the JAX
package's tests/_artifacts_impl.py)."""

import logging

import numpy as np
import pytest
import torch

from oracle import stark as ostark
from starks_tpu import verifier as jverifier
from starks_tpu.parallel import batch as jbatch
import starks_tpu_torch as stt
from starks_tpu_torch import prover
from starks_tpu_torch.models import mimc
from starks_tpu_torch.parallel import batch as pbatch
from starks_tpu_torch.utils.artifacts import ProofStore, claim_key
from starks_tpu_torch.utils.conversions import ints_to_tensor

M = 2 ** 256 - 351 * 2 ** 32 + 1
STEPS = 64
CONSTS = [(i ** 7) ^ 42 for i in range(16)]
INPS = [3, 4, M + 5, 7, 123]          # M + 5 is claim 5, reduced


def _out(inp):
    return mimc.mimc_forward(inp % M, STEPS, CONSTS)


def test_batch_equals_per_claim_and_oracle():
    """Five claims in chunks of two (three chunks, the last partial):
    each proof, in claim order, equals `mk_mimc_proof` for its claim and
    the oracle's."""
    got = stt.mk_mimc_proof_batch_fused(INPS, STEPS, CONSTS, chunk=2,
                                        device="cpu")
    assert len(got) == len(INPS)
    for inp, proof in zip(INPS, got):
        assert proof == stt.mk_mimc_proof(inp, STEPS, CONSTS, device="cpu")
        assert proof == ostark.mk_mimc_proof(inp % M, STEPS, CONSTS)


def test_batch_takes_given_traces():
    traces = [mimc.trace_host(x, STEPS, CONSTS) for x in (9, 10, 11)]
    got = stt.mk_mimc_proof_batch_fused([9, 10, 11], STEPS, CONSTS,
                                        traces=traces, device="cpu")
    assert got == [ostark.mk_mimc_proof(x, STEPS, CONSTS)
                   for x in (9, 10, 11)]


def test_batch_rejects_bad_chunk_and_needs_a_card(monkeypatch):
    with pytest.raises(ValueError):
        stt.mk_mimc_proof_batch_fused(INPS, STEPS, CONSTS, chunk=0,
                                      device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.mk_mimc_proof_batch_fused(INPS, STEPS, CONSTS)


@pytest.mark.parametrize("form", ["ints", "array", "tensor"])
def test_with_trace_equals_oracle(form):
    trace = mimc.trace_host(3, STEPS, CONSTS)
    if form != "ints":
        trace = ints_to_tensor(trace)
        trace = trace.numpy() if form == "array" else trace
    proof = stt.mk_mimc_proof_with_trace(3, STEPS, CONSTS, trace,
                                         device="cpu")
    assert proof == ostark.mk_mimc_proof(3, STEPS, CONSTS)


def _rejects(verify, proof, output):
    try:
        return not verify(3, STEPS, CONSTS, output, proof)
    except AssertionError:
        return True


def test_with_trace_proves_an_inconsistent_trace_verbatim():
    """Row 10 off the recurrence: the trace is proved as given (not
    regenerated from the recurrence), so both packages' verifiers
    reject the proof for the true output, and for the trace's own last
    row."""
    trace = mimc.trace_host(3, STEPS, CONSTS)
    trace[10] = (trace[10] + 1) % M
    proof = stt.mk_mimc_proof_with_trace(3, STEPS, CONSTS, trace,
                                         device="cpu")
    assert proof != ostark.mk_mimc_proof(3, STEPS, CONSTS)
    for output in (_out(3), trace[-1]):
        assert _rejects(stt.verify_mimc_proof, proof, output)
        assert _rejects(jverifier.verify_mimc_proof, proof, output)


def test_with_trace_rejects_bad_shapes_and_mesh():
    """A trace of the wrong shape is refused, and so is a `mesh` that is
    not a parallel.mesh.Mesh, by the per-claim entry point and by
    prove_batch (the sharded path itself: tests/test_torch_parallel.py)."""
    trace = mimc.trace_limbs(3, STEPS, CONSTS)
    with pytest.raises(ValueError):
        stt.mk_mimc_proof_with_trace(3, STEPS, CONSTS, trace[:-1],
                                     device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        stt.mk_mimc_proof_with_trace(3, STEPS, CONSTS, trace, mesh=object(),
                                     device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        stt.prove_batch([3, 4], STEPS, CONSTS, mesh=object(), device="cpu")


def test_local_slice():
    assert pbatch.local_slice(10) == slice(0, 10)
    assert pbatch.local_slice(10, 0, 3) == slice(0, 4)
    assert pbatch.local_slice(10, 2, 3) == slice(8, 10)
    assert [0, 1][pbatch.local_slice(2, 3, 4)] == []


@pytest.mark.parametrize("n,index,count", [
    (n, i, c) for n in (0, 1, 5, 64) for c in (1, 2, 3, 4)
    for i in range(c)])
def test_local_slice_equals_jax(n, index, count):
    """The port's contiguous slice of a batch for rank `index` of `count`
    equals the JAX package's for process `index` of `count`."""
    assert pbatch.local_slice(n, index, count) == jbatch.local_slice(
        n, index, count)


@pytest.mark.parametrize("slices,n,fault", [
    ([(0, 2), (3, 5)], 5, r"no rank proved claims \[2\]"),
    ([(0, 3), (2, 5)], 5, "ranks 0 and 1 both proved claim 2"),
    ([(0, 3), (3, 6)], 5, r"rank 1 proved claims \[3, 6\), outside"),
    ([(0, 2), (2, 4), (4, 5), (6, 5)], 5, None),
    ([(0, 0)], 0, None),
])
def test_check_slices_rejects_a_gap_or_an_overlap(slices, n, fault):
    """What `gather_proofs` checks on the gathering rank: the ranks'
    slices cover the batch once each (an empty slice, start >= stop, is
    a rank with no claim); a gap or an overlap raises and names the
    ranks."""
    if fault is None:
        pbatch.check_slices(slices, n)
    else:
        with pytest.raises(ValueError, match=fault):
            pbatch.check_slices(slices, n)


def test_prove_batch_verifies_and_verify_batch():
    proofs = stt.prove_batch([3, 4, 5], STEPS, CONSTS, verify=True,
                             chunk=2, device="cpu")
    assert proofs == [ostark.mk_mimc_proof(x, STEPS, CONSTS)
                      for x in (3, 4, 5)]
    outs = [_out(x) for x in (3, 4, 5)]
    assert stt.verify_batch([3, 4, 5], STEPS, CONSTS, outs, proofs) == [
        True] * 3
    assert stt.verify_batch([3, 4, 5], STEPS, CONSTS, outs[::-1],
                            proofs) == [False, True, False]


def test_resume_skips_proved_claims(tmp_path, monkeypatch):
    store = ProofStore(str(tmp_path))
    inps = [123, 456]
    first = pbatch.prove_batch(inps, STEPS, CONSTS, store=store,
                               device="cpu")
    assert all(store.has_proof(claim_key(i, STEPS, CONSTS)) for i in inps)

    def boom(*a, **k):
        raise AssertionError("re-proved a stored claim")

    # A resumed run loads from the store and proves nothing.
    for route in ("mk_mimc_proof_with_trace", "mk_mimc_proof_batch_fused",
                  "mk_mimc_proof"):
        monkeypatch.setattr(prover, route, boom)
    assert pbatch.prove_batch(inps, STEPS, CONSTS, store=store,
                              verify=True, device="cpu") == first


def test_bulk_failure_is_logged_and_claims_proved_alone(monkeypatch,
                                                        caplog):
    def broken(*a, **k):
        raise RuntimeError("bulk path down")

    monkeypatch.setattr(prover, "mk_mimc_proof_batch_fused", broken)
    with caplog.at_level(logging.ERROR, logger=pbatch.__name__):
        proofs = pbatch.prove_batch([3, 4], STEPS, CONSTS, verify=True,
                                    device="cpu")
    assert "bulk batch prover failed" in caplog.text
    assert proofs == [ostark.mk_mimc_proof(x, STEPS, CONSTS) for x in (3, 4)]


def test_retry_recovers_transient_failure(monkeypatch):
    real = prover.mk_mimc_proof_with_trace
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient device fault")
        return real(*a, **k)

    monkeypatch.setattr(prover, "mk_mimc_proof_with_trace", flaky)
    proofs = pbatch.prove_batch([7], STEPS, CONSTS, max_retries=1,
                                verify=True, device="cpu")
    assert calls["n"] == 2
    assert proofs == [ostark.mk_mimc_proof(7, STEPS, CONSTS)]


def test_exhausted_retries_raise(monkeypatch):
    calls = {"n": 0}

    def dead(*a, **k):
        calls["n"] += 1
        raise RuntimeError("device gone")

    monkeypatch.setattr(prover, "mk_mimc_proof_with_trace", dead)
    with pytest.raises(RuntimeError, match="failed after 2 attempts"):
        pbatch.prove_batch([7], STEPS, CONSTS, max_retries=1, device="cpu")
    assert calls["n"] == 2


def test_rejected_proof_is_retried(monkeypatch):
    """A proof that fails self-verification counts as a failed attempt."""
    real = prover.mk_mimc_proof_with_trace
    calls = {"n": 0}

    def tampered_once(*a, **k):
        calls["n"] += 1
        proof = real(*a, **k)
        if calls["n"] == 1:
            proof[0] = bytes(32)
        return proof

    monkeypatch.setattr(prover, "mk_mimc_proof_with_trace", tampered_once)
    proofs = pbatch.prove_batch([7], STEPS, CONSTS, verify=True,
                                device="cpu")
    assert calls["n"] == 2
    assert proofs == [ostark.mk_mimc_proof(7, STEPS, CONSTS)]
