"""Batch proving: many independent MiMC claims (the port of
`starks_tpu/parallel/batch.py`; BASELINE.md config 5).

Proofs are independent, so data parallelism is at the process level:
under `torch.distributed`, each process proves the contiguous slice of
the batch its rank owns (`local_slice`), and only proof bytes leave it
(`gather_proofs`: the wire format of serialize.py, over a gloo group,
to one rank that checks the slices cover the batch).
With a mesh (parallel/mesh.py), the slices go to the mesh's batch rows,
and each row proves its claims one by one, each sharded over the row's
ranks, as `starks_tpu/parallel/batch.py` does.
Within a process, chunks of claims run through the claim-axis prover
(`prover.mk_mimc_proof_batch_fused`: one pass of the kernels per chunk,
chunk i+1 queued before chunk i is assembled on the host), with resume
from a proof store, self-verification and per-claim retries.
"""

import logging
import time

import torch
import torch.distributed as dist

from .. import prover
from .. import serialize as ser
from .. import verifier
from ..models import mimc as mimc_model
from ..utils.artifacts import claim_key

log = logging.getLogger(__name__)


def local_slice(n_items: int, process_index: int = None,
                process_count: int = None):
    """Contiguous slice of a batch owned by this process: its rank and
    the world size from `torch.distributed` when a process group is
    initialized, else 0 and 1; the arguments override both."""
    dist = torch.distributed
    grouped = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if grouped else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if grouped else 1)
    per = (n_items + pc - 1) // pc
    return slice(pi * per, min(n_items, (pi + 1) * per))


def prove_batch(inputs, steps: int, round_constants, mesh=None,
                store=None, max_retries: int = 1, verify: bool = False,
                chunk: int = None, device=None, timings=None):
    """Prove a batch of MiMC claims; returns the proof objects of this
    process's slice of the batch (all of it in a single process).

    Claims already in `store` (a utils.artifacts.ProofStore) are loaded
    (resume). The rest run through the claim-axis bulk prover in chunks
    of `chunk`. Every claim then passes the same check, retry and store
    steps: with `verify=True` each candidate proof must pass the
    verifier, and a claim whose bulk proof is missing (the bulk prover
    raised; the failure is logged, never swallowed) or rejected is
    proved alone through `prover.mk_mimc_proof_with_trace`, with up to
    `max_retries` more attempts (proofs are deterministic, so recovery
    is a re-run). `device` as in `prover.mk_mimc_proof`. Pass a dict as
    `timings` to receive the seconds in the bulk prover ("bulk") and in
    claims proved alone, retries included ("alone"), and the number of
    claims proved alone ("alone_claims").

    With `mesh` (a parallel.mesh.Mesh), the batch row of the mesh owns a
    contiguous slice of the claims (`local_slice` over the batch axis),
    and each of them is proved over the row's shards through
    `prover.mk_mimc_proof_with_trace(mesh=...)`; every rank of a row
    returns the row's proofs. A proof that fails self-verification fails
    it on every rank of the row (its bytes are the same on each), so the
    row retries it together; an exception inside a sharded proof is
    raised, not retried."""
    if mesh is not None:
        prover._check_mesh(mesh, device)
        owned = local_slice(len(inputs), mesh.batch_index, mesh.n_batch)
    else:
        owned = local_slice(len(inputs))
    local_inputs = list(inputs)[owned]
    if timings is None:
        timings = {}
    timings.update(bulk=0.0, alone=0.0, alone_claims=0)
    if not local_inputs:
        return []

    def check_one(inp, proof):
        if not verify:
            return True
        output = mimc_model.mimc_forward(inp, steps, round_constants)
        try:
            return verifier.verify_mimc_proof(inp, steps, round_constants,
                                              output, proof)
        except Exception:
            # A proof the verifier cannot even parse is a failed
            # attempt, eligible for a retry, not the end of the batch.
            return False

    def keep(i, proof):
        results[i] = proof
        if store is not None:
            store.put_proof(keys[i], proof, {"inp": local_inputs[i],
                                             "steps": steps})

    # Resume: a stored entry must still pass requested self-checks.
    keys = [None] * len(local_inputs)
    results = {}
    if store is not None:
        for i, inp in enumerate(local_inputs):
            keys[i] = claim_key(inp, steps, round_constants)
            if store.has_proof(keys[i]):
                stored = store.get_proof(keys[i])
                if check_one(inp, stored):
                    results[i] = stored
    pending = [i for i in range(len(local_inputs)) if i not in results]

    # Bulk path (one device): traces come from the native runtime one
    # chunk at a time inside the bulk prover (the whole batch's traces
    # would be gigabytes of host memory at 2^20 steps).
    if mesh is None and len(pending) > 1:
        t0 = time.perf_counter()
        try:
            got = prover.mk_mimc_proof_batch_fused(
                [local_inputs[i] for i in pending], steps, round_constants,
                chunk=chunk, device=device)
        except Exception:
            log.exception("bulk batch prover failed for %d claims; "
                          "proving them one by one", len(pending))
            got = [None] * len(pending)
        timings["bulk"] += time.perf_counter() - t0
        for i, cand in zip(pending, got):
            if cand is not None and check_one(local_inputs[i], cand):
                keep(i, cand)
        pending = [i for i in pending if i not in results]

    # Per-claim path: the first attempt and the retries go through the
    # same entry point (mk_mimc_proof_with_trace).
    for i in pending:
        inp = local_inputs[i]
        trace = mimc_model.trace_limbs(inp, steps, round_constants)
        proof, last_err = None, None
        timings["alone_claims"] += 1
        for _ in range(max_retries + 1):
            t0 = time.perf_counter()
            try:
                cand = prover.mk_mimc_proof_with_trace(
                    inp, steps, round_constants, trace, mesh=mesh,
                    device=device)
            except Exception as e:           # a transient device fault
                if mesh is not None:
                    # The row's other ranks may still be inside this
                    # proof's collectives: a rank that started again
                    # alone would pair its calls with theirs.
                    raise
                last_err = e
                continue
            finally:
                timings["alone"] += time.perf_counter() - t0
            if check_one(inp, cand):
                proof = cand
                break
            last_err = AssertionError("proof failed self-verification")
        if proof is None:
            raise RuntimeError(
                f"claim {i} (inp={inp}) failed after {max_retries + 1} "
                f"attempts") from last_err
        keep(i, proof)

    return [results[i] for i in range(len(local_inputs))]


def host_group():
    """A group of every rank for host objects: the default group when its
    backend is gloo, else a new gloo group over the same ranks (NCCL
    moves only device tensors). Every rank must call it, in the same
    order as its other collectives."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    return dist.new_group(backend="gloo")


def check_slices(slices, n_items: int):
    """Raise ValueError unless the ranks' slices cover claims
    [0, n_items) once each: `slices[r]` is the (start, stop) rank r
    proved (start >= stop for a rank with no claim, as `local_slice`
    gives when there are more ranks than claims). The message names the
    ranks at fault."""
    owner = [None] * n_items
    for rank, (lo, hi) in enumerate(slices):
        if lo >= hi:
            continue
        if lo < 0 or hi > n_items:
            raise ValueError(f"rank {rank} proved claims [{lo}, {hi}), "
                             f"outside the batch [0, {n_items})")
        for i in range(lo, hi):
            if owner[i] is not None:
                raise ValueError(f"ranks {owner[i]} and {rank} both proved "
                                 f"claim {i} (slices by rank: {slices})")
            owner[i] = rank
    missing = [i for i, r in enumerate(owner) if r is None]
    if missing:
        raise ValueError(f"no rank proved claims {missing} (slices by "
                         f"rank: {slices})")


def gather_proofs(local_proofs, n_items: int, extra=None, group=None):
    """This rank's proofs of its `local_slice(n_items)`, gathered on rank
    0: each rank sends its slice's bounds, its proofs as wire bytes
    (`serialize.serialize`) and `extra` (any object that pickles: this
    rank's figures, say) in one `gather_object` over `group` (default
    `host_group()`). On rank 0 the slices must cover the batch once each
    (`check_slices`), and it gets (every proof deserialized, in claim
    order; every rank's `extra`, in rank order); every other rank gets
    None. Every rank of the group must call it."""
    group = host_group() if group is None else group
    owned = local_slice(n_items)
    if len(local_proofs) != max(0, owned.stop - owned.start):
        raise ValueError(f"rank {dist.get_rank()} has {len(local_proofs)} "
                         f"proofs for its slice [{owned.start}, "
                         f"{owned.stop}) of {n_items} claims")
    sent = (owned.start, owned.stop, [ser.serialize(p) for p in local_proofs],
            extra)
    got = [None] * dist.get_world_size(group) if dist.get_rank() == 0 \
        else None
    dist.gather_object(sent, got, dst=0, group=group)
    if got is None:
        return None
    check_slices([(lo, hi) for lo, hi, _, _ in got], n_items)
    by_claim = {}
    for lo, _, blobs, _ in got:
        by_claim.update(enumerate(blobs, start=lo))
    return ([ser.deserialize(by_claim[i]) for i in range(n_items)],
            [x for _, _, _, x in got])


def verify_batch(inputs, steps: int, round_constants, outputs, proofs):
    """Verify this process's slice; returns a list of bools."""
    out = []
    for inp, output, proof in zip(inputs, outputs, proofs):
        try:
            out.append(verifier.verify_mimc_proof(inp, steps,
                                                  round_constants, output,
                                                  proof))
        except AssertionError:
            out.append(False)
    return out
