"""What each rank runs in tests/test_torch_parallel.py (this module
holds no tests): one call per mesh (launch.run starts the ranks once),
every sharded function on seeded inputs, returning this rank's results
for the test to hold against the single-device port, the oracle and
JAX. Imports torch and the port only, so a rank starts quickly."""

import numpy as np
import torch

import starks_tpu_torch as stt
from starks_tpu_torch import prover
from starks_tpu_torch.models import mimc
from starks_tpu_torch.ops import blake2s as b2
from starks_tpu_torch.ops import fused, merkle, plimbs
from starks_tpu_torch.parallel import batch as pbatch
from starks_tpu_torch.parallel import mesh as pmesh
from starks_tpu_torch.parallel import ntt4step
from starks_tpu_torch.utils.artifacts import ProofStore
from starks_tpu_torch.utils import hostfield as hf
from starks_tpu_torch.utils.conversions import int_to_tensor
from _torch_support import refusing_host_tables

M = 2 ** 256 - 351 * 2 ** 32 + 1
PROOF_STEPS, PROOF_CONSTS = 128, [(i ** 7) ^ 42 for i in range(32)]
BATCH_STEPS, BATCH_CONSTS = 64, [(i ** 7) ^ 42 for i in range(16)]
BATCH_INPS = [3, 4, 5]
DP_INPS = [3, 4, 5, 6, 7, 8]          # the data-parallel batch (mesh=None)
NTT_SIZES = (2 ** 10, 2 ** 12)
TREE_LEAVES = 64
# (points, maxdeg + 1): over 8 shards the second FRI round of 128
# points has 8 columns, one per shard, and goes replicated.
LOW_DEGREE = ((1024, 256), (128, 128))


def field_array(n: int, seed: int) -> torch.Tensor:
    """n seeded field elements as [n, 8] int32 (numpy's generator; a top
    word below 2^32 - 1 keeps each below p)."""
    words = np.random.default_rng(seed).integers(0, 2 ** 32, (n, 8),
                                                 dtype=np.uint64)
    words[:, 7] %= 2 ** 32 - 1
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def low_degree_values(n: int, maxdeg: int) -> list:
    """Evaluations over the n-th roots of unity of a seeded polynomial of
    degree < maxdeg, as ints."""
    coeffs = [int(c) for c in np.random.default_rng(maxdeg).integers(
        0, 2 ** 62, maxdeg)]
    return hf.host_ntt(coeffs + [0] * (n - maxdeg), root_of_unity(n))


def leaf_words(n: int, width: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2 ** 32, (n, width), dtype=np.int64))


def bad_trace() -> list:
    trace = mimc.trace_host(3, PROOF_STEPS, PROOF_CONSTS)
    trace[10] = (trace[10] + 1) % M
    return trace


def root_of_unity(n: int) -> int:
    return pow(7, (M - 1) // n, M)


def _rows(x, mesh):
    rows = x.shape[0] // mesh.n_shard
    return x[mesh.shard_index * rows:][:rows].contiguous()


def _counted(mesh, run):
    mesh.reset_counts()
    out = run()
    return out, dict(mesh.counts)


def mesh_checks(rank: int, n_batch: int, parts, fill_root=None,
                resume_root=None) -> dict:
    """The sharded entry points and helpers named in `parts` on this
    rank of an [n_batch, ranks / n_batch] CPU mesh, and the data-parallel
    batch over the same ranks ("batch_dp", into a proof store at
    `fill_root` when given; "batch_resume", from the store at
    `resume_root`)."""
    mesh = pmesh.make_mesh(n_batch=n_batch, device="cpu")
    out = {"shard": mesh.shard_index, "batch_row": mesh.batch_index,
           "transport": mesh.transport}
    if "proof" in parts:
        out["proof"], out["proof_counts"] = _counted(
            mesh, lambda: stt.mk_mimc_proof(3, PROOF_STEPS, PROOF_CONSTS,
                                            mesh=mesh))
    if "setup" in parts:
        # Built afresh (the proof's is cached), with no host table.
        with refusing_host_tables():
            su = prover._ShardedSetup(PROOF_STEPS, stt.REFERENCE, mesh)
        out["setup"] = (su.offset, su.inv_z2)
    if "with_trace" in parts:
        out["with_trace"] = stt.mk_mimc_proof_with_trace(
            3, PROOF_STEPS, PROOF_CONSTS, bad_trace(), mesh=mesh)
    if "prove_batch" in parts:
        out["prove_batch"] = stt.prove_batch(BATCH_INPS, BATCH_STEPS,
                                       BATCH_CONSTS, mesh=mesh, verify=True)
    if "fourstep" in parts:
        out["fourstep"] = {}
        for n in NTT_SIZES:
            plan = ntt4step.get_plan(n, root_of_unity(n), mesh)
            x = _rows(field_array(n, n), mesh)
            for inverse in (False, True):
                out["fourstep"][n, inverse] = _counted(
                    mesh, lambda: ntt4step.fourstep_ntt(x, plan, inverse))
    if "tree" in parts:
        out["tree"] = {}
        for width in (8, 24):
            leaves = _rows(leaf_words(TREE_LEAVES, width, width), mesh)
            tree = merkle.Tree(leaves, mesh)
            idx = torch.arange(TREE_LEAVES - 1, -1, -3)
            out["tree"][width] = (tree.root, tree.bundle(idx))
    if "db_map" in parts:
        n, ext = 512, 8
        p, xs, iz2 = (_rows(field_array(n, s), mesh) for s in (1, 2, 3))
        k, zni = field_array(256, 4), field_array(ext, 5)
        last, slope, ia = field_array(3, 6)
        offset = mesh.shard_index * p.shape[0]
        mesh.reset_counts()
        halo = mesh.halo(p, ext)
        out["halo_bytes"] = mesh.bytes["halo"]
        out["db_map"] = plimbs.db_map(
            p, xs, torch.roll(k, -(offset % 256), 0), zni, iz2, last, slope,
            ia, ext, halo=halo)
    if "fri" in parts:
        out["fri"] = fri_checks(mesh)
    if "batch_dp" in parts:
        out["batch_dp"] = batch_dp(fill_root)
    if "batch_resume" in parts:
        out["batch_resume"] = batch_resume(resume_root)
    if "low_degree" in parts:
        out["low_degree"] = {}
        for n, maxdeg in LOW_DEGREE:
            out["low_degree"][n] = stt.prove_low_degree(
                low_degree_values(n, maxdeg), root_of_unity(n), maxdeg,
                mesh=mesh)
    return out


def fri_checks(mesh) -> dict:
    """fold4 on the quarter slices one all_to_all_single brings, and the
    whole sharded FRI commit, at 2^10 points (maxdeg + 1 = 256) and at
    128 points (maxdeg + 1 = 128, which goes replicated over 8 shards)."""
    out = {}
    for n, maxdeg in LOW_DEGREE:
        vals = field_array(n, 40 + n)
        g = root_of_unity(n)
        q, s, r = n // 4, mesh.n_shard, mesh.shard_index
        u = fused.power_table(pow(g, M - 2, M), q)
        u_local = u[r * (q // s):][:q // s].contiguous()
        sx, eta = field_array(1, 7)[0], int_to_tensor(pow(g, q, M))
        local = _rows(vals, mesh)
        mesh.reset_counts()
        quarters = fused._quarter_exchange(local, n, mesh)
        sent = mesh.bytes["all_to_all_single"]
        fold = plimbs.fold4(quarters, u_local, sx, eta)
        tree = merkle.Tree(b2.limbs_to_words(local), mesh)
        commit, counts = _counted(mesh, lambda: fused.fri_commit(
            local, tree, u_local, fused.fri_round_schedule(n, maxdeg, 16),
            eta, 40, 0, mesh, pow(g, M - 2, M)))
        out[n] = {"fold": fold, "commit": commit, "counts": counts,
                  "quarter_bytes": sent}
    return out


def batch_dp(store_root=None) -> dict:
    """`prove_batch(mesh=None)` of DP_INPS on this rank's slice, verified,
    in chunks of 2, then `gather_proofs` to rank 0: the inputs the bulk
    prover got, this rank's slice and proofs, and what the gather gave."""
    proved = []
    real = pbatch.prover.mk_mimc_proof_batch_fused

    def recorded(inps, *args, **kwargs):
        proved.extend(inps)
        return real(inps, *args, **kwargs)
    pbatch.prover.mk_mimc_proof_batch_fused = recorded
    try:
        local = stt.prove_batch(
            DP_INPS, BATCH_STEPS, BATCH_CONSTS, verify=True, chunk=2,
            device="cpu",
            store=None if store_root is None else ProofStore(store_root))
    finally:
        pbatch.prover.mk_mimc_proof_batch_fused = real
    owned = pbatch.local_slice(len(DP_INPS))
    return {"slice": owned, "proved": proved, "local": local,
            "gathered": pbatch.gather_proofs(local, len(DP_INPS),
                                             extra=owned.start)}


def batch_resume(store_root) -> dict:
    """`prove_batch(mesh=None)` of DP_INPS from a store that another world
    size filled, with both provers raising: every claim of this rank's
    slice must load from the store; then the gather to rank 0."""
    def refuse(*args, **kwargs):
        raise AssertionError("re-proved a stored claim")
    routes = ("mk_mimc_proof_batch_fused", "mk_mimc_proof_with_trace")
    real = {name: getattr(pbatch.prover, name) for name in routes}
    for name in routes:
        setattr(pbatch.prover, name, refuse)
    try:
        local = stt.prove_batch(DP_INPS, BATCH_STEPS, BATCH_CONSTS,
                                store=ProofStore(store_root), verify=True,
                                chunk=2, device="cpu")
    finally:
        for name, fn in real.items():
            setattr(pbatch.prover, name, fn)
    return {"local": local,
            "gathered": pbatch.gather_proofs(local, len(DP_INPS))}


def failing(rank: int):
    """Rank 1 raises before the collective the others wait in."""
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()
    return rank


def batch_fault(rank: int, fault: str):
    """`prove_batch` of one claim on a 1x2 mesh, with one fault injected
    once: "raise", rank 1's first sharded proof raises before its first
    collective; "reject", the verifier rejects the first proof on every
    rank."""
    from starks_tpu_torch.parallel import batch
    mesh = pmesh.make_mesh(device="cpu")
    first = []
    if fault == "raise":
        real = batch.prover.mk_mimc_proof_with_trace

        def flaky(*args, **kwargs):
            if rank == 1 and not first:
                first.append(1)
                raise RuntimeError("rank 1 device fault on purpose")
            return real(*args, **kwargs)
        batch.prover.mk_mimc_proof_with_trace = flaky
    else:
        real = batch.verifier.verify_mimc_proof

        def flaky(*args, **kwargs):
            if not first:
                first.append(1)
                return False
            return real(*args, **kwargs)
        batch.verifier.verify_mimc_proof = flaky
    return stt.prove_batch(BATCH_INPS[:1], BATCH_STEPS, BATCH_CONSTS,
                           mesh=mesh, verify=True, max_retries=1)
