"""The port's sharded prover on the CPU: meshes of gloo ranks that
`starks_tpu_torch.parallel.launch` starts (the ranks' side is
tests/test_torch_parallel_ranks.py; each mesh is started once).

- Sharded MiMC proofs at 128 steps with 32 constants (the JAX mesh
  test's sizes) over meshes 1x2, 1x4 and 2x2 equal
  `oracle.stark.mk_mimc_proof` and the single-device port byte for
  byte, on every rank; each rank's set-up 1/Z2 is its rows of the
  single-device table; an inconsistent trace is proved verbatim;
  `prove_batch(mesh=)` equals serial proofs.
- The data-parallel batch (`prove_batch(mesh=None)` under 2 and 4
  ranks): each rank proves its `local_slice`, `gather_proofs` gives rank
  0 the single-process proofs in claim order, and a store filled by 2
  ranks is loaded whole by 4; `launch batch` in both forms (new ranks,
  and torchrun).
- The four-step NTT equals JAX `ntt4step.fourstep_ntt_shmap` at 2^10
  over 4 shards (run in a subprocess with four virtual CPU devices,
  started with this module), and the single-device DIF transform plus
  a bit reversal at 2^10 and 2^12, with three all_to_all_single per
  transform.
- Each sharded helper equals its single-device function: the tree and
  its bundles (against `tree_build` and `tree_bundle`), the D/B map
  with a halo, fold4 on the exchanged quarter slices, the FRI commit
  over the shards (which goes replicated over 8 shards at 128 points)
  and `prove_low_degree`.
"""

import atexit
import functools
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from oracle import fri as ofri
from oracle import stark as ostark
from starks_tpu import verifier as jverifier
import starks_tpu_torch as stt
from starks_tpu_torch.ops import blake2s as b2
from starks_tpu_torch.ops import fused, merkle, plimbs
from starks_tpu_torch.ops import limbs as fl
from starks_tpu_torch.parallel import batch as pbatch
from starks_tpu_torch.parallel import launch, ntt4step
import test_torch_parallel_ranks as ranks
from _torch_support import JaxChild

ROOT = Path(__file__).resolve().parent.parent
M = ranks.M
JAX_N = 2 ** 10
JAX_TIMEOUT_S = 900
# name -> (ranks, batch rows, what the ranks run)
MESHES = {
    "1x2": (2, 1, ("proof", "tree", "db_map", "fri", "batch_dp")),
    "1x4": (4, 1, ("proof", "setup", "with_trace", "fourstep", "tree",
                   "db_map", "fri", "low_degree", "batch_dp",
                   "batch_resume")),
    "2x2": (4, 2, ("proof", "prove_batch")),
    "1x8": (8, 1, ("fri", "low_degree")),
}

_JAX_FOURSTEP = """
import jax.numpy as jnp
from starks_tpu.parallel import ntt4step
from starks_tpu.parallel.mesh import make_mesh, shard_rows
vals = inputs["vals"]
mesh = make_mesh(n_shard=4)
plan = ntt4step.get_plan(vals.shape[0], int(inputs["root"]), mesh)
x = jax.device_put(jnp.asarray(vals), shard_rows(mesh))
outputs["fwd"] = np.asarray(ntt4step.fourstep_ntt_shmap(x, plan))
outputs["inv"] = np.asarray(ntt4step.fourstep_ntt_shmap(x, plan,
                                                        inverse=True))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_fourstep_run(tmp_path_factory):
    """JAX `fourstep_ntt_shmap` forward and inverse of the 2^10-point
    input of the ranks, over 4 virtual CPU devices, in a child process
    running while this module's other tests do."""
    child = JaxChild(_JAX_FOURSTEP, tmp_path_factory.mktemp("jax_fourstep"),
                     devices=4,
                     vals=fl.to_jax_limbs(ranks.field_array(JAX_N, JAX_N)),
                     root=np.array(str(ranks.root_of_unity(JAX_N))))
    yield child
    child.stop()


@functools.lru_cache(maxsize=None)
def batch_store_root() -> str:
    """The proof store that the 1x2 launch's data-parallel batch fills
    and the 1x4 launch resumes from (removed at exit)."""
    root = tempfile.mkdtemp(prefix="starks_batch_store_")
    atexit.register(shutil.rmtree, root, True)
    return root


@functools.lru_cache(maxsize=None)
def mesh_results(name: str):
    """Every rank's results on mesh `name`, in rank order."""
    n, n_batch, parts = MESHES[name]
    fill = resume = None
    if "batch_resume" in parts:
        mesh_results("1x2")            # fills the store this one resumes
        resume = batch_store_root()
    elif "batch_dp" in parts:
        fill = batch_store_root()
    return launch.run(ranks.mesh_checks, n, n_batch, parts, fill, resume,
                      device="cpu", timeout=600)


# -- sharded proofs ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _oracle_proof():
    return ostark.mk_mimc_proof(3, ranks.PROOF_STEPS, ranks.PROOF_CONSTS)


@pytest.mark.parametrize("name", ["1x2", "1x4", "2x2"])
def test_sharded_proof_equals_oracle_and_single_device(name):
    want = _oracle_proof()
    single = stt.mk_mimc_proof(3, ranks.PROOF_STEPS, ranks.PROOF_CONSTS,
                               device="cpu")
    assert single == want
    results = mesh_results(name)
    assert all(r["proof"] == want for r in results)
    assert {r["transport"] for r in results} == {"gloo"}


def test_sharded_proof_collectives():
    """Per sharded 128-step proof: three all_to_all_single per four-step
    transform (two transforms) plus one to bring the coefficients to
    shard 0 and one per FRI round (two), one halo, an all_gather per
    tree (P||D||B, L, two columns) and for the final values, an
    all_reduce per bundle."""
    for r in mesh_results("1x4"):
        assert r["proof_counts"] == {"all_to_all_single": 9, "halo": 1,
                                     "all_gather": 5, "all_reduce": 6}


def test_sharded_setup_inv_z2_is_its_rows_of_the_one_card_table():
    """Each of 4 ranks builds 1/Z2 for its own rows only, from an offset
    (the vanishing points x = 1 and x = last on the shards that hold
    them), with the kernels and no host table: its rows of the one-card
    set-up's table, exactly."""
    whole = stt.prover._FusedSetup(ranks.PROOF_STEPS, stt.REFERENCE,
                                   "cpu").inv_z2
    rows = whole.shape[0] // 4
    zeros = 0
    for r in mesh_results("1x4"):
        offset, inv_z2 = r["setup"]
        assert offset == r["shard"] * rows
        assert inv_z2.equal(whole[offset:offset + rows])
        zeros += int(fl.eq_zero(inv_z2).sum())
    assert zeros == 2


def test_sharded_with_trace_proves_an_inconsistent_trace_verbatim():
    """Row 10 off the recurrence: every rank's proof equals the
    single-device `mk_mimc_proof_with_trace` of the same trace, and both
    verifiers reject it for the true output and for the trace's own."""
    trace = ranks.bad_trace()
    want = stt.mk_mimc_proof_with_trace(3, ranks.PROOF_STEPS,
                                        ranks.PROOF_CONSTS, trace,
                                        device="cpu")
    results = mesh_results("1x4")
    assert all(r["with_trace"] == want for r in results)
    true_out = stt.mimc_forward(3, ranks.PROOF_STEPS, ranks.PROOF_CONSTS)
    for output in (true_out, trace[-1]):
        for verify in (stt.verify_mimc_proof, jverifier.verify_mimc_proof):
            try:
                ok = verify(3, ranks.PROOF_STEPS, ranks.PROOF_CONSTS,
                            output, want)
            except Exception:
                ok = False
            assert not ok


def test_prove_batch_on_mesh_equals_serial_proofs():
    """2x2 mesh, 3 claims: batch row 0 proves claims 0-1 and row 1 claim
    2, each over its row's two shards; every rank returns its row's
    proofs, equal to serial single-device proofs."""
    serial = [stt.mk_mimc_proof(x, ranks.BATCH_STEPS, ranks.BATCH_CONSTS,
                                device="cpu") for x in ranks.BATCH_INPS]
    for r in mesh_results("2x2"):
        want = serial[:2] if r["batch_row"] == 0 else serial[2:]
        assert r["prove_batch"] == want and len(want) > 0


def test_prove_batch_on_mesh_raises_a_rank_fault():
    """A sharded proof that raises on one rank of a row is not retried
    alone (the row's other ranks are inside its collectives): the fault
    ends the run, and the waiting rank is stopped, not left hanging."""
    with pytest.raises(RuntimeError, match="rank 1 device fault on purpose"):
        launch.run(ranks.batch_fault, 2, "raise", device="cpu", timeout=300)


def test_prove_batch_on_mesh_retries_a_rejected_proof_on_every_rank():
    """A proof the verifier rejects is rejected on every rank of the row
    (its bytes are the same on each), so the row proves it again
    together and returns the serial proof."""
    want = [stt.mk_mimc_proof(ranks.BATCH_INPS[0], ranks.BATCH_STEPS,
                              ranks.BATCH_CONSTS, device="cpu")]
    got = launch.run(ranks.batch_fault, 2, "reject", device="cpu",
                     timeout=300)
    assert got == [want, want]


# -- the data-parallel batch --------------------------------------------

@functools.lru_cache(maxsize=None)
def _dp_serial():
    return [stt.mk_mimc_proof(x, ranks.BATCH_STEPS, ranks.BATCH_CONSTS,
                              device="cpu") for x in ranks.DP_INPS]


@pytest.mark.parametrize("name", ["1x2", "1x4"])
def test_batch_dp_ranks_prove_their_slices_and_gather(name):
    """`prove_batch(mesh=None)` of 6 claims over 2 and 4 ranks: each rank
    proves exactly its `local_slice(6, rank, world)` through the bulk
    prover (rank 3 of 4 none), and `gather_proofs` gives rank 0 the
    single-process proofs in claim order (claim 0 the oracle's) with
    every rank's `extra` in rank order, and the other ranks None."""
    serial = _dp_serial()
    assert serial[0] == ostark.mk_mimc_proof(
        ranks.DP_INPS[0], ranks.BATCH_STEPS, ranks.BATCH_CONSTS)
    results = mesh_results(name)
    n = len(ranks.DP_INPS)
    for rank, r in enumerate(results):
        got = r["batch_dp"]
        owned = pbatch.local_slice(n, rank, len(results))
        assert got["slice"] == owned
        assert got["proved"] == ranks.DP_INPS[owned]
        assert got["local"] == serial[owned]
        starts = [pbatch.local_slice(n, i, len(results)).start
                  for i in range(len(results))]
        assert got["gathered"] == ((serial, starts) if rank == 0 else None)
    if name == "1x4":
        assert results[3]["batch_dp"]["proved"] == []


def test_batch_resume_across_world_sizes():
    """A store filled by the 2-rank batch is loaded whole by 4 ranks, with
    both provers raising if called; the gather gives rank 0 every proof."""
    serial = _dp_serial()
    n = len(ranks.DP_INPS)
    results = mesh_results("1x4")
    for rank, r in enumerate(results):
        got = r["batch_resume"]
        assert got["local"] == serial[pbatch.local_slice(n, rank, 4)]
        assert got["gathered"] == ((serial, [None] * 4) if rank == 0
                                   else None)


def test_launch_batch_two_new_ranks(capsys):
    """`launch batch` on the CPU: the one-device baseline, then two new
    ranks; every gathered proof equals the baseline's and the oracle's
    for claim 0 (32 constants: fewer than the 64 steps)."""
    out = launch.batch(64, 3, 2, "cpu")
    consts = launch.batch_consts(64)
    assert len(consts) == 32
    assert out["proofs"][0] == ostark.mk_mimc_proof(0, 64, consts)
    assert [r["slice"] for r in out["ranks"]] == [(0, 2), (2, 3)]
    assert [r["n"] for r in out["ranks"]] == [2, 1]
    text = capsys.readouterr().out
    assert "every gathered proof equals the one-device proof" in text
    assert "efficiency against the one-device baseline" in text


def test_launch_batch_under_torchrun():
    """The torchrun form of `launch batch`, two CPU ranks on this host:
    rank 0 checks claims 0 and 4 against its own proofs of them."""
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "starks_tpu_torch.parallel.launch",
         "batch", "64", "5", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "claims 0 and 4, gathered, equal rank 0's proofs of them alone " \
        "byte for byte" in res.stdout
    assert res.stdout.count("    launches: ") == 2


def test_join_from_env_raises_without_torchrun_or_a_card(monkeypatch):
    """No group is joined quietly: without torchrun's variables, or with
    device="cuda" and no card, `join_from_env` raises, and so does
    `launch batch` on the card."""
    for var in launch.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
        launch.join_from_env("cpu")
    for var, value in zip(launch.TORCHRUN_VARS,
                          ("0", "1", "0", "localhost", "29500")):
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.join_from_env("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.batch(64, 2, 2, "cuda")
    assert not torch.distributed.is_initialized()


# -- the four-step NTT -----------------------------------------------------

@pytest.mark.parametrize("n", ranks.NTT_SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_equals_dif_transform(n, inverse):
    """The shards' outputs, joined, equal the single-device DIF transform
    (inverse: with the inverse root and 1/n) in natural order; three
    all_to_all_single per transform and no other collective."""
    x = ranks.field_array(n, n)
    g = ranks.root_of_unity(n)
    root = pow(g, M - 2, M) if inverse else g
    scale = (stt.prover.int_to_tensor(pow(n, M - 2, M)) if inverse
             else None)
    want = plimbs.dif_transform(x, fused.power_table(root, n),
                                scale=scale)[ntt4step.bit_reverse(n)]
    results = mesh_results("1x4")
    got = torch.cat([r["fourstep"][n, inverse][0] for r in results])
    assert got.equal(want)
    for r in results:
        assert r["fourstep"][n, inverse][1] == {
            "all_to_all_single": 3, "all_gather": 0, "all_reduce": 0,
            "halo": 0}


def test_fourstep_plan_split():
    """n1 = 2^floor(log n / 2), at least the shard count; both halves
    divisible by it."""
    class Shards:
        n_shard, shard_index, cache = 4, 0, {}
        device = torch.device("cpu")
    assert (ntt4step.FourStepPlan(2 ** 23, 3, Shards).n1,
            ntt4step.FourStepPlan(2 ** 23, 3, Shards).n2) == (2 ** 11,
                                                              2 ** 12)
    assert ntt4step.FourStepPlan(16, 3, Shards).n1 == 4
    with pytest.raises(ValueError):
        ntt4step.FourStepPlan(8, 3, Shards)


# -- sharded helpers -------------------------------------------------------

@pytest.mark.parametrize("name", ["1x2", "1x4"])
@pytest.mark.parametrize("width", [8, 24])
def test_sharded_tree_equals_single_device(name, width):
    """Root and bundles (32- and 96-byte leaves) from the shards equal
    `tree_build` and `tree_bundle` over all leaves."""
    leaves = ranks.leaf_words(ranks.TREE_LEAVES, width, width)
    lvl1, levels, root = merkle.tree_build(leaves)
    idx = torch.arange(ranks.TREE_LEAVES - 1, -1, -3)
    want = merkle.tree_bundle(leaves, lvl1, levels, idx)
    for r in mesh_results(name):
        got_root, got_bundle = r["tree"][width]
        assert got_root.equal(root) and got_bundle.equal(want)
    one = merkle.Tree(leaves)
    assert one.root.equal(root) and one.bundle(idx).equal(want)


@pytest.mark.parametrize("name", ["1x2", "1x4"])
def test_db_map_with_halo_equals_plain(name):
    """Each shard's D/B map, with the next shard's first 8 rows from
    `Mesh.halo`, equals its rows of `db_map_plain` over the domain."""
    n, ext = 512, 8
    p, xs, iz2 = (ranks.field_array(n, s) for s in (1, 2, 3))
    k, zni = ranks.field_array(256, 4), ranks.field_array(ext, 5)
    last, slope, ia = ranks.field_array(3, 6)
    want = plimbs.db_map_plain(p, xs, k, zni, iz2, last, slope, ia, ext)
    results = mesh_results(name)
    for i in range(2):
        got = torch.cat([r["db_map"][i] for r in results])
        assert got.equal(want[i])
    # The halo's 8 rows of 32 bytes go to one other shard.
    assert all(r["halo_bytes"] == ext * 32 for r in results)


def _fri_reference(n, maxdeg):
    vals = ranks.field_array(n, 40 + n)
    g = ranks.root_of_unity(n)
    u = fused.power_table(pow(g, M - 2, M), n // 4)
    sx = ranks.field_array(1, 7)[0]
    eta = stt.prover.int_to_tensor(pow(g, n // 4, M))
    commit = fused.fri_commit(vals, merkle.Tree(
        b2.limbs_to_words(vals)), u, fused.fri_round_schedule(n, maxdeg, 16),
        eta, 40, 0)
    return plimbs.fold4(vals, u, sx, eta), commit


@pytest.mark.parametrize("name", ["1x2", "1x4", "1x8"])
@pytest.mark.parametrize("n,maxdeg", ranks.LOW_DEGREE)
def test_sharded_fri_equals_single_device(name, n, maxdeg):
    """fold4 on the quarter slices one all_to_all_single brings equals
    the shard's columns of the single-device fold; the sharded FRI
    commit (roots, bundles, final values) equals `fri_commit`. Over 8
    shards, 128 points' second round has one column per shard and goes
    replicated (no all_to_all_single for it)."""
    fold, (roots, cols, rows, final) = _fri_reference(n, maxdeg)
    results = mesh_results(name)
    got = [r["fri"][n] for r in results]
    assert torch.cat([g["fold"] for g in got]).equal(fold)
    for g in got:
        g_roots, g_cols, g_rows, g_final = g["commit"]
        assert all(a.equal(b) for a, b in zip(g_roots, roots))
        assert all(a.equal(b) for a, b in zip(g_cols, cols))
        assert all(a.equal(b) for a, b in zip(g_rows, rows))
        assert g_final.equal(final) and len(g_roots) == len(roots)
    sharded_rounds = sum(q // len(results) >= 2 for _, q in
                         fused.fri_round_schedule(n, maxdeg, 16))
    assert got[0]["counts"]["all_to_all_single"] == sharded_rounds
    if name == "1x8" and n == 128:
        assert sharded_rounds == 1 < len(roots)
    # The quarter exchange counts the slices a shard sends to the others
    # (slice j of shard d lies on shard (j q + d w) // (n / s)), never
    # those it keeps.
    s, q = len(results), n // 4
    w = q // s
    for r, g in enumerate(got):
        sent = sum((j * q + d * w) // (n // s) == r
                   for j in range(4) for d in range(s) if d != r)
        assert g["quarter_bytes"] == 32 * w * sent


@pytest.mark.parametrize("name", ["1x4", "1x8"])
@pytest.mark.parametrize("n,maxdeg", ranks.LOW_DEGREE)
def test_sharded_prove_low_degree_equals_oracle(name, n, maxdeg):
    vals = ranks.low_degree_values(n, maxdeg)
    g = ranks.root_of_unity(n)
    want = ofri.prove_low_degree(vals, g, maxdeg, M)
    assert all(r["low_degree"][n] == want for r in mesh_results(name))
    assert stt.prove_low_degree(vals, g, maxdeg, device="cpu") == want


def test_launch_dryrun():
    """The launcher's own check (the counterpart of
    `__graft_entry__.dryrun_multichip`) on two CPU ranks, run as its
    README names it: `python -m starks_tpu_torch.parallel.launch`."""
    res = subprocess.run(
        [sys.executable, "-m", "starks_tpu_torch.parallel.launch", "dryrun",
         "2", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "the sharded 128-step MiMC proof equals the single-device " \
        "proof on every rank" in res.stdout


def test_launch_prove(capsys):
    """The launcher's `prove` (config 4's claim: 64 constants, so 128
    steps at the least) on two CPU ranks over gloo: every rank's proof
    equals the oracle's, with one all_to_all_single per FRI round and
    three per four-step transform plus the padding, and the four-step
    NTT timed over the 1024-point domain beside the DIF transform."""
    results = launch.prove(128, 2, "cpu")
    want = ostark.mk_mimc_proof(launch.PROVE_INP, 128, launch.PROVE_CONSTS)
    rounds = len(fused.fri_round_schedule(1024, 256, 16))
    for res in results:
        assert res["proof"] == want and res["points"] == 1024
        assert res["collectives"]["all_to_all_single"][0] == 7 + rounds
        assert res["fourstep_s"] > 0 and res["steady"]["total"] > 0
    out = capsys.readouterr().out
    assert "every rank's proof equals the one-device proof" in out
    assert out.count("four-step NTT over 1024 points") == 2


def test_launch_stops_every_rank_when_one_fails():
    """A rank that raises ends the run with its traceback; the rank that
    waits for it in a barrier is stopped, not left hanging."""
    with pytest.raises(RuntimeError, match="fails on purpose"):
        launch.run(ranks.failing, 2, device="cpu", timeout=120)


def test_make_mesh_needs_a_process_group_and_a_grid():
    from starks_tpu_torch.parallel import mesh as pmesh
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(device="cpu")
    assert launch.backend_for(4, "cpu") == "gloo"


# -- against JAX (last: waits for the subprocess started with the module) --

@pytest.fixture(scope="module")
def jax_fourstep(jax_fourstep_run):
    return jax_fourstep_run.result(JAX_TIMEOUT_S)


@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_equals_jax_shmap(jax_fourstep, inverse):
    """The port's four-step NTT over 4 gloo ranks equals JAX
    `fourstep_ntt_shmap` over 4 CPU devices on the same 2^10 input, in
    the JAX limb layout."""
    got = torch.cat([r["fourstep"][JAX_N, inverse][0]
                     for r in mesh_results("1x4")])
    want = jax_fourstep["inv" if inverse else "fwd"]
    assert np.array_equal(fl.to_jax_limbs(got), want)
    assert got.equal(fl.from_jax_limbs(want))
