"""Start the ranks of one `torch.distributed` group, or join one.

    python -m starks_tpu_torch.parallel.launch dryrun [RANKS] [cuda|cpu]
    python -m starks_tpu_torch.parallel.launch prove STEPS RANKS [cuda|cpu]
    python -m starks_tpu_torch.parallel.launch batch STEPS CLAIMS RANKS
        [cuda|cpu]
    torchrun (--standalone | --nnodes N --node-rank I --master-addr HOST
        --master-port PORT) --nproc-per-node K
        -m starks_tpu_torch.parallel.launch batch STEPS CLAIMS [cuda|cpu]

`run(fn, n_ranks, *args, device=...)` starts n processes
(`torch.multiprocessing`, spawned), joins them into one process group
(a file store in a temporary directory) and calls `fn(rank, *args)` in
each; it returns the n results in rank order. When a rank fails, the
others are stopped and the traceback of every rank that failed is
raised (the first rank to end may only have lost its peer); when the
time runs out, every rank is stopped. `fn`, its arguments and its
result must pickle.

The backend is chosen openly (`backend_for`): NCCL when every rank has
a card of its own, gloo when ranks share a card or run on the CPU (NCCL
refuses two ranks on one device). Rank r runs on `cuda:(r %
device_count)`, or on the CPU when asked.

`join_from_env(device)` joins the group that torchrun's environment
describes, on one host or several (the counterpart of
`jax.distributed.initialize(coordinator_address=...)`): each rank on
the card of its LOCAL_RANK.

`dryrun` is the counterpart of `__graft_entry__.dryrun_multichip`: on a
[1, n] mesh it runs the four-step NTT forward and back against the
single-device DIF transform, then a 128-step sharded MiMC proof
against the single-device proof, and prints what it checked.

`prove` proves one MiMC claim of STEPS steps (input 3, the 64 round
constants (i^7) xor 42 of chip_smoke.py and benchmark config 4) on a
[1, RANKS] mesh: first on one device in this process (cuda:0), then
on RANKS new ranks, one per card where there are enough (NCCL). Every
rank's proof must equal the one-device proof byte for byte. It prints,
per rank, the steady proof's stage times, each collective's count,
bytes sent to other ranks and seconds, and the four-step NTT over the
evaluation domain (STEPS * 8 points) beside the one-device DIF
transform of the same size.

`batch` is BASELINE.md config 5 (64 independent 2^16-step MiMC claims
over N processes, verified) in data-parallel form: claims are inputs
0 .. CLAIMS - 1 with the round constants of `prove` (the first STEPS / 2
of them where STEPS < 128: a claim needs fewer constants than steps).
Each rank proves its contiguous slice (`batch.local_slice`) with
`prove_batch(verify=True, chunk=16)` and a proof store of its own, and
the proofs are gathered on rank 0 as wire bytes (`batch.gather_proofs`).
Given RANKS, it first proves every claim on one device in this process
(cuda:0), the one-device baseline, then starts RANKS new ranks (one per
card where there are enough); every gathered proof must equal the
one-device proof byte for byte. Under torchrun (RANKS left out) the ranks
join through `join_from_env`, and rank 0 then proves claims 0 and
CLAIMS - 1 alone and compares bytes. It prints per rank the slice, the
device, the first call (with set-up and kernel loading), the steady
prove_batch's seconds and proofs/s split into the bulk prover and the
self-checks plus store, and the thread counts; the aggregate proofs/s
between two barriers around every rank's steady prove_batch; against
the one-device baseline, the efficiency; the host's CPU; the transport.
"""

import os
import pickle
import socket
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def backend_for(n_ranks: int, device: str) -> str:
    """"nccl" when every rank has its own card, else "gloo"."""
    if device == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def run(fn, n_ranks: int, *args, device: str = "cuda",
        timeout: float = 600.0):
    """`fn(rank, *args)` on each of `n_ranks` new processes, joined in one
    process group; returns the results in rank order."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r} is neither 'cpu' nor 'cuda'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu'")
    backend = backend_for(n_ranks, device)
    with tempfile.TemporaryDirectory(prefix="starks_launch_") as tmp:
        ctx = mp.start_processes(
            _rank_main, (n_ranks, device, backend, tmp, fn, args),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            # join raises on a failure, after stopping the other ranks.
            while not ctx.join(timeout=max(0.0,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    for p in ctx.processes:
                        p.kill()
                    for p in ctx.processes:
                        p.join()
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout} s")
        except (mp.ProcessRaisedException,
                mp.ProcessExitedException) as e:
            failed = [f"rank {rank} of {n_ranks} failed:\n"
                      + Path(tmp, f"error{rank}.txt").read_text()
                      for rank in range(n_ranks)
                      if Path(tmp, f"error{rank}.txt").exists()]
            raise RuntimeError("\n".join(failed) or str(e)) from e
        return [pickle.loads(Path(tmp, f"result{rank}.pkl").read_bytes())
                for rank in range(n_ranks)]


def _rank_main(rank, n_ranks, device, backend, tmp, fn, args):
    os.environ["LOCAL_RANK"] = str(rank)
    # The ranks meet on this host: loopback, whatever the host's name
    # resolves to.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=n_ranks)
    try:
        result = fn(rank, *args)
    except BaseException:
        # Written before the group is torn down, so before a peer can
        # fail for the loss of this rank.
        Path(tmp, f"error{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    Path(tmp, f"result{rank}.pkl").write_bytes(pickle.dumps(result))
    _exit_without_finalizing()


def _exit_without_finalizing():
    """End a rank's process without finalizing the interpreter. A gloo
    worker thread may still hold the last reference to a finished
    collective's tensor; dropping it takes the GIL, and a thread that
    asks for the GIL while the interpreter finalizes is ended by
    pthread_exit, whose forced unwind aborts the process
    (std::terminate, SIGABRT) after the rank's work is done."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


# torchrun's variables, which describe the group on every host.
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def join_from_env(device: str = "cuda") -> torch.device:
    """Join the process group that torchrun's environment describes
    (`init_method="env://"`; NCCL on the cards, gloo on the CPU) and
    return this rank's device: `cuda:LOCAL_RANK`, made the current
    device before any other CUDA work (the rank's index on its own
    host, so ranks on several hosts each find their own card), or the
    CPU. Raises without torchrun's variables, or with `device="cuda"`
    and no card, or fewer cards than ranks on this host."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r} is neither 'cpu' nor 'cuda'")
    missing = [v for v in TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"join_from_env needs torchrun's environment: "
                           f"{', '.join(missing)} not set")
    local = int(os.environ["LOCAL_RANK"])
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu'")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} on a host with "
                               f"{torch.cuda.device_count()} cards: start "
                               f"one rank per card")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    else:
        dev = torch.device("cpu")
    if os.environ["MASTER_ADDR"] in ("localhost", "127.0.0.1", "::1"):
        # Every rank is on this host: meet on loopback, whatever the
        # host's name resolves to.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method="env://")
    return dev


# -- dryrun ------------------------------------------------------------

def _dryrun_rank(rank, device):
    import random
    from .. import prover
    from ..ops import fused, plimbs
    from ..utils.conversions import ints_to_tensor
    from . import mesh as pmesh
    from . import ntt4step
    mesh = pmesh.make_mesh(device=device)
    s, dev = mesh.n_shard, mesh.device
    m = prover.MODULUS
    n = 1 << 10
    g = pow(7, (m - 1) // n, m)
    rng = random.Random(1)
    vals = ints_to_tensor([rng.randrange(m) for _ in range(n)], dev)
    rows = slice(rank * n // s, (rank + 1) * n // s)
    plan = ntt4step.get_plan(n, g, mesh)
    mesh.reset_counts()
    fwd = ntt4step.fourstep_ntt(vals[rows].contiguous(), plan)
    a2a = mesh.counts["all_to_all_single"]
    back = ntt4step.fourstep_ntt(fwd, plan, inverse=True)
    table = fused.power_table(g, n, dev)
    want = plimbs.dif_transform(vals, table)[ntt4step.bit_reverse(n, dev)]
    steps, consts = 128, [(i ** 7) ^ 42 for i in range(32)]
    sharded = prover.mk_mimc_proof(3, steps, consts, mesh=mesh)
    single = prover.mk_mimc_proof(3, steps, consts, device=dev)
    return {"four_step": bool(torch.equal(fwd, want[rows])),
            "round_trip": bool(torch.equal(back, vals[rows])),
            "all_to_all_per_transform": a2a,
            "proof": sharded == single, "transport": mesh.transport}


def dryrun(n_ranks: int = 4, device: str = "cuda") -> list:
    """Four-step NTT and a sharded proof on a [1, n_ranks] mesh, each
    against the single-device port; returns every rank's findings and
    raises if any differs."""
    results = run(_dryrun_rank, n_ranks, device, device=device)
    for rank, res in enumerate(results):
        if not (res["four_step"] and res["round_trip"] and res["proof"]
                and res["all_to_all_per_transform"] == 3):
            raise AssertionError(f"dryrun rank {rank}: {res}")
    print(f"[dryrun] {n_ranks} ranks on {device} ({results[0]['transport']})"
          f": four-step NTT at 2^10 equals the DIF transform, 3 "
          f"all_to_all_single per transform, exact round trip; the sharded "
          f"128-step MiMC proof equals the single-device proof on every "
          f"rank", flush=True)
    return results


# -- prove ------------------------------------------------------------

PROVE_INP = 3
PROVE_CONSTS = [(i ** 7) ^ 42 for i in range(64)]
NTT_REPS = 5
PROVE_TIMEOUT_S = 1200.0


def _random_field(rows: int, device, seed: int) -> torch.Tensor:
    """[rows, 8] field elements below 2^255 (so below p) from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 31, (rows, 8), generator=gen,
                         dtype=torch.int32).to(device)


def _seconds(fn, device, reps: int = NTT_REPS, barrier: bool = False):
    """Mean seconds of `fn()` over `reps` runs after one warm-up, each
    run between two waits for the device (and, with `barrier`, after
    every rank of the group has arrived)."""
    fn()
    total = 0.0
    for _ in range(reps):
        if barrier:
            dist.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        total += time.perf_counter() - t0
    return total / reps


def _prove_rank(rank, steps, device):
    from .. import prover
    from ..config import REFERENCE
    from ..ops import plimbs
    from . import mesh as pmesh
    from . import ntt4step
    mesh = pmesh.make_mesh(device=device)
    t0 = time.perf_counter()
    prover.mk_mimc_proof(PROVE_INP, steps, PROVE_CONSTS, mesh=mesh)
    first_s = time.perf_counter() - t0
    mesh.reset_counts()
    mesh.timed = True
    plimbs.reset_launches()
    steady = {}
    proof = prover.mk_mimc_proof(PROVE_INP, steps, PROVE_CONSTS, mesh=mesh,
                                 timings=steady)
    launches = dict(plimbs.LAUNCHES)
    collectives = {k: (mesh.counts[k], mesh.bytes[k], mesh.seconds[k])
                   for k in mesh.counts}
    mesh.timed = False
    plan = prover._ShardedSetup.get(steps, REFERENCE, mesh).plan_lde
    rows = plan.n // mesh.n_shard
    x = _random_field(plan.n, "cpu", 1)[rank * rows:(rank + 1) * rows]
    x = x.to(mesh.device)
    ntt_s = _seconds(lambda: ntt4step.fourstep_ntt(x, plan), mesh.device,
                     barrier=True)
    return {"proof": proof, "first_s": first_s, "steady": steady,
            "launches": launches, "collectives": collectives,
            "fourstep_s": ntt_s, "points": plan.n,
            "device": str(mesh.device), "transport": mesh.transport}


def prove(steps: int, n_ranks: int, device: str = "cuda") -> list:
    """The `prove` subcommand: one claim on one device, then sharded on
    `n_ranks` new ranks; returns every rank's findings and raises if a
    rank's proof differs from the one-device proof."""
    from .. import prover
    from ..config import REFERENCE
    from ..ops import fused, plimbs
    one = torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")
    t0 = time.perf_counter()
    want = prover.mk_mimc_proof(PROVE_INP, steps, PROVE_CONSTS, device=one)
    single_s = time.perf_counter() - t0
    n = steps * REFERENCE.extension_factor
    m = prover.MODULUS
    table = fused.power_table(pow(REFERENCE.generator, (m - 1) // n, m), n,
                              one)
    x = _random_field(n, one, 1)
    dif_s = _seconds(lambda: plimbs.dif_transform(x, table), one)
    del x, table
    results = run(_prove_rank, n_ranks, steps, device, device=device,
                  timeout=PROVE_TIMEOUT_S)
    for rank, res in enumerate(results):
        if res["proof"] != want:
            raise AssertionError(f"rank {rank}: the {steps}-step sharded "
                                 f"proof differs from the one-device proof")
    print(f"[prove] {steps} steps on {n_ranks} ranks ({device}, "
          f"{results[0]['transport']}): every rank's proof equals the "
          f"one-device proof byte for byte (one device, first call with "
          f"set-up: {single_s:.3f} s)", flush=True)
    for rank, res in enumerate(results):
        print(f"  rank {rank} on {res['device']}: first call (with set-up) "
              f"{res['first_s']:.3f} s; steady stages (ms): " + ", ".join(
                  f"{k} {v * 1e3:.3f}" for k, v in res["steady"].items()),
              flush=True)
        print("    collectives (count, MB to other ranks, s): " + ", ".join(
            f"{k} {c} / {b / 1e6:.3f} / {sec:.4f}"
            for k, (c, b, sec) in res["collectives"].items()), flush=True)
        print("    launches: " + (", ".join(
            f"{k} {v}" for k, v in res["launches"].items() if v)
            or "none (the plain versions ran)"), flush=True)
        print(f"    four-step NTT over {res['points']} points: "
              f"{res['fourstep_s'] * 1e3:.3f} ms (mean of {NTT_REPS}); the "
              f"one-device DIF transform of {n} points on {one}: "
              f"{dif_s * 1e3:.3f} ms", flush=True)
    return results


# -- batch ------------------------------------------------------------

BATCH_CHUNK = 16
BATCH_TIMEOUT_S = 1800.0


def batch_consts(steps: int) -> list:
    """The round constants of a `batch` claim: `prove`'s 64, cut to
    fewer than `steps`."""
    return PROVE_CONSTS[:min(len(PROVE_CONSTS), steps // 2)]


def _this_device(device: str) -> torch.device:
    """The rank's device, with its index spelled out (one key per process
    in the prover's set-up cache)."""
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _timed_prove_batch(inputs, steps, chunk, device,
                       barrier=lambda: None) -> dict:
    """A first call (set-up, kernel loading, the first use of a chunk's
    buffers: the first chunk of this process's slice through the bulk
    prover), then `prove_batch(verify=True)` of `inputs` (this process's
    slice of them, under a process group) with a proof store in a new
    temporary directory, timed apart and counted, between two calls of
    `barrier` (wall_s: from the first to the end of the second)."""
    from .. import prover
    from ..ops import plimbs
    from ..utils.artifacts import ProofStore
    from . import batch
    consts = batch_consts(steps)
    first = list(inputs)[batch.local_slice(len(inputs))][:chunk]
    t0 = time.perf_counter()
    if first:
        prover.mk_mimc_proof_batch_fused(first, steps, consts, chunk=chunk,
                                         device=device)
    first_s = time.perf_counter() - t0
    timings = {}
    with tempfile.TemporaryDirectory(prefix="starks_batch_") as root:
        store = ProofStore(root)
        barrier()
        plimbs.reset_launches()
        t0 = time.perf_counter()
        proofs = batch.prove_batch(inputs, steps, consts, store=store,
                                   verify=True, chunk=chunk, device=device,
                                   timings=timings)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        steady_s = time.perf_counter() - t0
        launches = dict(plimbs.LAUNCHES)
        barrier()
        wall_s = time.perf_counter() - t0
    return {"proofs": proofs, "n": len(proofs), "first_s": first_s,
            "steady_s": steady_s, "wall_s": wall_s, "bulk_s": timings["bulk"],
            "alone_s": timings["alone"], "alone": timings["alone_claims"],
            "launches": launches, "device": str(device),
            "threads": torch.get_num_threads(),
            "affinity": len(os.sched_getaffinity(0))}


def batch_rank(rank, steps, n_claims, chunk, device):
    """One rank of `batch`: its slice of claims 0 .. n_claims - 1 through
    `_timed_prove_batch`, the steady call between two barriers of a
    gloo group; then its figures and proofs gathered on rank 0 in one
    `gather_proofs`. Returns, on rank 0, {"proofs": all proofs in claim
    order, "ranks": every rank's figures, "wall_s": the steady seconds
    between the barriers, "transport": the group's backend}; None on
    the others."""
    from . import batch
    hosts = batch.host_group()
    owned = batch.local_slice(n_claims)
    res = _timed_prove_batch(list(range(n_claims)), steps, chunk,
                             _this_device(device),
                             lambda: dist.barrier(group=hosts))
    local = res.pop("proofs")
    res.update(slice=(owned.start, owned.stop), host=socket.gethostname())
    got = batch.gather_proofs(local, n_claims, extra=res, group=hosts)
    if got is None:
        return None
    return {"proofs": got[0], "ranks": got[1], "wall_s": res["wall_s"],
            "transport": dist.get_backend()}


def _cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names it: the model name, or the
    vendor, family and model numbers where the name is not given."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        return "not known"
    name = fields.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"model name unknown; vendor {fields.get('vendor_id', '?')}, "
            f"family {fields.get('cpu family', '?')}, model "
            f"{fields.get('model', '?')}, stepping "
            f"{fields.get('stepping', '?')}, flags "
            f"{len(fields.get('flags', '').split())}")


def print_batch(out, steps, n_claims, device, one=None):
    """The figures of `batch`: the host, the one-device baseline (when
    given), each rank, the aggregate and the efficiency."""
    ranks = out["ranks"]
    print(f"  host: {_cpu_model()}; os.cpu_count() {os.cpu_count()}; this "
          f"process may run on {len(os.sched_getaffinity(0))} CPUs; "
          f"transport: {out['transport']} default group, proofs gathered "
          f"as wire bytes over gloo", flush=True)

    def split(r):
        return (f"first call (set-up, kernel loading, one chunk) "
                f"{r['first_s']:.3f} s; "
                f"prove_batch {r['steady_s']:.3f} s = "
                f"{r['n'] / r['steady_s']:.4f} proofs/s (bulk prover "
                f"{r['bulk_s']:.3f} s, self-checks and store "
                f"{r['steady_s'] - r['bulk_s'] - r['alone_s']:.3f} s; "
                f"{r['alone']} claims proved alone in {r['alone_s']:.3f} "
                f"s); torch threads {r['threads']}, "
                f"{r['affinity']} CPUs in its affinity")
    if one is not None:
        print(f"  one device, {one['device']}, {n_claims} claims: "
              f"{split(one)}", flush=True)
    for rank, r in enumerate(ranks):
        print(f"  rank {rank} on {r['device']} ({r['host']}), claims "
              f"[{r['slice'][0]}, {r['slice'][0] + r['n']}): {split(r)}",
              flush=True)
        print("    launches: " + (", ".join(
            f"{k} {v}" for k, v in r["launches"].items() if v)
            or "none (the plain versions ran)"), flush=True)
    agg = n_claims / out["wall_s"]
    line = (f"  aggregate: {n_claims} claims x {steps} steps in "
            f"{out['wall_s']:.3f} s between the barriers = {agg:.4f} proofs/s "
            f"over {len(ranks)} ranks on {device}")
    if one is not None:
        eff = agg / (len(ranks) * one["n"] / one["steady_s"])
        line += (f"; efficiency against the one-device baseline: {eff:.4f} "
                 f"(aggregate / ({len(ranks)} x one-device proofs/s))")
    print(line, flush=True)


def batch(steps: int, n_claims: int, n_ranks: int,
          device: str = "cuda") -> dict:
    """The `batch` subcommand on one host: the one-device baseline in this
    process, then `n_ranks` new ranks; raises if a gathered proof
    differs from the one-device proof. Returns rank 0's result of
    `batch_rank` and the baseline's figures under "one"."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r} is neither 'cpu' nor 'cuda'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu'")
    one_dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")
    one = _timed_prove_batch(list(range(n_claims)), steps, BATCH_CHUNK,
                             one_dev)
    want = one.pop("proofs")
    out = run(batch_rank, n_ranks, steps, n_claims, BATCH_CHUNK, device,
              device=device, timeout=BATCH_TIMEOUT_S)[0]
    differ = [i for i, (a, b) in enumerate(zip(out["proofs"], want))
              if a != b]
    if differ or len(out["proofs"]) != n_claims:
        raise AssertionError(f"gathered proofs of claims {differ} differ "
                             f"from the one-device proofs")
    print(f"[batch] {n_claims} claims x {steps} steps over {n_ranks} ranks "
          f"({device}): every gathered proof equals the one-device proof "
          f"byte for byte", flush=True)
    print_batch(out, steps, n_claims, device, one)
    out["one"] = one
    return out


def batch_from_env(steps: int, n_claims: int, device: str = "cuda"):
    """The `batch` subcommand under torchrun, on one host or several:
    every rank joins through `join_from_env` and runs `batch_rank`; rank
    0 then proves claims 0 and n_claims - 1 alone on its card and
    raises if their bytes differ from the gathered proofs."""
    from .. import prover
    dev = join_from_env(device)
    try:
        out = batch_rank(dist.get_rank(), steps, n_claims, BATCH_CHUNK,
                         device)
    finally:
        dist.destroy_process_group()
    if out is None:
        return None
    for i in sorted({0, n_claims - 1}):
        if out["proofs"][i] != prover.mk_mimc_proof(
                i, steps, batch_consts(steps), device=dev):
            raise AssertionError(f"gathered claim {i} differs from its "
                                 f"proof alone on rank 0")
    print(f"[batch] {n_claims} claims x {steps} steps over "
          f"{len(out['ranks'])} ranks under torchrun ({device}): claims 0 "
          f"and {n_claims - 1}, gathered, equal rank 0's proofs of them "
          f"alone byte for byte", flush=True)
    print_batch(out, steps, n_claims, device)
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["dryrun"]:
        dryrun(int(sys.argv[2]) if len(sys.argv) > 2 else 4,
               sys.argv[3] if len(sys.argv) > 3 else "cuda")
        sys.exit(0)
    if sys.argv[1:2] == ["prove"] and len(sys.argv) in (4, 5):
        prove(int(sys.argv[2]), int(sys.argv[3]),
              sys.argv[4] if len(sys.argv) > 4 else "cuda")
        sys.exit(0)
    if sys.argv[1:2] == ["batch"]:
        args = sys.argv[2:]
        dev_arg = args.pop() if args and args[-1] in ("cpu", "cuda") \
            else "cuda"
        if len(args) == 3:
            batch(int(args[0]), int(args[1]), int(args[2]), dev_arg)
            sys.exit(0)
        if len(args) == 2:
            batch_from_env(int(args[0]), int(args[1]), dev_arg)
            _exit_without_finalizing()
    sys.exit(__doc__)
