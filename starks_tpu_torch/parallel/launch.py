"""Run a function on n new ranks of one `torch.distributed` group.

    python -m starks_tpu_torch.parallel.launch dryrun [RANKS] [cuda|cpu]
    python -m starks_tpu_torch.parallel.launch prove STEPS RANKS [cuda|cpu]

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
"""

import os
import pickle
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


if __name__ == "__main__":
    if sys.argv[1:2] == ["dryrun"]:
        dryrun(int(sys.argv[2]) if len(sys.argv) > 2 else 4,
               sys.argv[3] if len(sys.argv) > 3 else "cuda")
        sys.exit(0)
    if sys.argv[1:2] == ["prove"] and len(sys.argv) in (4, 5):
        prove(int(sys.argv[2]), int(sys.argv[3]),
              sys.argv[4] if len(sys.argv) > 4 else "cuda")
        sys.exit(0)
    sys.exit(__doc__)
