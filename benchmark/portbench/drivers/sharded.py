"""One client, one claim at a time, each proof sharded over `ranks`
ranks, one per card (`parallel.launch.run`: NCCL when every rank has a
card of its own). Every rank draws the same claims from the seed and
calls `prover.mk_mimc_proof(..., mesh=make_mesh(...))` in a loop that
starts at a barrier; after each proof rank 0 says whether the window
has ended. Rank 0 reports its proofs; every other rank the digest of
each of its proofs, which must equal rank 0's, and the modules of JAX,
the JAX package or the oracle that it has loaded once the window has
closed. A traced run times each collective (`Mesh.timed`) in the
window's unprofiled head and profiles the rest in every rank."""

import time

import torch

from .. import drive, runner


def rank_main(rank, cfg, traffic, seed, seconds, trace, overrides, device):
    import torch.distributed as dist
    from starks_tpu_torch.parallel import mesh as pmesh
    mark = drive.SetupMarks()
    mesh = pmesh.make_mesh(device=device)
    prover = drive.load_program(mesh.device, mark)
    sc = drive.stark_config(cfg, overrides)
    steps, consts = cfg["steps"], cfg["round_constants"]
    draw = drive.claims(seed)

    def call(inp):
        return prover.mk_mimc_proof(inp, steps, consts, mesh=mesh,
                                    config=sc)

    prover._ShardedSetup.get(steps, sc, mesh)
    mark("set-up tables")
    call(next(draw))                     # every shape of the window
    drive.sync(mesh.device)
    dist.barrier()
    mark("warm-up")
    setup_end = time.time()

    flag_dev = mesh.device if mesh.backend == "nccl" else "cpu"
    stop = torch.zeros(1, dtype=torch.int32, device=flag_dev)
    proofs, proof_s = [], []
    profiled_from = [0]
    head = {}                            # the head's collectives
    mesh.reset_counts()
    mesh.timed = trace

    def step():
        inp = next(draw)
        t = time.perf_counter()
        proofs.append((inp, call(inp)))
        proof_s.append(time.perf_counter() - t)

    def ended(elapsed, limit):
        """Rank 0's clock decides, for every rank."""
        if rank == 0:
            stop.fill_(int(elapsed >= limit))
        dist.broadcast(stop, 0)
        return bool(stop.item())

    def trace_start():
        profiled_from[0] = len(proofs)
        mesh.timed = False
        head.update(seconds=dict(mesh.seconds), bytes=dict(mesh.bytes),
                    proofs=len(proofs))

    window_s, prof = drive.run_window(seconds, step, trace, mesh.device,
                                      ended, trace_start)
    return {"setup_end": setup_end, "setup_marks": mark.marks,
            "window_s": window_s,
            "digests": [drive.digest(p) for _, p in proofs],
            "proofs": proofs if rank == 0 else None, "times": proof_s,
            "memory_peak_bytes": drive.memory_peak(mesh.device),
            "profile": dict(prof),
            "profiled_proofs": len(proofs) - profiled_from[0],
            "mesh": head or None,
            "forbidden_loaded": runner.forbidden_loaded()}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, overrides: dict = None) -> dict:
    from starks_tpu_torch.ops import _build
    from starks_tpu_torch.parallel import launch
    from starks_tpu_torch.utils import native
    kind = torch.device(device).type
    # Build the libraries once, here, before the ranks load them (nvcc
    # and g++ only: no CUDA context in this process).
    if kind == "cuda":
        _build.build()
    native.build()
    ranks = launch.run(rank_main, traffic["ranks"], cfg, traffic, seed,
                       seconds, trace, overrides, kind, device=kind,
                       timeout=seconds + traffic["rank_setup_limit_s"])
    r0 = ranks[0]
    # Every rank's proof of every claim against rank 0's, by digest.
    differing = sum(d != d0 for r in ranks[1:]
                    for d, d0 in zip(r["digests"], r0["digests"]))
    profiles = [r["profile"] for r in ranks if r["profile"]]
    prof = dict(r0["profile"])
    if profiles:
        prof["busy_s"] = sum(p["busy_s"] for p in profiles) / len(profiles)
        prof["window_s"] = sum(p["window_s"]
                               for p in profiles) / len(profiles)
    peaks = [r["memory_peak_bytes"] for r in ranks
             if r["memory_peak_bytes"] is not None]
    return {"setup_end": r0["setup_end"], "setup_marks": r0["setup_marks"],
            "window_s": r0["window_s"],
            "proofs": r0["proofs"], "completed": len(r0["proofs"]),
            "attempted": len(r0["proofs"]), "failed": 0,
            "times": r0["times"], "time_unit": "proof",
            "memory_peak_bytes": max(peaks) if peaks else None,
            "profile": prof, "profiled_proofs": r0["profiled_proofs"],
            "mesh": r0["mesh"], "rank_proofs_differing": differing,
            "forbidden_loaded": sorted(
                f"{m} (rank {i})" for i, r in enumerate(ranks)
                for m in r["forbidden_loaded"])}
