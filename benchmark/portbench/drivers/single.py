"""One client, one claim at a time in a closed loop, through
`prover.mk_mimc_proof` on one card with the native host trace. In a
traced run each proof of the window's unprofiled head also reports its
stage times (`timings=`, each stage waiting for the card), away from the
profiler, which slows the host's issue."""

import time

import torch

from .. import drive


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, overrides: dict = None) -> dict:
    mark = drive.SetupMarks()
    prover = drive.load_program(device, mark)
    sc = drive.stark_config(cfg, overrides)
    steps, consts = cfg["steps"], cfg["round_constants"]
    draw = drive.claims(seed)

    def call(inp, timings=None):
        return prover.mk_mimc_proof(inp, steps, consts, config=sc,
                                    device=device, timings=timings)

    prover._FusedSetup.get(steps, sc, torch.device(device))
    mark("set-up tables")
    call(next(draw))                     # every shape of the window
    drive.sync(device)
    mark("warm-up")
    setup_end = time.time()

    proofs, proof_s, stages = [], [], []
    count = {"attempted": 0, "failed": 0}
    # Traced: stage times in the head, none in the profiled part.
    traced = {"from": 0, "timed": trace}

    def step():
        inp = next(draw)
        count["attempted"] += 1
        timings = {} if traced["timed"] else None
        t = time.perf_counter()
        try:
            proof = call(inp, timings)
        except RuntimeError:
            drive.failed_call("mk_mimc_proof")
            count["failed"] += 1
            return
        proof_s.append(time.perf_counter() - t)
        proofs.append((inp, proof))
        if timings is not None:
            stages.append(timings)

    def trace_start():
        traced["from"], traced["timed"] = len(proofs), False

    window_s, prof = drive.run_window(seconds, step, trace, device,
                                      on_trace_start=trace_start)
    return {"setup_end": setup_end, "setup_marks": mark.marks,
            "window_s": window_s, "proofs": proofs,
            "completed": len(proofs), "times": proof_s, "time_unit": "proof",
            "timings": stages, "memory_peak_bytes": drive.memory_peak(device),
            "profile": prof,
            "profiled_proofs": len(proofs) - traced["from"], **count}
