"""A backlog of independent claims through the claim-axis prover: each
call of `prover.mk_mimc_proof_batch_fused` takes `claims_per_call`
claims in chunks of `chunk`, the native host trace, back to back."""

import time

import torch

from .. import drive


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, overrides: dict = None) -> dict:
    mark = drive.SetupMarks()
    prover = drive.load_program(device, mark)
    sc = drive.stark_config(cfg, overrides)
    steps, consts = cfg["steps"], cfg["round_constants"]
    per, chunk = traffic["claims_per_call"], traffic["chunk"]
    draw = drive.claims(seed)

    def call(inps):
        return prover.mk_mimc_proof_batch_fused(
            inps, steps, consts, config=sc, chunk=chunk, device=device)

    prover._FusedSetup.get(steps, sc, torch.device(device))
    mark("set-up tables")
    # Every shape of the window: a call of two chunks has every chunk's
    # shapes and the queueing of chunk i+1 before chunk i is assembled.
    call([next(draw) for _ in range(min(per, 2 * chunk))])
    drive.sync(device)
    mark("warm-up")
    setup_end = time.time()

    proofs, call_s = [], []
    count = {"attempted": 0, "failed": 0}

    def step():
        inps = [next(draw) for _ in range(per)]
        count["attempted"] += per
        t = time.perf_counter()
        try:
            out = list(call(inps))
        except RuntimeError:
            drive.failed_call("mk_mimc_proof_batch_fused")
            count["failed"] += per
            return
        call_s.append(time.perf_counter() - t)
        count["failed"] += per - min(per, len(out))
        proofs.extend(zip(inps, out))

    profiled_from = [0]                  # the profiled part's first proof

    def trace_start():
        profiled_from[0] = len(proofs)

    window_s, prof = drive.run_window(seconds, step, trace, device,
                                      on_trace_start=trace_start)
    return {"setup_end": setup_end, "setup_marks": mark.marks,
            "window_s": window_s, "proofs": proofs,
            "completed": len(proofs), "times": call_s,
            "time_unit": f"call of {per} claims",
            "memory_peak_bytes": drive.memory_peak(device),
            "profile": prof,
            "profiled_proofs": len(proofs) - profiled_from[0], **count}
