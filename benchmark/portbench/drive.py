"""What every driver shares: the program's configuration, the claims
drawn from the seed, the measured window, the profiler when traced."""

import hashlib
import pickle
import random
import sys
import time
import traceback

import torch

MODULUS = 2 ** 256 - 351 * 2 ** 32 + 1
# A traced run profiles the last this many seconds of its window: the
# profiler's events (millions in a 2^20 proof's few seconds) take longer
# to read than to record.
PROFILED_S = 10.0
PROTOCOL_KEYS = ("generator", "extension_factor", "spot_checks",
                 "fri_queries", "fri_fold_arity", "fri_base_cutoff")


class SetupMarks:
    """Wall-clock marks of the set-up's stages (the runner splits
    setup_s at them): the program's import, its CUDA context and
    libraries (the kernels built by nvcc on a checkout's first run), the
    configuration's set-up tables, and the warm-up of the cell's
    shapes."""

    def __init__(self):
        self.marks = []

    def __call__(self, stage: str):
        self.marks.append((stage, time.time()))


def load_program(device, mark: SetupMarks):
    """Import the program, make the CUDA context and load (or build) its
    two libraries, marking each."""
    from starks_tpu_torch import prover
    from starks_tpu_torch.ops import _build
    from starks_tpu_torch.utils import native
    mark("import")
    if torch.device(device).type == "cuda":
        torch.zeros(1, device=device)
        _build.load()
    native.load()
    mark("CUDA context and libraries")
    return prover


def stark_config(cfg: dict, overrides: dict = None):
    """The program's StarkConfig for a configuration file's protocol
    values (with `overrides`, the control's weakened ones)."""
    from starks_tpu_torch.config import StarkConfig
    vals = {k: cfg[k] for k in PROTOCOL_KEYS}
    vals.update(overrides or {})
    return StarkConfig(modulus=int(cfg["modulus"]), **vals)


def claims(seed: int):
    """The claims' inputs, uniform in [0, p), an endless stream from
    `seed`. Every claim costs the same work, so seeds differ only in
    the values."""
    rng = random.Random(seed)
    while True:
        yield rng.randrange(MODULUS)


def digest(proof) -> str:
    return hashlib.sha256(pickle.dumps(proof, protocol=4)).hexdigest()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def primer(device):
    """One launch of the program's add kernel (profile.PRIMER before a
    profiled window)."""
    from starks_tpu_torch.ops import plimbs
    one = torch.ones((1, 8), dtype=torch.int32, device=device)
    return lambda: plimbs.add(one, one)


def run_window(seconds: float, step, trace: bool, device, ended=None,
               on_trace_start=lambda: None):
    """Call `step()` back to back until `seconds` have passed; the call
    that crosses the end finishes and counts. `ended(elapsed, limit)`
    says whether the window is over (by default elapsed >= limit; the
    sharded cell's is one decision for all ranks). Traced, the window
    has an unprofiled head of at least one call, where the drivers ask
    the program for its stage and collective times, and then its last
    PROFILED_S (counted from the profiler's start) run under the
    profiler, after `on_trace_start()`: launches, device time and idle
    share come from that part.
    Returns the seconds from the first call's start to the last call's
    end, and the profile's reduction (empty when not traced)."""
    from . import profile
    ended = ended or (lambda elapsed, limit: elapsed >= limit)
    t0 = time.perf_counter()

    def until(start, limit):
        while True:
            step()
            if ended(time.perf_counter() - start, limit):
                return

    if not trace:
        until(t0, seconds)
        return time.perf_counter() - t0, {}
    until(t0, max(seconds - PROFILED_S, 0.0))
    on_trace_start()
    with profile.session(device, primer(device)) as prof:
        until(time.perf_counter(), min(seconds, PROFILED_S))
        end = time.perf_counter()
    return end - t0, prof


def failed_call(what: str):
    """Report a call of the program that raised; the run goes on, and
    its claims count as failed."""
    print(f"portbench: {what} raised:\n{traceback.format_exc()}",
          file=sys.stderr, flush=True)


def memory_peak(device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device)
