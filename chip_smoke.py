#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (starks_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. print the card's name and power limit; build the CUDA kernels from
     starks_tpu_torch/csrc/ into build/ and print the build time, the
     compiler's register report and each kernel's IMAD-class instruction
     count (cuobjdump -sass, where the toolkit has it);
  2. each kernel against its plain PyTorch version, exact equality, on
     seeded random inputs with structured ones up front (all-ones words,
     p - 1, p - 2, 2^255) at the shapes of a 2^16-step proof: the DIF
     transform at 2^13 and 2^16 points, scaled (the LDE's 1/n in its
     last stage) and not, for the chosen stages per pass and one that
     leaves a short last pass; the DIT transform at 2^19 points on the
     LDE's compact coefficients and on a general input, and at 2^16
     with a short first pass; the D/B map; fold4 at every FRI round's
     shape and shift; the elementwise ops with full, 8-periodic and
     constant operands on either side; mul on 2^20 products led by edge
     pairs that reach every carry path of the modmul; scale (with and
     without an accumulator) and cube at 2^19, 2^16, 2^16 + 7, 257, 3
     and 1 elements. Each kernel's device time per launch (CUDA events
     around a run of launches queued behind a spin on the card), its
     per-call cost (host clock around a run of calls) and its plain
     version's per-call cost, beside its bound; then the DIF (scaled and
     not) and DIT transforms for each stages-per-pass width 4-10 (the
     DIT at 2^16 and 2^19, general and compact input); in turns (old,
     new, new, old): the DIF transform then scale against the scaled
     transform, scale then add against scale with an accumulator, mul by
     a constant (the frame scale had) against scale; cube beside a
     torch copy of the same bytes, and the streaming kernels also under
     a flush that leaves no dirty lines in L2 and with warm inputs; the
     AIR's elementwise kernels (mul, add, sub, scale, cube) over 16
     claims at 2^19 in the forms the AIR path runs (each operand per
     claim or shared), each equal to its plain version and to 16
     one-claim launches, timed beside those launches and the bound that
     counts a shared operand once; the device MiMC trace
     (`mimc_trace_kernel`) against its plain version (first rows) and
     the native trace (every row) at 1, 3, 5 and 64 claims with 1,
     1536, 1537 and 2048 round constants (x0 and a constant p - 1), and
     at the all-device proof's shape (one claim, 2^16 steps); the design
     it replaced (every intermediate canonical) timed beside it in turns
     at one and 64 claims x 2^16 and with 2048 constants, in ns per
     dependent step, beside its roofline bound and its chain floor (4
     dependent IMAD.WIDE and 10 dependent IADD3 a step, their latencies
     timed on one thread); `trace_batch_device` of 64 claims at 2^16
     steps against the native host trace of each claim; batch inversion
     (the block scan `batch_inv_up/top/down_kernel`, the set-ups' 1/Z
     tables; the replaced design, one thread per run, beside it) against
     its plain version and hostfield.multi_inv at 1, 3, 257 and 2^16 + 7
     elements and at each size a set-up inverts, 2^16, 2^17, 2^19, 2^21
     and 2^23 (zeros, 1, p - 1 and random elements from the seed), the
     two timed in turns at each set-up size and at one element (the
     inverse alone) beside the function's bound and the scan's chain
     floor; its CUDA launches per call are counted under the profiler in
     phase 7;
  3. the main path: a 2^13-step proof, equal byte for byte to the spec
     oracle (oracle/stark.py) and accepted by the port's verifier;
  4. a 2^16-step proof (2^19-point evaluation domain), accepted by the
     port's verifier, with one flipped byte rejected; per-stage times;
  5. general AIR proofs (benchmark config 3): fib-square at 2^10 steps on
     the card equal to the CPU path byte for byte; the set-ups of
     fib-square at 2^13 and 2^16 and of MiMC as an AIR at 2^13, each
     counted alone and timed: built on the card (x - last, the boundary
     bases by Horner, 1/Z_r by one batch inverse per bounded register),
     with no call of fused.powers, hostfield.multi_inv or eval_poly_at,
     or native.inv_vanishing2; fib-square at 2^13 and 2^16 accepted,
     with a changed boundary value and a flipped leaf byte rejected, the
     output equal to fib_square_output, per-stage times,
     launches per proof; the declarative form equal to the closure form
     at 2^13; MiMC written as an AIR at 2^13 accepted with the output of
     mimc_forward (the path of the cube kernel);
  6. batch proving (config 5): prove_batch of 64 x 2^16 claims, chunk
     16, verified, with a proof store and a resume; claims against
     serial proofs and the oracle; chunks of 16, 4 and 1;
  7. one more MiMC 2^16 and 2^20 and fib-square 2^13 and 2^16 proof,
     one batch chunk and one AIR chunk each under torch.profiler, after
     all timed proofs: CUDA launches, device busy share against the
     steady stage-timed wall time, device time of the field kernels, and
     each field kernel's launches as the profiler lists them beside the
     port's counters for the same run (a profiler session drops its
     first launches of the port's kernels, so each profile starts with
     a primer of its own launches and counts only the device events
     inside the profiled run's range; whatever the profiler still loses
     is printed, and the busy share is then marked a lower bound); the
     CUDA kernels of one batch inverse at one element and at each size
     a set-up inverts, as the profiler lists them, each 2L - 1 for the
     scan's L levels;
  8. every kernel's launches on each main path: the steady MiMC 2^16,
     fib-square 2^13 and 2^16 proofs, the MiMC-as-AIR proof, the batch
     and AIR chunks, the all-device proofs and the device trace, each
     counted alone (counts
     set to 0 just before it, read just after); each kernel > 0 on
     every path that runs it, no scale launch on the MiMC path (its 1/n
     is in the DIF transform), one DIF and one DIT transform for all of
     a proof's columns, a batch chunk launching each kernel as often as
     one MiMC 2^16 proof and an AIR chunk as often as one fib-square
     2^16 proof; one JSON line of kernel rows, each with the count of
     its own main path and the counts of every path, and the result
     line.
  9. benchmark config 4 (BASELINE.md:267: 2^20 steps, a 2^23-point
     domain), run after phase 6 and before the profiled proofs: each
     kernel at config 4's shapes against its plain version, timed
     beside its bound (the DIF transform at 2^20 with 1/n and the
     four-step's local batches, the three-pass DIT to 2^23, the D/B
     map at 2^23 and on a shard with its halo, the L map, fold4 at all
     nine rounds and on a shard's quarter slices, the twiddle product),
     and NTT points/s at 2^20; the set-up of a 2^20 proof, counted alone
     and timed, with its stage seconds (host power tables, upload, 1/Z2's
     sub, sub and mul, the batch inverse, the rest): 1/Z2 on the card
     (sub 2, mul 1, batch_inv 1; no host table function called), equal
     to native.inv_vanishing2's; a first
     and a steady proof with stage times, verified, a flipped byte
     rejected, peak memory and size; then SHARDS ranks (parallel/launch.py), each on cuda:(rank %
     device_count), prove 2^16 and 2^20 steps sharded: every rank's
     proof equals the one-card proof byte for byte, and its set-up
     (built alone first, rank 0's stage seconds printed) builds its rows
     of 1/Z2 on the card; per rank the stage times, each
     collective's count, bytes sent to other ranks and seconds, the
     transport, and the launches (phase 8 counts both paths).
  10. general AIR proofs over a claim axis (`prove_air_batch_fused`), run
     after phase 6, on phase 5's cached 2^16 set-up (phase 5 counts and
     times it); 16 fib-square claims at 2^16 steps in one chunk,
     every claim verified, claims 0 and 15 equal to serial proofs, a
     changed boundary rejected, stage times, peak memory, proofs/s at
     chunks of 16, 4 and 1 (4 claims), the host trace per claim; MiMC as
     an AIR over 4 claims at 2^13, each equal to its serial proof.
  11. the all-device MiMC proof (`prover.mk_mimc_proof_fused(
     device_trace=True)`: its trace built on the card by one launch of
     the trace kernel), run after phase 9 and before the profiled
     proofs, at 2^16 and 2^20 steps: each equal byte for byte to the
     host-trace proof of phase 4 or 9 and verified, launching one trace
     kernel and every other kernel as often as that proof; stage times
     (the device trace a stage of its own) and the calls that wait for
     the card: exactly one more than the host-trace proof's.
  12. config 5 over ranks (`parallel.launch.batch_rank`), run after phase
     6 and before the profiled proofs: two ranks started by
     `parallel.launch.run` share the card (gloo) and prove_batch claims
     0-15 at 2^16 steps, each its contiguous slice of 8 in one chunk of
     8, verified, with a proof store of its own; the proofs gathered on
     rank 0 as wire bytes equal phase 6's byte for byte; per rank and
     aggregate proofs/s (two ranks on one card: correctness, not
     scaling) and each rank's launches, counted alone: one chunk's, as
     one MiMC 2^16 proof's.
Phase 8 also requires the config 4 paths, the all-device proofs, the
device trace, config 5 over ranks and the set-ups to launch only their
kernels; the set-ups are the paths of batch_inv.

    python3 chip_smoke.py --setups [ROOT]

times the set-ups of the port in ROOT instead (default: this checkout;
another commit's tree, unpacked with `git archive`, runs its own code
and builds its own kernels): after a fib-square 2^10 proof on the card,
each of fib-square 2^13 and 2^16, MiMC as an AIR at 2^13 and MiMC at
2^20 (config 4) built anew SETUP_REPS times, each build's seconds to the
card's end; then one fib-square 2^16 set-up under cProfile (the host
functions that take the most time) and one under torch.profiler (its
kernels' device time). Run it on two trees in turns to compare them.

Needs one CUDA card; imports nothing of JAX or of the JAX package.
"""

import contextlib
import copy
import functools
import json
import random
import re
import subprocess
import sys
import time
from pathlib import Path

STARTED = time.perf_counter()
SEED = 20261016
CONSTS = [(i ** 7) ^ 42 for i in range(64)]
INP = 3
SMALL_STEPS = 2 ** 13
BIG_STEPS = 2 ** 16
AIR_CHECK_STEPS = 2 ** 10     # card against the CPU path
AIR_CONSTS = CONSTS[:16]      # MiMC as an AIR: one 16-entry column
EXT = 8
CHECK_CLAIMS = 3              # the claim axis against one-claim launches
TIMED_CLAIMS = 16             # the claim axis timed (the batch chunk)
BATCH_CLAIMS = 64             # BASELINE.md config 5: 64 claims, 2^16 steps
BATCH_CHUNK = 16
CONFIG4_STEPS = 2 ** 20       # BASELINE.md config 4: 2^20 steps, 2^23 points
SHARDS = 4                    # config 4's mesh: four ranks, one row
SHARD_TIMEOUT_S = 600
DP_RANKS = 2                  # config 5 over ranks, sharing the card ...
DP_CLAIMS = 16                # ... claims 0-15 of phase 6 ...
DP_CHUNK = 8                  # ... one chunk a rank
DP_TIMEOUT_S = 300
AIR_CHUNK = 16                # fib-square claims per AIR batch chunk
MIMC_AIR_CLAIMS = 4           # MiMC as an AIR over a claim axis
TRACE_CLAIMS = 64             # the device MiMC trace: claims x BIG_STEPS
TRACE_CHECK_STEPS = 2 ** 6    # ... against its plain version
TRACE_REPS = 5                # launches per timing of a 2^16-step trace
GLOBAL_TRACE_CONSTS = 2048    # more than shared memory holds ...
GLOBAL_CHECK_STEPS = 2 ** 12  # ... each read twice (native trace)
# The trace against its plain version and the native trace: claims, and
# constant counts (one; shared memory full; one over, and 2048: read
# from device memory), each with x0 = p - 1 and a constant p - 1 first.
TRACE_SHAPE_CLAIMS = (1, 3, 5, TRACE_CLAIMS)
TRACE_SHAPE_CONSTS = (1, 1536, 1537, GLOBAL_TRACE_CONSTS)
CHAIN_LINKS = 2 ** 20         # dependent instructions per latency chain
# Batch inversion: timed at every size a set-up inverts (2^16 the
# 2^13-step set-ups' tables, 2^17 a rank's 1/Z2 in the sharded 2^16-
# step proof, 2^19 the 2^16-step set-ups' tables, 2^21 a rank's 1/Z2 in
# config 4's sharded proof, 2^23 config 4's 1/Z2) and at one element;
# checked at those and at short sizes, against hostfield.multi_inv on
# Python ints up to INV_INTS.
INV_TIMED = (SMALL_STEPS * EXT, 2 ** 17, BIG_STEPS * EXT,
             CONFIG4_STEPS * EXT // SHARDS, CONFIG4_STEPS * EXT)
INV_SIZES = (1, 3, 257, BIG_STEPS + 7) + INV_TIMED
INV_INTS = BIG_STEPS * EXT
INV_OLD_THREADS = 2 ** 15     # the replaced design's threads (its run)
INV_CHAIN_SQR = 255           # field::inv_chain: squarings ...
INV_CHAIN_MUL = 17            # ... and products

# Bound model. Bytes: HBM at 3.35 TB/s (H100 SXM data sheet). Operations:
# 32-bit integer multiply-adds at 64 per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0), times the card's SM count and maximum SM clock, read
# at run time.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_CLOCK_PER_SM = 64
ELEM = 32                     # bytes per field element
MODULUS = 2 ** 256 - 351 * 2 ** 32 + 1
C_FOLD = 2 ** 256 - MODULUS   # 2^256 mod p, the modmul's fold constant
MUL_CHECKS = 2 ** 20          # products held against the plain modmul
REPS = 50                     # launches or calls per timing
# Least 32-bit integer operations per field op in csrc/field.cuh. A modmul
# takes 64 (schoolbook) + 8 + 2 (folds by 351) variable 32x32->64
# products, each two multiply-adds (low and high word); all carry adds
# are left out. A square (field::sqr) computes its 28 cross products
# once: 36 products before the same folds. An add or sub takes at least
# one operation per word. So the operations bound is a least time.
OPS_MUL = 2 * (64 + 8 + 2)
OPS_SQR = 2 * (36 + 8 + 2)
OPS_ADD = 8

FLUSH_WORDS = 64 * 2 ** 20   # 256 MB, five times the L2
SRC = "starks_tpu_torch/csrc/kernels.cu"
REPLACES = {
    "dif_pass": "starks_tpu/ops/plimbs.py:154",
    "dit_pass": "starks_tpu/ops/plimbs.py:161",
    "scale": "starks_tpu/ops/plimbs.py:175",
    "db_map": "starks_tpu/ops/plimbs.py:181",
    "l_map": "starks_tpu/ops/plimbs.py:203",
    "fold4": "starks_tpu/ops/plimbs.py:212",
    "mul": "starks_tpu/ops/plimbs.py:149",
    "add": "starks_tpu/ops/plimbs.py:279",
    "sub": "starks_tpu/ops/plimbs.py:284",
    "cube": "starks_tpu/ops/plimbs.py:289",
    # a lax.scan, no Pallas kernel
    "mimc_trace": "starks_tpu/models/mimc.py:73",
    # XLA scans, no Pallas kernel: fused.batch_inv_scan, which the JAX
    # set-ups run (limbs.batch_inv, :213, is the same function)
    "batch_inv": "starks_tpu/ops/fused.py:706",
}
# The main paths, each counted alone, and the kernels each must launch.
# A kernel's row reports the count of the first path here that runs it:
# the 2^16-step paths first, whose shapes phase 2 times. The LDE's 1/n
# runs inside dif_pass; scale runs only on the AIR paths.
NTT_FRI = ["dif_pass", "dit_pass", "fold4"]
FIB = f"fib-square {SMALL_STEPS}"
FIB_BIG = f"fib-square {BIG_STEPS}"
MIMC = f"MiMC {BIG_STEPS}"
MIMC_AIR = f"MiMC-as-AIR {SMALL_STEPS}"
BATCH = f"batch chunk of {BATCH_CHUNK} x MiMC {BIG_STEPS}"
AIR_BATCH = f"AIR chunk of {AIR_CHUNK} x fib-square {BIG_STEPS}"
TRACE = f"device MiMC trace, {TRACE_CLAIMS} x {BIG_STEPS}"
BATCH_DP = (f"config 5 over {DP_RANKS} ranks, {DP_CLAIMS} x MiMC "
            f"{BIG_STEPS}, per rank")
MIMC4 = f"MiMC {CONFIG4_STEPS}"
MIMC_DEV = f"MiMC {BIG_STEPS}, device trace"
MIMC4_DEV = f"MiMC {CONFIG4_STEPS}, device trace"
SHARDED = f"MiMC {{}} over {SHARDS} shards, per rank"
MIMC4_SHARDED = SHARDED.format(CONFIG4_STEPS)
# The set-ups (each counted alone, built before its first proof): the
# domain tables built on the card, one batch inverse per 1/Z table.
SETUP = " set-up"
# --setups: builds of each set-up timed, and rows of its host profile.
SETUP_REPS = 3
SETUP_PROFILE_ROWS = 15
AIR_SETUP_KERNELS = ["sub", "mul", "add", "batch_inv"]
# The sharded LDE is two four-step NTTs: DIF passes over a claim axis
# and the twiddle product (mul); no DIT pass.
SHARD_KERNELS = ["dif_pass", "mul", "db_map", "l_map", "fold4"]
PATH_KERNELS = {
    MIMC: NTT_FRI + ["db_map", "l_map"],
    AIR_BATCH: NTT_FRI + ["scale", "mul", "add", "sub"],
    FIB_BIG: NTT_FRI + ["scale", "mul", "add", "sub"],
    FIB: NTT_FRI + ["scale", "mul", "add", "sub"],
    MIMC_AIR: NTT_FRI + ["scale", "mul", "add", "sub", "cube"],
    BATCH: NTT_FRI + ["db_map", "l_map"],
    MIMC4: NTT_FRI + ["db_map", "l_map"],
    SHARDED.format(BIG_STEPS): SHARD_KERNELS,
    MIMC4_SHARDED: SHARD_KERNELS,
    MIMC_DEV: NTT_FRI + ["db_map", "l_map", "mimc_trace"],
    MIMC4_DEV: NTT_FRI + ["db_map", "l_map", "mimc_trace"],
    TRACE: ["mimc_trace"],
    BATCH_DP: NTT_FRI + ["db_map", "l_map"],
    FIB_BIG + SETUP: AIR_SETUP_KERNELS,
    FIB + SETUP: AIR_SETUP_KERNELS,
    MIMC_AIR + SETUP: AIR_SETUP_KERNELS,
    MIMC4 + SETUP: ["sub", "mul", "batch_inv"],
}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def rand_elems(n, gen, device):
    """n seeded random canonical field elements on `device`."""
    import torch
    from starks_tpu_torch.ops import limbs as fl
    words = torch.randint(-2**31, 2**31, (n, 8), generator=gen,
                          dtype=torch.int32)
    return fl.cond_sub_p(words.to(device))


def structured_ints():
    """Canonical values that load the carry chains: 0, 1, 2, p - 1, p - 2,
    2^255, 2^240 - 1, and every pattern of all-ones and zero words
    (reduced mod p)."""
    m = MODULUS
    ones = [sum(0xFFFFFFFF << (32 * i) for i in range(8) if mask >> i & 1)
            % m for mask in range(1, 256)]
    return [0, 1, 2, m - 1, m - 2, 2 ** 255, (1 << 240) - 1] + ones


def edge_elems(device):
    from starks_tpu_torch.utils.conversions import ints_to_tensor
    return ints_to_tensor(structured_ints(), device)


def with_edges(a, front):
    """a with its first rows replaced by `front`."""
    m = min(a.shape[0], front.shape[0])
    a[:m] = front[:m]
    return a


def power_like(tw):
    """tw with tw[0] = 1, as in every power table: the DIF transform's
    last stage relies on it (no twiddle product)."""
    tw[0] = 0
    tw[0, 0] = 1
    return tw


def dif_ops(n, scaled=True):
    """Least operations of an n-point DIF transform: log n stages of n/2
    butterflies of a modmul and two adds, the last stage's twiddle (1)
    not multiplied; with a scale, n more modmuls in that stage."""
    return ((n.bit_length() - 1) * n // 2 * (OPS_MUL + 2 * OPS_ADD)
            + (n // 2 if scaled else -n // 2) * OPS_MUL)


def mul_edge_pairs(seed=SEED, constructed=1024):
    """Operand pairs (a, b), as two int lists, that reach every carry path
    of the modmul in csrc/field.cuh: every pair of structured values, and
    pairs built as b = r / a for a random a and a chosen result r. With
    P = a*b, d = floor(P/p) - floor(P/2^256) and r = P mod p, the second
    fold carries out (top = 1) exactly when c <= r < d*c, and the folded
    value lands in [p, 2p) before the last conditional subtract exactly
    when r < c (c = 2^256 mod p). A random a makes P ~ 2^510 and d ~ 2^38,
    so half the built pairs take r < c and half r in [c, 2^70)."""
    vals = structured_ints()
    a = [x for x in vals for _ in vals]
    b = [y for _ in vals for y in vals]
    rng = random.Random(seed)
    for i in range(constructed):
        x = rng.randrange(1, MODULUS)
        r = (rng.randrange(C_FOLD) if i % 2 == 0
             else rng.randrange(C_FOLD, 2 ** 70))
        a.append(x)
        b.append(r * pow(x, MODULUS - 2, MODULUS) % MODULUS)
    return a, b


@functools.lru_cache(maxsize=None)
def card_clocks(device):
    """(SM count, maximum SM clock in MHz) of the card."""
    import torch
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi: {res.stderr.strip()}")
    mhz = float(res.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(device).multi_processor_count, mhz


def dit_ops(n, ext=1):
    """Least operations of an n-point DIT transform whose input is zero
    off the multiples of ext: its first log2(ext) stages only copy, the
    other stages take n/2 butterflies of a modmul, an add and a sub."""
    stages = n.bit_length() - 1 - (ext.bit_length() - 1)
    return stages * n // 2 * (OPS_MUL + 2 * OPS_ADD)


def kernel_cases(steps, device):
    """(name, wrapper, plain, [args, ...], bytes, ops, warm) for each
    kernel at the shapes a `steps`-step proof gives it, with structured
    values up front in every array. Every args tuple is checked and
    timed; the first is bounded and goes into the kernel's row. `warm`:
    the proof finds the inputs in the 50 MB L2 (an NTT pass or FRI round
    reads its predecessor's output), so the kernel is timed without a
    flush; the others are timed with the L2 overwritten before each
    launch."""
    import torch
    from starks_tpu_torch.ops import plimbs
    from starks_tpu_torch.utils.conversions import ints_to_tensor
    gen = torch.Generator().manual_seed(SEED)
    n_big = steps * EXT
    edge = edge_elems(device)

    def arr(n, front=edge):
        return with_edges(rand_elems(n, gen, device), front)

    def one():
        return rand_elems(1, gen, device)[0]

    const = rand_elems(1, gen, device)          # [1, 8], read periodically

    x_small, tw_small = arr(steps), power_like(arr(steps))
    x_13, tw_13 = arr(SMALL_STEPS), power_like(arr(SMALL_STEPS))
    x_big, tw_big = arr(n_big), arr(n_big)
    coeffs = arr(steps)                         # the LDE's compact input
    p, xs, iz2 = arr(n_big), arr(n_big), arr(n_big)
    k_tab, zni = arr(EXT * len(CONSTS)), arr(EXT)
    d, b, cp, cb = arr(n_big), arr(n_big), arr(EXT), arr(EXT)
    s, last, slope, ia = one(), one(), one(), one()
    sx, eta = one(), one()
    q = n_big // 4
    ip = arr(q)                                 # round 0's u-table
    ea, eb = (ints_to_tensor(v, device) for v in mul_edge_pairs())
    check(ea.shape[0] < MUL_CHECKS, "too many edge pairs")
    ma, mb = arr(MUL_CHECKS, ea), arr(MUL_CHECKS, eb)

    def stage_bytes(n):          # x in, out, stage-0 twiddles n/2
        return ELEM * (2 * n + n // 2)

    def ragged(*arrays):         # the streaming frame's ragged sizes
        return [tuple(a[:m] for a in arrays) for m in
                (steps + 7, 257, 3, 1)]

    def short_k(n):              # stages per pass that leave a short pass
        logn = n.bit_length() - 1
        return next(k for k in range(plimbs.dif_pass_stages(n) - 1, 0, -1)
                    if logn % k)

    folds = []                   # every FRI round of the proof
    n_r = n_big
    while n_r // 4 >= 2 ** 5:
        folds.append((arr(n_r), ip, sx, eta, 2 * len(folds)))
        n_r //= 4
    check(len(folds) == 7, f"{len(folds)} FRI rounds, expected 7")

    return [
        ("dif_pass", plimbs.dif_transform,
         lambda x, tw, k=None, sc=None: plimbs.dif_transform_plain(x, tw,
                                                                   sc),
         [(x_small, tw_small, None, s), (x_small, tw_small),
          (x_small, tw_small, short_k(steps), s),
          (x_13, tw_13, None, s), (x_13, tw_13, short_k(SMALL_STEPS), s),
          (x_13, tw_13)],
         stage_bytes(steps), dif_ops(steps), True),
        ("scale", plimbs.scale, plimbs.scale_plain,
         [(x_big, s), (x_big, s, p), (x_small, s), (x_small, s, d[:steps])]
         + [(x, s) for (x,) in ragged(x_big)]
         + [(x, s, a) for x, a in ragged(x_big, p)],
         ELEM * (2 * n_big + 1), n_big * OPS_MUL, False),
        ("dit_pass", plimbs.dit_transform,
         lambda x, tw, k=None, ext=1: plimbs.dit_transform_plain(x, tw,
                                                                  ext),
         [(coeffs, tw_big, None, EXT), (x_big, tw_big),
          (x_small, tw_small), (x_small, tw_small, short_k(steps))],
         ELEM * (steps + n_big + n_big // 2),   # the LDE's: compact in
         dit_ops(n_big, EXT), True),
        ("db_map", plimbs.db_map, plimbs.db_map_plain,
         [(p, xs, k_tab, zni, iz2, last, slope, ia, EXT)],
         ELEM * (5 * n_big + k_tab.shape[0] + EXT + 3),
         n_big * (5 * OPS_MUL + OPS_SQR + 5 * OPS_ADD), False),
        ("l_map", plimbs.l_map, plimbs.l_map_plain, [(d, p, b, cp, cb)],
         ELEM * (4 * n_big + 2 * EXT), n_big * (2 * OPS_MUL + 2 * OPS_ADD),
         False),
        ("fold4", plimbs.fold4, plimbs.fold4_plain, folds,
         ELEM * (n_big + 2 * q + 2), q * (5 * OPS_MUL + 13 * OPS_ADD),
         True),
        ("mul", plimbs.mul, plimbs.mul_plain,
         [(x_big, p), (d, zni), (const, xs), (ma, mb)], ELEM * 3 * n_big,
         n_big * OPS_MUL, False),
        ("add", plimbs.add, plimbs.add_plain,
         [(x_big, p), (const, xs), (d, cp)], ELEM * 3 * n_big,
         n_big * OPS_ADD, False),
        ("sub", plimbs.sub, plimbs.sub_plain,
         [(x_big, p), (zni, xs), (b, const)], ELEM * 3 * n_big,
         n_big * OPS_ADD, False),
        ("cube", plimbs.cube, plimbs.cube_plain,
         [(x_big,), (x_small,)] + ragged(x_big),
         ELEM * 2 * n_big, n_big * (OPS_MUL + OPS_SQR), False),
    ]


def call_ms(fn, device, reps=REPS):
    """Per-call cost in ms: the host clock around `reps` calls that end
    in one synchronize, over `reps`. What a caller pays per call: the
    wrapper's host work, the launch, and the device time where that is
    longer."""
    import torch
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn, device, spin_ms, flush=None, reps=REPS):
    """Device time per call of `fn` in ms, after a warm-up call.

    A spin of `spin_ms` on the card is queued first, then the calls: so
    the host queues every launch (wrapper work and all) while the card
    is still spinning, and the events see only the card's work. That
    the spin was still running when the last call returned is checked
    (else the spin is lengthened and the run repeated). Without `flush`,
    events around `reps` back-to-back calls, over `reps` (the inputs
    stay in L2). With `flush` (a call that overwrites the L2), it runs
    before each call and events around each call are summed."""
    import torch
    fn()
    torch.cuda.synchronize(device)
    for _ in range(4):
        torch.cuda._sleep(int(spin_ms * card_clocks(device)[1] * 1e3))
        spun = torch.cuda.Event()
        spun.record()
        if flush is None:
            windows = [(torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))]
            windows[0][0].record()
            for _ in range(reps):
                fn()
            windows[0][1].record()
        else:
            windows = []
            for _ in range(reps):
                flush()
                w = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
                w[0].record()
                fn()
                w[1].record()
                windows.append(w)
        ahead = not spun.query()
        torch.cuda.synchronize(device)
        if ahead:
            return sum(a.elapsed_time(b) for a, b in windows) / reps
        spin_ms *= 4
    check(False, "the host never ran ahead of the card")


def kernel_times(fn, device, flush=None, reps=REPS):
    """(device ms per call, per-call ms) of `fn`, over `reps` calls."""
    per_call = call_ms(fn, device, reps)
    spin = 2 * reps * per_call + 1.0
    return device_ms(fn, device, spin, flush, reps), per_call


def max_abs_err(wrapper, plain, args) -> int:
    """Largest word difference between the kernel and its plain version;
    fails unless they are equal."""
    import torch
    got = wrapper(*args)
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    check(err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)),
          f"kernel {wrapper.__name__} disagrees with its plain version")
    return err


def phase_kernels(steps, device, plain_reps=3):
    """Phase 2: each kernel equals its plain version; device time per
    launch, per-call cost and bound."""
    import torch
    sms, mhz = card_clocks(device)
    ops_per_s = INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6
    print(f"  {sms} SMs at {mhz:.0f} MHz max: {ops_per_s:.4e} int32 "
          f"multiply-adds/s", flush=True)
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=device).zero_
    rows = {}
    for name, wrapper, plain, cases, nbytes, ops, warm in kernel_cases(
            steps, device):
        err = max(max_abs_err(wrapper, plain, args) for args in cases)
        times = [kernel_times(lambda a=a: wrapper(*a), device,
                              None if warm else flush) for a in cases]
        args = cases[0]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        row = {"name": name, "route": "cuda", "source": SRC,
               "replaces": REPLACES[name], "launches": 0,
               "max_abs_err": err, "ms": times[0][0],
               "call_ms": times[0][1],
               "plain_ms": call_ms(lambda: plain(*args), device,
                                   plain_reps),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": None, "l2": "warm" if warm else "flushed"}
        rows[name] = row
        print(f"  {name:<10s} equal to plain in {len(cases)} case(s) "
              f"(max_abs_err {err}); device {row['ms']:.6f} ms per call, "
              f"per-call {row['call_ms']:.6f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}), L2 {row['l2']}", flush=True)
        for i, (dev, per_call) in enumerate(times[1:], 1):
            print(f"    case {i}: device {dev:.6f} ms, per-call "
                  f"{per_call:.6f} ms", flush=True)
    return rows


def claim_cases(claims, steps, device, seed):
    """(name, wrapper, plain, args, claimed, warm) for each kernel of the
    MiMC path over `claims` claims at the shapes a `steps`-step proof
    gives it (the first case of `kernel_cases`), seeded: every per-claim
    array and operand distinct (claim 0's arrays led by the structured
    values), the shared tables once. `claimed` marks the arguments with
    the claim axis."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    n_big = steps * EXT
    edge = edge_elems(device)

    def arr(n):
        return rand_elems(n, gen, device)

    def per_claim(n):
        out = torch.stack([arr(n) for _ in range(claims)])
        with_edges(out[0], edge)
        return out

    def per_claim_elem():
        return torch.stack([arr(1)[0] for _ in range(claims)])

    x, coeffs = per_claim(steps), per_claim(steps)
    p, d, b, vals = (per_claim(n_big) for _ in range(4))
    tw_small, tw_big = power_like(arr(steps)), arr(n_big)
    xs, iz2, ip = arr(n_big), arr(n_big), arr(n_big // 4)
    k_tab, zni = arr(EXT * len(CONSTS)), arr(EXT)
    s, last, eta = arr(1)[0], arr(1)[0], arr(1)[0]
    slope, ia, sx = per_claim_elem(), per_claim_elem(), per_claim_elem()
    cp, cb = per_claim(EXT), per_claim(EXT)
    from starks_tpu_torch.ops import plimbs
    return [
        ("dif_pass", plimbs.dif_transform,
         lambda x, tw, k=None, sc=None: plimbs.dif_transform_plain(x, tw,
                                                                   sc),
         (x, tw_small, None, s), (1, 0, 0, 0), True),
        ("dit_pass", plimbs.dit_transform,
         lambda x, tw, k=None, ext=1: plimbs.dit_transform_plain(x, tw,
                                                                  ext),
         (coeffs, tw_big, None, EXT), (1, 0, 0, 0), True),
        ("db_map", plimbs.db_map, plimbs.db_map_plain,
         (p, xs, k_tab, zni, iz2, last, slope, ia, EXT),
         (1, 0, 0, 0, 0, 0, 1, 1, 0), False),
        ("l_map", plimbs.l_map, plimbs.l_map_plain, (d, p, b, cp, cb),
         (1, 1, 1, 1, 1), False),
        ("fold4", plimbs.fold4, plimbs.fold4_plain, (vals, ip, sx, eta, 0),
         (1, 0, 1, 0, 0), True),
    ]


def claim_args(args, claimed, c):
    """Claim c's arguments: its slice of every per-claim argument."""
    return tuple(a[c] if cl else a for a, cl in zip(args, claimed))


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def phase_claims(rows, device):
    """Phase 2, continued: the claim axis of the five kernels of the MiMC
    path. Each, over CHECK_CLAIMS claims in one launch, equals its plain
    version (with the same claim axis) and its launches for one claim at
    a time, exactly; then its device time per launch over TIMED_CLAIMS
    claims, beside TIMED_CLAIMS times its one-claim bound. Adds
    `claims16` to each kernel's row."""
    import torch
    for name, wrapper, plain, args, claimed, _ in claim_cases(
            CHECK_CLAIMS, BIG_STEPS, device, SEED + 4):
        got, want = as_tuple(wrapper(*args)), as_tuple(plain(*args))
        singles = [as_tuple(wrapper(*claim_args(args, claimed, c)))
                   for c in range(CHECK_CLAIMS)]
        each = tuple(torch.stack(parts) for parts in zip(*singles))
        check(all(torch.equal(g, w) and torch.equal(g, e)
                  for g, w, e in zip(got, want, each)),
              f"kernel {name} over {CHECK_CLAIMS} claims differs from its "
              f"plain version or its one-claim launches")
        print(f"  {name:<10s} over {CHECK_CLAIMS} claims in one launch "
              f"equals its plain version and {CHECK_CLAIMS} one-claim "
              f"launches", flush=True)
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=device).zero_
    for name, wrapper, _, args, _, warm in claim_cases(
            TIMED_CLAIMS, BIG_STEPS, device, SEED + 5):
        dev, per_call = kernel_times(lambda: wrapper(*args), device,
                                     None if warm else flush)
        row = rows[name]
        bound = TIMED_CLAIMS * row["bound_ms"]
        row["claims16"] = {"claims": TIMED_CLAIMS, "ms": dev,
                           "call_ms": per_call, "bound_ms": bound,
                           "ms_per_claim": dev / TIMED_CLAIMS}
        print(f"  {name:<10s} over {TIMED_CLAIMS} claims: device {dev:.6f} "
              f"ms per launch ({dev / TIMED_CLAIMS:.6f} per claim; one "
              f"claim {row['ms']:.6f}), per-call {per_call:.6f} ms, "
              f"{TIMED_CLAIMS} x bound {bound:.6f} ms ({bound / dev:.1%})",
              flush=True)


def elementwise_claim_cases(claims, device, seed):
    """(name, form, wrapper, plain, args, claimed, bytes, ops) for the
    AIR's elementwise kernels over `claims` claims at n = 2^19 (a 2^16-step
    proof's domain), in the forms the AIR path runs: each operand per
    claim ([B, L, 8], claim 0's led by the structured values) or shared
    ([L, 8], read by every claim and counted once in the bytes)."""
    import torch
    from starks_tpu_torch.ops import plimbs
    gen = torch.Generator().manual_seed(seed)
    n, b = BIG_STEPS * EXT, claims
    edge = edge_elems(device)

    def per_claim(length):
        out = torch.stack([rand_elems(length, gen, device)
                           for _ in range(b)])
        with_edges(out[0], edge)
        return out

    x, y, acc = per_claim(n), per_claim(n), per_claim(n)
    tab_c, one_c = per_claim(EXT), per_claim(1)   # weights, i_ev constant
    shared, tab_s = rand_elems(n, gen, device), rand_elems(EXT, gen, device)
    s_c = rand_elems(b, gen, device)              # each claim's scalar
    full = ELEM * b * n
    mul_ops, add_ops = b * n * OPS_MUL, b * n * OPS_ADD
    return [
        ("mul", "column x column", plimbs.mul, plimbs.mul_plain, (x, y),
         (1, 1), 3 * full, mul_ops),
        ("mul", "column x shared column (x - last)", plimbs.mul,
         plimbs.mul_plain, (x, shared), (1, 0), 2 * full + ELEM * n,
         mul_ops),
        ("mul", "column x claim's 8-periodic weights", plimbs.mul,
         plimbs.mul_plain, (x, tab_c), (1, 1), 2 * full + ELEM * EXT * b,
         mul_ops),
        ("mul", "column x shared 8-periodic 1/Znum", plimbs.mul,
         plimbs.mul_plain, (x, tab_s), (1, 0), 2 * full + ELEM * EXT,
         mul_ops),
        ("add", "column + column", plimbs.add, plimbs.add_plain, (x, y),
         (1, 1), 3 * full, add_ops),
        ("sub", "column - column", plimbs.sub, plimbs.sub_plain, (x, y),
         (1, 1), 3 * full, add_ops),
        ("sub", "column - claim's constant", plimbs.sub, plimbs.sub_plain,
         (x, one_c), (1, 1), 2 * full + ELEM * b, add_ops),
        ("scale", "shared basis x claim's boundary value", plimbs.scale,
         plimbs.scale_plain, (shared, s_c), (0, 1), full + ELEM * (n + b),
         mul_ops),
        ("scale", "acc + shared basis x claim's value", plimbs.scale,
         plimbs.scale_plain, (shared, s_c, acc), (0, 1, 1),
         2 * full + ELEM * (n + b), mul_ops + add_ops),
        ("scale", "acc + column x claim's weight", plimbs.scale,
         plimbs.scale_plain, (x, s_c, acc), (1, 1, 1),
         3 * full + ELEM * b, mul_ops + add_ops),
        ("cube", "column", plimbs.cube, plimbs.cube_plain, (x,), (1,),
         2 * full, b * n * (OPS_MUL + OPS_SQR)),
    ]


def phase_elementwise_claims(rows, device):
    """Phase 2, continued: the claim axis of the AIR's elementwise kernels
    (A7 mul, A8 add, sub and cube, A2 scale). Each form, over
    TIMED_CLAIMS claims at 2^19 in one launch, equals its plain version
    (with the same claim axis) and TIMED_CLAIMS one-claim launches,
    exactly; then the device time of the launch (L2 flushed before it)
    against the TIMED_CLAIMS one-claim launches (flushed before the
    run), beside the bound of the launch. Adds `claims16` to the rows."""
    import torch
    sms, mhz = card_clocks(device)
    ops_per_s = INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=device).zero_
    b = TIMED_CLAIMS
    for name, form, wrapper, plain, args, claimed, nbytes, ops in \
            elementwise_claim_cases(b, device, SEED + 11):
        got = wrapper(*args)
        singles = [wrapper(*claim_args(args, claimed, c)) for c in range(b)]
        check(torch.equal(got, plain(*args))
              and torch.equal(got, torch.stack(singles)),
              f"kernel {name} ({form}) over {b} claims differs from its "
              f"plain version or its one-claim launches")
        del singles
        dev, per_call = kernel_times(lambda: wrapper(*args), device, flush)

        def one_claim_launches():
            for c in range(b):
                wrapper(*claim_args(args, claimed, c))
        each, _ = kernel_times(one_claim_launches, device, flush)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        bound = max(bytes_ms, ops_ms)
        entry = {"form": form, "claims": b, "max_abs_err": 0, "ms": dev,
                 "call_ms": per_call, "one_claim_launches_ms": each,
                 "bound_ms": bound,
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "l2": "flushed"}
        rows[name].setdefault("claims16", []).append(entry)
        print(f"  {name:<6s} {form} over {b} claims: equal to plain and "
              f"{b} one-claim launches; device {dev:.6f} ms per launch "
              f"({dev / b:.6f} per claim), {b} one-claim launches "
              f"{each:.6f} ms, bound {bound:.6f} ms ({entry['bound_by']}, "
              f"{bound / dev:.1%})", flush=True)
    torch.cuda.empty_cache()       # the plain versions' limb products


def inv_ops(x) -> int:
    """Least operations of the function batch_inv computes over x, by
    Montgomery's trick: a forward product and two backward products per
    nonzero element (a zero skips them) and one Fermat inverse in all,
    by the addition chain of field::inv_chain (255 squarings, 17
    products), whatever the kernels' tile shape."""
    from starks_tpu_torch.ops import limbs as fl
    nonzero = x.shape[0] - int(fl.eq_zero(x).sum())
    return (3 * nonzero * OPS_MUL + INV_CHAIN_SQR * OPS_SQR
            + INV_CHAIN_MUL * OPS_MUL)


def inv_chain_products(n) -> int:
    """Dependent products on the critical path of the block scan over n
    elements at `plimbs.batch_inv_shape(n)`: per level below the top, the
    up-sweep's group chain (k products) and tree (log2 T), the down-
    sweep's group product from its last prefix (1), tree up and down
    (2 log2 T) and backward chain (k); at the top block (T', k'), its
    forward chain, tree up, the inverse's 255 squarings and 17 products,
    tree down and backward chain."""
    from starks_tpu_torch.ops import plimbs
    threads, k, k_up = plimbs.batch_inv_shape(n)
    levels = plimbs.batch_inv_levels(n, threads, k, k_up)
    depth = threads.bit_length() - 1
    total = 0
    for lvl in range(len(levels) - 1):
        kl = k if lvl == 0 else k_up
        total += (kl + depth) + (1 + 2 * depth + kl)
    m = levels[-1]
    t_top, k_top = 32, 1
    while t_top < threads and t_top < m:
        t_top *= 2
    while k_top < (k if len(levels) == 1 else k_up) and t_top * k_top < m:
        k_top *= 2
    top_depth = t_top.bit_length() - 1
    return (2 * k_top + 2 * top_depth + INV_CHAIN_SQR + INV_CHAIN_MUL
            + total)


def inv_replaced(x):
    """The replaced design (`starks_batch_inv_runs`) over x on the current
    stream, at its former default run (n / 2^15 rounded up), timed beside
    the scan. It counts no launch: no main path runs it."""
    import torch
    from starks_tpu_torch.ops import _build
    n = x.shape[0]
    out = torch.empty_like(x)
    rc = _build.load().starks_batch_inv_runs(
        x.data_ptr(), out.data_ptr(), n, -(-n // INV_OLD_THREADS),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc == 0, f"starks_batch_inv_runs returned {rc}")
    return out


def phase_batch_inv(rows, device):
    """Phase 2, batch inversion (the block scan of csrc/kernels.cu, which
    the set-ups run): at each of INV_SIZES, on seeded random elements
    with zeros scattered (one in 50) and the structured values up front
    (0, 1, p - 1, p - 2, ...), the scan (`plimbs.batch_inv`) and the
    replaced design (one thread per run, `field::inv`) each equal the
    plain version exactly, which equals hostfield.multi_inv on Python
    ints up to INV_INTS elements; at each size of INV_TIMED, and at one
    element (the inverse alone), their device times in turns (replaced,
    scan, scan, replaced; inputs warm in L2, as the set-up's product
    leaves them) beside the function's bound and the scan's chain floor
    (its critical path's dependent products, at 2 t_mul + 5 t_add clocks
    each, t_mul and t_add as phase_trace timed them, at the maximum SM
    clock); then the row of the `kernels` line (2^19, with every size
    beside it). Phase 7 counts the scan's CUDA launches per call
    (`count_inv_launches`)."""
    import torch
    from starks_tpu_torch.ops import plimbs
    from starks_tpu_torch.utils import hostfield
    from starks_tpu_torch.utils.conversions import tensor_to_ints
    sms, mhz = card_clocks(device)
    ops_per_s = INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6
    designs = {"replaced": inv_replaced,
               "scan": plimbs.batch_inv}
    gen = torch.Generator().manual_seed(SEED + 20)
    edge = edge_elems(device)
    arrays, err = {}, 0
    for n in INV_SIZES:
        x = with_edges(rand_elems(n, gen, device), edge)
        x[torch.randperm(n, generator=gen)[:n // 50].to(device)] = 0
        arrays[n] = x
        want = plimbs.batch_inv_plain(x)
        for name, run in designs.items():
            got = run(x)
            err = max(err, int((got.to(torch.int64)
                                - want.to(torch.int64)).abs().max()))
            check(torch.equal(got, want),
                  f"batch_inv ({name}) at {n} elements disagrees with its "
                  f"plain version")
        if n <= INV_INTS:
            check(tensor_to_ints(want)
                  == hostfield.multi_inv(tensor_to_ints(x)),
                  f"batch_inv_plain at {n} elements disagrees with "
                  f"hostfield.multi_inv")
    print(f"  batch_inv   the scan and the replaced design equal to plain "
          f"at {len(INV_SIZES)} sizes "
          f"({', '.join(map(str, INV_SIZES))}) (max_abs_err {err}), plain "
          f"equal to hostfield.multi_inv up to {INV_INTS}", flush=True)

    chain = rows["mimc_trace"]["chain_floor"]
    product_clocks = 2 * chain["t_mul_clocks"] + 5 * chain["t_add_clocks"]
    timed = {}
    for n in (1,) + INV_TIMED:
        x = arrays[n]
        bytes_ms = 2 * ELEM * n / HBM_BYTES_PER_S * 1e3
        ops_ms = inv_ops(x) / ops_per_s * 1e3
        shape = plimbs.batch_inv_shape(n)
        levels = plimbs.batch_inv_levels(n, *shape)
        products = inv_chain_products(n)
        ms = {name: [] for name in designs}
        order = list(designs) + list(designs)[::-1]
        for name in order:
            ms[name].append(kernel_times(lambda: designs[name](x), device,
                                         reps=10)[0])
        ms = {name: sum(v) / len(v) for name, v in ms.items()}
        entry = {"ms": ms["scan"], "replaced_ms": ms["replaced"],
                 "replaced_run": -(-n // INV_OLD_THREADS),
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "chain_products": products,
                 "chain_floor_ms": products * product_clocks / (mhz * 1e3),
                 "threads": shape[0], "k": shape[1], "k_up": shape[2],
                 "levels": levels, "cuda_launches": None}
        timed[n] = entry
        print(f"    {n} elements (tile {shape[0]} x {shape[1]}, levels "
              f"{levels}): scan {ms['scan']:.6f} ms, replaced (run "
              f"{entry['replaced_run']}) {ms['replaced']:.6f} ms; bound "
              f"{entry['bound_ms']:.6f} ms ({entry['bound_by']}, "
              f"{entry['bound_ms'] / ms['scan']:.2%}); chain floor "
              f"{entry['chain_floor_ms']:.6f} ms ({products} products, "
              f"{entry['chain_floor_ms'] / ms['scan']:.2%})", flush=True)
    n = BIG_STEPS * EXT
    x, big = arrays[n], arrays[CONFIG4_STEPS * EXT]
    dev, per_call = kernel_times(lambda: plimbs.batch_inv(x), device,
                                 reps=10)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    plimbs.batch_inv_plain(big)
    torch.cuda.synchronize(device)
    timed[CONFIG4_STEPS * EXT]["plain_ms"] = (time.perf_counter() - t0) * 1e3
    row = {"name": "batch_inv", "route": "cuda", "source": SRC,
           "replaces": REPLACES["batch_inv"], "launches": 0,
           "max_abs_err": err, "ms": timed[n]["ms"], "call_ms": per_call,
           "plain_ms": call_ms(lambda: plimbs.batch_inv_plain(x), device, 3),
           "bound_ms": timed[n]["bound_ms"], "bound_by": timed[n]["bound_by"],
           "library_ms": None, "l2": "warm", "elements": n,
           "tile": {k: timed[n][k] for k in ("threads", "k", "k_up")},
           "cuda_launches_per_call": None,
           "chain_floor_ms": timed[n]["chain_floor_ms"],
           "replaced_ms": timed[n]["replaced_ms"], "by_size": timed}
    rows["batch_inv"] = row
    print(f"  batch_inv   {n} elements: device {row['ms']:.6f} ms (one more "
          f"timing: {dev:.6f}), per call {per_call:.6f} ms, plain "
          f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_ms'] / row['ms']:.1%}), chain floor "
          f"{row['chain_floor_ms']:.6f} ms; {CONFIG4_STEPS * EXT} elements: "
          f"plain {timed[CONFIG4_STEPS * EXT]['plain_ms']:.3f} ms (one call)",
          flush=True)


def setup_timed(build, device):
    """`build()` (a set-up), counted alone and timed to the card's end,
    with spies on the host functions that would build a domain table one
    point at a time, or on the host where the JAX package builds it on
    the device: none may be called. Returns (set-up, seconds, launch
    counts)."""
    import torch
    from starks_tpu_torch.ops import fused
    from starks_tpu_torch.utils import hostfield, native
    spied = ((fused, "powers"), (hostfield, "multi_inv"),
             (hostfield, "eval_poly_at"), (native, "inv_vanishing2"))
    with contextlib.ExitStack() as stack:
        spies = [stack.enter_context(Spy(m, name)) for m, name in spied]
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        su, launches = counted(build)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    called = {s.name: s.calls for s in spies if s.calls}
    check(not called, f"a set-up built a table on the host: {called}")
    return su, seconds, launches


def print_setup_split(what, split):
    print(f"  {what}, stages (ms): " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in split.items()), flush=True)


def print_setup(what, seconds, launches):
    print(f"  {what} set-up: {seconds:.4f} s, on the card (fused.powers, "
          f"hostfield.multi_inv and eval_poly_at, native.inv_vanishing2 not "
          f"called); launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items() if v), flush=True)


def trace_design(entry):
    """The C entry `entry` (mimc_trace's arguments) as a function of (x0,
    consts, steps) on the current stream: a design timed beside the
    kept kernel. It counts no launch: no main path runs it."""
    import torch
    from starks_tpu_torch.ops import _build
    fn = getattr(_build.load(), entry)

    def run(x0, consts, steps):
        out = torch.empty((x0.shape[0], steps, 8), dtype=torch.int32,
                          device=x0.device)
        rc = fn(x0.data_ptr(), consts.data_ptr(), consts.shape[0],
                out.data_ptr(), steps, x0.shape[0],
                torch.cuda.current_stream(x0.device).cuda_stream)
        check(rc == 0, f"{entry} returned {rc}")
        return out
    return run


def chain_clocks(device):
    """(t_mul, t_add): SM clocks per link of one thread's chain of
    CHAIN_LINKS dependent IMAD.WIDE.U32 (no addend, as every product of
    the trace kernel) and of dependent IADD3 with carry in and out
    (`chain_probe_kernel`, clock64 around the chain)."""
    import torch
    from starks_tpu_torch.ops import _build
    out = torch.zeros(2, dtype=torch.int64, device=device)
    links = []
    for kind in (0, 1):
        rc = _build.load().starks_chain_probe(
            kind, CHAIN_LINKS, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
        check(rc == 0, f"starks_chain_probe({kind}) returned {rc}")
        torch.cuda.synchronize(device)
        links.append(int(out[0]) / CHAIN_LINKS)
    return tuple(links)


def phase_trace(rows, device):
    """Phase 2, continued: the device MiMC trace (`mimc_trace_kernel`, the
    counterpart of a lax.scan, no Pallas kernel). Over TRACE_CLAIMS claims
    at TRACE_CHECK_STEPS steps it equals its plain version (the kernel's
    row: device time, plain time and bound on these inputs). At every
    claim count of TRACE_SHAPE_CLAIMS and constant count of
    TRACE_SHAPE_CONSTS (inputs led by p - 1 and the structured values,
    constants led by p - 1) its first TRACE_CHECK_STEPS rows equal the
    plain version's and all GLOBAL_CHECK_STEPS rows the native host trace
    (the plain version takes about 12 ms a step). At the all-device
    proof's shape (one claim through BIG_STEPS steps) its first rows equal
    the plain version's and every row the native trace. The design it
    replaced (`starks_mimc_trace_canonical`, every intermediate
    canonical) runs the same traces (equal to the kernel's) and is timed
    beside it in turns, at one claim and at TRACE_CLAIMS claims x
    BIG_STEPS, and with GLOBAL_TRACE_CONSTS constants, in ns per
    dependent step; the kernel may be no slower. The chain floor: t_mul and t_add (chain_clocks) and 4 t_mul +
    10 t_add clocks a step at the card's maximum SM clock, beside the
    roofline bound. Then the path `models.mimc.trace_batch_device` of
    TRACE_CLAIMS claims at BIG_STEPS steps, counted alone, equals the
    native host trace of each claim. Adds the row; returns the path's
    launch counts."""
    import numpy as np
    import torch
    from starks_tpu_torch.models import mimc
    from starks_tpu_torch.ops import plimbs
    from starks_tpu_torch.utils.conversions import (ints_to_tensor,
                                                    tensor_to_ints)
    inps = list(range(TRACE_CLAIMS))
    x0, k = ints_to_tensor(inps, device), ints_to_tensor(CONSTS, device)

    def trace_bytes(claims, steps, n_k):  # inputs, constants, the trace
        return ELEM * (claims * (steps + 1) + n_k)

    def trace_ops(claims, steps):   # a cube (modmul + square) and an add
        return claims * (steps - 1) * (OPS_MUL + OPS_SQR + OPS_ADD)

    sms, mhz = card_clocks(device)
    ops_per_s = INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6

    def bound(claims, steps, n_k=len(CONSTS)):
        b_ms = trace_bytes(claims, steps, n_k) / HBM_BYTES_PER_S * 1e3
        o_ms = trace_ops(claims, steps) / ops_per_s * 1e3
        return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"

    args = (x0, k, TRACE_CHECK_STEPS)
    err = max_abs_err(plimbs.mimc_trace, plimbs.mimc_trace_plain, args)
    dev, per_call = kernel_times(lambda: plimbs.mimc_trace(*args), device)
    bound_ms, bound_by = bound(TRACE_CLAIMS, TRACE_CHECK_STEPS)
    row = {"name": "mimc_trace", "route": "cuda", "source": SRC,
           "replaces": REPLACES["mimc_trace"], "launches": 0,
           "max_abs_err": err, "ms": dev, "call_ms": per_call,
           "plain_ms": call_ms(lambda: plimbs.mimc_trace_plain(*args),
                               device, 1),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "l2": "warm", "shape": f"{TRACE_CLAIMS} claims x "
                                  f"{TRACE_CHECK_STEPS} steps"}
    rows["mimc_trace"] = row
    print(f"  mimc_trace {TRACE_CLAIMS} claims x {TRACE_CHECK_STEPS} steps: "
          f"equal to plain (max_abs_err {err}); device {dev:.6f} ms, "
          f"per-call {per_call:.6f} ms, plain {row['plain_ms']:.3f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by})", flush=True)

    # Claim and constant counts, led by x0 = p - 1 and a constant p - 1.
    gen = torch.Generator().manual_seed(SEED + 7)
    front = ints_to_tensor([MODULUS - 1] + structured_ints(), device)
    xs = with_edges(rand_elems(TRACE_CLAIMS, gen, device), front)
    kg = with_edges(rand_elems(GLOBAL_TRACE_CONSTS, gen, device), front)
    check(GLOBAL_TRACE_CONSTS > plimbs.SHARED_TRACE_CONSTS
          and plimbs.SHARED_TRACE_CONSTS + 1 in TRACE_SHAPE_CONSTS,
          "the checks cover both ways of reading the constants")
    xs_ints = tensor_to_ints(xs)
    for n_k in TRACE_SHAPE_CONSTS:
        kk = kg[:n_k]
        kk_ints = tensor_to_ints(kk)
        plain = plimbs.mimc_trace_plain(xs, kk, TRACE_CHECK_STEPS)
        native = np.stack([mimc.trace_limbs(x, GLOBAL_CHECK_STEPS, kk_ints)
                           for x in xs_ints])
        for claims in TRACE_SHAPE_CLAIMS:
            got = plimbs.mimc_trace(xs[:claims], kk, GLOBAL_CHECK_STEPS)
            head = got[:, :TRACE_CHECK_STEPS].to(torch.int64)
            err_s = int((head - plain[:claims].to(torch.int64)).abs().max())
            check(err_s == 0 and np.array_equal(got.cpu().numpy(),
                                                native[:claims]),
                  f"the trace of {claims} claims with {n_k} constants "
                  f"differs from the plain version or the native trace")
            row["max_abs_err"] = max(row["max_abs_err"], err_s)
    print(f"  mimc_trace at {TRACE_SHAPE_CLAIMS} claims x "
          f"{GLOBAL_CHECK_STEPS} steps with {TRACE_SHAPE_CONSTS} constants "
          f"(x0 and a constant p - 1): the first {TRACE_CHECK_STEPS} rows "
          f"equal to plain, every row to the native trace", flush=True)

    # The all-device proof's shape. The plain version takes a Python
    # step per row, so it checks the first rows; the native trace all.
    one = ints_to_tensor([INP], device)
    got = plimbs.mimc_trace(one, k, BIG_STEPS)
    check(torch.equal(got[:, :TRACE_CHECK_STEPS], plimbs.mimc_trace_plain(
        one, k, TRACE_CHECK_STEPS)) and np.array_equal(
        got[0].cpu().numpy(), mimc.trace_limbs(INP, BIG_STEPS, CONSTS)),
        f"the one-claim {BIG_STEPS}-step device trace differs from the "
        f"plain version or the native trace")
    t0 = time.perf_counter()
    mimc.trace_limbs(INP, BIG_STEPS, CONSTS)
    native_ms = (time.perf_counter() - t0) * 1e3

    # The replaced design beside the kept one, checked against it, timed
    # in turns (canonical, kept, kept, canonical).
    designs = {"canonical": trace_design("starks_mimc_trace_canonical"),
               "kept": plimbs.mimc_trace}
    for name, run in designs.items():
        check(torch.equal(run(one, k, BIG_STEPS), got),
              f"trace design {name} differs from the kept kernel")
    order = list(designs) + list(designs)[::-1]
    shapes = {"main_path": (one, k), "full": (x0, k),
              "device_memory_consts": (one, kg)}
    timed = {}
    for key, (xa, ka) in shapes.items():
        ms = {name: [] for name in designs}
        for name in order:
            ms[name].append(kernel_times(
                lambda: designs[name](xa, ka, BIG_STEPS), device,
                reps=TRACE_REPS)[0])
        timed[key] = {name: sum(v) / len(v) for name, v in ms.items()}
        check(timed[key]["kept"] <= timed[key]["canonical"],
              f"the trace kernel ({timed[key]['kept']:.3f} ms) is slower "
              f"than the design it replaced ({timed[key]['canonical']:.3f} "
              f"ms) at {key}")

    t_mul, t_add = chain_clocks(device)
    floor_clocks = 4 * t_mul + 10 * t_add
    floor_ms = (BIG_STEPS - 1) * floor_clocks / (mhz * 1e3)
    for key, (xa, ka) in shapes.items():
        claims, n_k = xa.shape[0], ka.shape[0]
        b_ms, b_by = bound(claims, BIG_STEPS, n_k)
        dev = timed[key]["kept"]
        entry = {"shape": f"{claims} claim(s) x {BIG_STEPS} steps, {n_k} "
                          f"constants", "ms": dev,
                 "ns_per_step": dev * 1e6 / (BIG_STEPS - 1),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "bound_share": b_ms / dev,
                 "chain_floor_ms": floor_ms,
                 "chain_floor_share": floor_ms / dev}
        entry["canonical_ms"] = timed[key]["canonical"]
        entry["canonical_ns_per_step"] = (timed[key]["canonical"] * 1e6
                                          / (BIG_STEPS - 1))
        row[key] = entry
        print(f"  mimc_trace {entry['shape']}: kept {dev:.3f} ms "
              f"({entry['ns_per_step']:.1f} ns per dependent step); "
              f"canonical {entry['canonical_ms']:.3f} ms "
              f"({entry['canonical_ns_per_step']:.1f} ns); bound "
              f"{b_ms:.6f} ms ({b_by}, {entry['bound_share']:.4%}); chain "
              f"floor {floor_ms:.3f} ms ({entry['chain_floor_share']:.2%})",
              flush=True)
    row["main_path"]["native_ms"] = native_ms
    row["chain_floor"] = {"t_mul_clocks": t_mul, "t_add_clocks": t_add,
                          "clocks_per_step": floor_clocks, "sm_mhz": mhz,
                          "links": CHAIN_LINKS}
    print(f"  chain floor: t_mul {t_mul:.3f} clocks (dependent IMAD.WIDE.U32"
          f"), t_add {t_add:.3f} clocks (dependent IADD3 with carry), "
          f"4 t_mul + 10 t_add = {floor_clocks:.3f} clocks a step at "
          f"{mhz:.0f} MHz (maximum SM clock, nvidia-smi): {floor_ms:.3f} ms "
          f"at 1 x {BIG_STEPS}; native host trace {native_ms:.3f} ms",
          flush=True)

    got, launches = counted(lambda: mimc.trace_batch_device(
        inps, BIG_STEPS, CONSTS, device))
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    native = np.stack([mimc.trace_limbs(x, BIG_STEPS, CONSTS) for x in inps])
    row["full"]["native_ms"] = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(got.cpu().numpy(), native),
          f"the device trace of {TRACE_CLAIMS} claims differs from the "
          f"native host trace")
    print(f"  {TRACE}: trace_batch_device equals the native trace of every "
          f"claim; native host trace of the same claims "
          f"{row['full']['native_ms']:.3f} ms (one thread)", flush=True)
    print_launches(launches)
    return launches


def phase_dif_designs(device):
    """Phase 2, continued: the DIF transform, scaled and not, for each
    stages-per-pass width 4-10 at 2^13 and 2^16 points (each equal to
    the plain stage chain, times the scale), then the transform followed
    by a scale launch against the scaled transform, in turns (old, new,
    new, old)."""
    import torch
    from starks_tpu_torch.ops import plimbs
    gen = torch.Generator().manual_seed(SEED + 1)
    edge = edge_elems(device)
    s = rand_elems(1, gen, device)[0]
    for n in (SMALL_STEPS, BIG_STEPS):
        logn = n.bit_length() - 1
        x = with_edges(rand_elems(n, gen, device), edge)
        tw = power_like(rand_elems(n, gen, device))
        want = plimbs.dif_transform_plain(x, tw)
        want_s = plimbs.dif_transform_plain(x, tw, s)
        chosen = plimbs.dif_pass_stages(n)
        for k in range(4, plimbs.DIF_PASS_MAX_STAGES + 1):
            check(torch.equal(plimbs.dif_transform(x, tw, k), want),
                  f"DIF transform, n = {n}, k = {k}, differs from plain")
            check(torch.equal(plimbs.dif_transform(x, tw, k, s), want_s),
                  f"scaled DIF transform, n = {n}, k = {k}, differs from "
                  f"plain")
            dev, per_call = kernel_times(
                lambda: plimbs.dif_transform(x, tw, k, s), device)
            mark = " (chosen)" if k == chosen else ""
            print(f"  DIF n = 2^{logn}, {k:2d} stages per pass "
                  f"({-(-logn // k)} launches){mark}, scaled: device "
                  f"{dev:.6f} ms, per-call {per_call:.6f} ms", flush=True)
        turns = []
        for label, fn in (
                ("old", lambda: plimbs.scale(plimbs.dif_transform(x, tw), s)),
                ("new", lambda: plimbs.dif_transform(x, tw, scale=s)),
                ("new", lambda: plimbs.dif_transform(x, tw, scale=s)),
                ("old", lambda: plimbs.scale(plimbs.dif_transform(x, tw), s))):
            dev, per_call = kernel_times(fn, device)
            turns.append(f"{label} {dev:.6f} / {per_call:.6f}")
        print(f"  DIF n = 2^{logn}, transform then scale against the scaled "
              f"transform, device / per-call ms: " + "; ".join(turns),
              flush=True)


def phase_dit_designs(device):
    """Phase 2, continued: the DIT transform at 2^16 and 2^19 points for
    each stages-per-pass width 4-10 (a short first pass where the width
    does not divide log n), on a general input and on compact
    coefficients (x at multiples of 8, as the LDE gives it), each equal
    to the plain stage chain."""
    import torch
    from starks_tpu_torch.ops import plimbs
    gen = torch.Generator().manual_seed(SEED + 2)
    sms, mhz = card_clocks(device)
    ops_per_s = INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6
    for n in (BIG_STEPS, BIG_STEPS * EXT):
        logn = n.bit_length() - 1
        x, tw = rand_elems(n, gen, device), rand_elems(n, gen, device)
        coeffs = rand_elems(n // EXT, gen, device)
        want = plimbs.dit_transform_plain(x, tw)
        want_c = plimbs.dit_transform_plain(coeffs, tw, EXT)
        chosen = plimbs.dif_pass_stages(n)
        bound, bound_c = (dit_ops(n, e) / ops_per_s * 1e3 for e in (1, EXT))
        print(f"  DIT n = 2^{logn}: bound {bound:.6f} ms (operations), "
              f"compact {bound_c:.6f} ms", flush=True)
        for k in range(4, plimbs.DIF_PASS_MAX_STAGES + 1):
            passes = -(-logn // k)
            first = logn - (passes - 1) * k
            check(torch.equal(plimbs.dit_transform(x, tw, k), want),
                  f"DIT transform, n = {n}, k = {k}, differs from plain")
            dev, per_call = kernel_times(
                lambda: plimbs.dit_transform(x, tw, k), device)
            mark = " (chosen)" if k == chosen else ""
            line = (f"  DIT n = 2^{logn}, {k:2d} stages per pass "
                    f"({passes} launches, first {first}){mark}: device "
                    f"{dev:.6f} ms, per-call {per_call:.6f} ms")
            if first >= EXT.bit_length() - 1:
                check(torch.equal(plimbs.dit_transform(coeffs, tw, k, EXT),
                                  want_c),
                      f"compact DIT transform, n = {n}, k = {k}, differs "
                      f"from plain")
                dev, per_call = kernel_times(
                    lambda: plimbs.dit_transform(coeffs, tw, k, EXT), device)
                line += (f"; compact: device {dev:.6f} ms, per-call "
                         f"{per_call:.6f} ms")
            print(line, flush=True)


def phase_stream_turns(device):
    """Phase 2, continued: the streaming kernels against what they
    replace, L2 flushed before each launch, in turns (old, new, new,
    old): scale then add against scale with an accumulator (2^19); mul
    by a constant [1, 8] operand, the 256-thread frame that scale had,
    against scale (2^16, 2^19). Then cube beside a torch copy of the
    same bytes (the card's streaming yardstick, never called by the
    port), each of these also under a flush that reads the L2 full
    (clean lines, where `zero_` leaves dirty lines that the next
    kernel's misses must write back) and with the inputs warm in L2 (no
    flush: what the arithmetic alone takes)."""
    import torch
    from starks_tpu_torch.ops import plimbs
    gen = torch.Generator().manual_seed(SEED + 3)
    big = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=device)
    dirty, clean = big.zero_, big.max
    s = rand_elems(1, gen, device)[0]

    def turns(what, old, new, flush=dirty):
        out = []
        for label, fn in (("old", old), ("new", new), ("new", new),
                          ("old", old)):
            dev, per_call = kernel_times(fn, device, flush)
            out.append(f"{label} {dev:.6f} / {per_call:.6f}")
        print(f"  {what}, device (L2 flushed) / per-call ms: "
              + "; ".join(out), flush=True)

    for n in (BIG_STEPS, BIG_STEPS * EXT):
        logn = n.bit_length() - 1
        x, acc = rand_elems(n, gen, device), rand_elems(n, gen, device)
        copy = torch.empty_like(x)
        if n == BIG_STEPS * EXT:
            turns(f"n = 2^{logn}, scale then add against scale(acc=)",
                  lambda: plimbs.add(acc, plimbs.scale(x, s)),
                  lambda: plimbs.scale(x, s, acc))
        turns(f"n = 2^{logn}, mul(x, s[None]) against scale",
              lambda: plimbs.mul(x, s[None]), lambda: plimbs.scale(x, s))
        for name, fn in (("copy", lambda: copy.copy_(x)),
                         ("cube", lambda: plimbs.cube(x)),
                         ("scale", lambda: plimbs.scale(x, s)),
                         ("scale(acc=)", lambda: plimbs.scale(x, s, acc)),
                         ("add", lambda: plimbs.add(acc, x))):
            times = [kernel_times(fn, device, f)[0]
                     for f in (dirty, clean, None)]
            print(f"  n = 2^{logn}, {name:<11s} device ms, L2 flushed "
                  f"dirty {times[0]:.6f}, clean {times[1]:.6f}, warm "
                  f"{times[2]:.6f}", flush=True)


def phase_build(build) -> str:
    """Phase 1: the card's name and power limit (returned), the kernel
    build, its register report and SASS counts."""
    card = card_line()
    print(f"  card: {card}", flush=True)
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{lib_path.name}", flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        kernel = re.search(r"Compiling entry function '(\w+)'", line)
        if kernel:
            print(f"    {kernel_label(kernel.group(1))}:", flush=True)
        elif "registers" in line or "spill" in line:
            print(f"      {line.strip()}", flush=True)
    print_sass_counts(lib_path, build)
    return card


def print_sass_counts(lib_path, build):
    """Each kernel's IMAD-class instructions (IMAD, IMAD.WIDE, IMAD.HI,
    their .X forms; the IMAD.MOV/SHL/IADD forms that only move or add
    counted apart) and all its instructions, from cuobjdump -sass, where
    the toolkit has cuobjdump."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("    cuobjdump not found: no SASS counts", flush=True)
        return
    res = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump: {res.stderr.strip()}")
    counts, kernel = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = kernel_label(m.group(1))
            counts[kernel] = [0, 0, 0]
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                       line)
        if kernel is None or not op:
            continue
        counts[kernel][2] += 1
        if op.group(1).startswith("IMAD"):
            moves = re.match(r"IMAD\.(MOV|SHL|IADD)", op.group(1))
            counts[kernel][1 if moves else 0] += 1
    for kernel, (imad, moves, total) in sorted(counts.items()):
        print(f"    SASS {kernel}: {imad} IMAD-class (+{moves} "
              f"IMAD.MOV/SHL/IADD), {total} instructions", flush=True)


def counted(run):
    """`run()` with every launch count set to 0 just before it: its result
    and the counts read just after."""
    from starks_tpu_torch.ops import plimbs
    plimbs.reset_launches()
    out = run()
    return out, dict(plimbs.LAUNCHES)


def print_launches(launches):
    print("  launches per proof: " + ", ".join(
        f"{k} {v}" for k, v in launches.items() if v), flush=True)


def phase_small_proof(steps, device):
    """Phase 3: byte equality with the spec oracle, and the verifier.
    Returns the oracle's proof."""
    from oracle import stark as ostark
    import starks_tpu_torch as stt
    t0 = time.perf_counter()
    got = stt.mk_mimc_proof(INP, steps, CONSTS, device=device)
    t1 = time.perf_counter()
    want = ostark.mk_mimc_proof(INP, steps, CONSTS)
    t2 = time.perf_counter()
    check(got == want, f"{steps}-step proof differs from the oracle's")
    out = stt.mimc_forward(INP, steps, CONSTS)
    check(stt.verify_mimc_proof(INP, steps, CONSTS, out, got),
          "verifier rejected the small proof")
    print(f"  {steps}-step proof equals the oracle's byte for byte "
          f"(port {t1 - t0:.3f} s incl. setup, oracle {t2 - t1:.3f} s); "
          f"verified", flush=True)
    return want


def prove_and_check(steps, device):
    """A first proof (with set-up), then a steady one, counted: it
    verifies and a flipped byte is rejected. Returns the steady proof,
    the first and steady stage times and the launch counts."""
    import starks_tpu_torch as stt
    first, steady = {}, {}
    stt.mk_mimc_proof(INP, steps, CONSTS, device=device, timings=first)
    proof, launches = counted(lambda: stt.mk_mimc_proof(
        INP, steps, CONSTS, device=device, timings=steady))
    out = stt.mimc_forward(INP, steps, CONSTS)
    t0 = time.perf_counter()
    check(stt.verify_mimc_proof(INP, steps, CONSTS, out, proof),
          f"verifier rejected the {steps}-step proof")
    verify_s = time.perf_counter() - t0
    bad = copy.deepcopy(proof)
    leaf = bytearray(bad[2][0][0])
    leaf[0] ^= 1
    bad[2][0][0] = bytes(leaf)
    expect_rejected(
        lambda q: stt.verify_mimc_proof(INP, steps, CONSTS, out, q), bad,
        "a tampered proof")
    print(f"  {steps}-step proof verified in {verify_s:.3f} s; tampered "
          f"proof rejected", flush=True)
    print_launches(launches)
    print_stages(first, steady)
    return proof, first, steady, launches


def phase_big_proof(steps, device):
    """Phase 4: a large proof verifies; a flipped byte is rejected.
    Returns the proof, the steady proof's wall time and launch counts."""
    proof, _, steady, launches = prove_and_check(steps, device)
    return proof, steady["total"], launches


def print_stages(first, steady, setup_s=None):
    if setup_s is None:
        print(f"  first call (with setup): total {first['total']:.4f} s",
              flush=True)
    else:
        print(f"  set-up {setup_s:.4f} s, then first call "
              f"{first['total']:.4f} s: {setup_s + first['total']:.4f} s "
              f"with set-up", flush=True)
    for stage, sec in steady.items():
        print(f"    {stage:<32s} {sec * 1e3:10.3f} ms", flush=True)


def expect_rejected(verify, proof, what):
    import starks_tpu_torch as stt
    try:
        verify(proof)
    except stt.VerificationError:
        return
    check(False, f"verifier accepted {what}")


def phase_air(device):
    """Phase 5: general AIR proofs through prove_air and verify_air.
    Returns the steady fib-square wall times by steps, the launch counts
    of each counted path and the BIG_STEPS fib-square proof."""
    import starks_tpu_torch as stt
    from starks_tpu_torch.air import _FusedAIRSetup
    from starks_tpu_torch.models import fib_square as fib
    from starks_tpu_torch.models.mimc import mimc_air, mimc_forward
    air = fib.fib_square_air()

    def setup(air_, steps, path):
        su, seconds, launches[path + SETUP] = setup_timed(
            lambda: _FusedAIRSetup.get(air_, steps, stt.REFERENCE, device),
            device)
        check(launches[path + SETUP]["batch_inv"] == len(su.b_regs),
              f"{path} set-up: {launches[path + SETUP]['batch_inv']} "
              f"batch_inv launches, {len(su.b_regs)} bounded registers")
        print_setup(path, seconds, launches[path + SETUP])
        return seconds

    t0 = time.perf_counter()
    got = stt.prove_air(air, [1, 1], AIR_CHECK_STEPS, device=device)
    t1 = time.perf_counter()
    want = stt.prove_air(air, [1, 1], AIR_CHECK_STEPS, device="cpu")
    t2 = time.perf_counter()
    check(got == want, f"fib-square {AIR_CHECK_STEPS}-step proof on the "
          f"card differs from the CPU path's")
    print(f"  fib-square {AIR_CHECK_STEPS}-step proof on the card equals "
          f"the CPU path's byte for byte (card {t1 - t0:.3f} s incl. "
          f"setup, CPU {t2 - t1:.3f} s)", flush=True)

    proofs, steady_s, launches = {}, {}, {}
    for path, steps in ((FIB, SMALL_STEPS), (FIB_BIG, BIG_STEPS)):
        setup_s = setup(air, steps, path)
        first, steady = {}, {}
        stt.prove_air(air, [1, 1], steps, device=device, timings=first)
        proof, launches[path] = counted(lambda: stt.prove_air(
            air, [1, 1], steps, device=device, timings=steady))
        t0 = time.perf_counter()
        check(stt.verify_air(air, steps, proof),
              f"verifier rejected the fib-square {steps}-step proof")
        verify_s = time.perf_counter() - t0
        check(dict(proof[5])[(steps - 1, 1)]
              == fib.fib_square_output(1, 1, steps),
              "fib-square output boundary differs from fib_square_output")
        bad = copy.deepcopy(proof)
        bad[5] = [(k, (v + 1) % fib.MODULUS) if k == (steps - 1, 1)
                  else (k, v) for k, v in bad[5]]
        expect_rejected(lambda q: stt.verify_air(air, steps, q), bad,
                        "a changed output boundary value")
        bad = copy.deepcopy(proof)
        leaf = bytearray(bad[2][0][0])
        leaf[0] ^= 1
        bad[2][0][0] = bytes(leaf)
        expect_rejected(lambda q: stt.verify_air(air, steps, q), bad,
                        "a flipped leaf byte")
        print(f"  fib-square {steps}-step proof verified in {verify_s:.3f} "
              f"s, output equals fib_square_output; changed boundary and "
              f"flipped leaf byte rejected", flush=True)
        print_launches(launches[path])
        print_stages(first, steady, setup_s)
        steady_s[steps] = steady["total"]
        proofs[steps] = proof

    d_proof = stt.prove_air(fib.fib_square_air_declarative(), [1, 1],
                            SMALL_STEPS, device=device)
    check(d_proof == proofs[SMALL_STEPS],
          "the declarative fib-square proof differs from the closure form's")
    print(f"  declarative fib-square {SMALL_STEPS}-step proof equals the "
          f"closure form's byte for byte", flush=True)

    m_air = mimc_air(AIR_CONSTS)
    setup(m_air, SMALL_STEPS, MIMC_AIR)
    t0 = time.perf_counter()
    proof, launches[MIMC_AIR] = counted(lambda: stt.prove_air(
        m_air, [INP], SMALL_STEPS, device=device))
    t1 = time.perf_counter()
    check(stt.verify_air(m_air, SMALL_STEPS, proof),
          "verifier rejected the MiMC-as-AIR proof")
    check(dict(proof[5])[(SMALL_STEPS - 1, 0)]
          == mimc_forward(INP, SMALL_STEPS, AIR_CONSTS),
          "MiMC-as-AIR output boundary differs from mimc_forward")
    print(f"  MiMC as an AIR, {SMALL_STEPS} steps: verified, output equals "
          f"mimc_forward ({t1 - t0:.3f} s, first call after its set-up)",
          flush=True)
    print_launches(launches[MIMC_AIR])
    return steady_s, launches, proofs[BIG_STEPS]


class Spy:
    """Within a `with` block, module.name counts its calls and sums their
    wall time (seconds), and then calls the original."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls, self.seconds = 0, 0.0

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def spied(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.calls += 1
                self.seconds += time.perf_counter() - t0
        setattr(self.module, self.name, spied)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def phase_batch(device, small_oracle):
    """Phase 6: batch proving, BASELINE.md config 5 on one card. Returns the
    steady wall time of one chunk and its launch counts.

    `prove_batch` of BATCH_CLAIMS claims at 2^16 steps (inputs 0..63),
    chunks of BATCH_CHUNK, verify=True: every claim through the bulk
    claim-axis prover and none through the per-claim route, so all are
    accepted as they came; claims 0 and 63 (first and last chunk) equal
    the serial `mk_mimc_proof`; a resumed run loads all from the store;
    a 2^13 batch claim equals the oracle; serialize -> deserialize
    gives the proofs back; a flipped byte is rejected. Prints proofs/s
    and wall time per chunk, proofs/s at chunk 1, 4 and 16 on one
    chunk's claims, peak device memory, proof sizes and the host trace
    time per claim (native and plain)."""
    import tempfile
    import torch
    import starks_tpu_torch as stt
    from starks_tpu_torch import prover
    from starks_tpu_torch.models import mimc
    from starks_tpu_torch.utils.artifacts import ProofStore
    inps = list(range(BATCH_CLAIMS))
    chunk_inps = inps[:BATCH_CHUNK]

    def bulk(claims, chunk, steps=BIG_STEPS):
        return stt.mk_mimc_proof_batch_fused(claims, steps, CONSTS,
                                             chunk=chunk, device=device)

    # One chunk alone, counted (its first call also warms the allocator
    # and the pinned host buffers).
    t0 = time.perf_counter()
    _, launches = counted(lambda: bulk(chunk_inps, BATCH_CHUNK))
    print(f"  one chunk of {BATCH_CHUNK} claims, counted alone (first "
          f"call): {time.perf_counter() - t0:.3f} s", flush=True)
    print_launches(launches)

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as root:
        store = ProofStore(root)
        with Spy(prover, "mk_mimc_proof_batch_fused") as bulk_spy, \
                Spy(prover, "mk_mimc_proof_with_trace") as one_spy:
            t0 = time.perf_counter()
            proofs = stt.prove_batch(inps, BIG_STEPS, CONSTS, store=store,
                                     verify=True, chunk=BATCH_CHUNK,
                                     device=device)
            total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        check(len(proofs) == BATCH_CLAIMS and bulk_spy.calls == 1
              and one_spy.calls == 0,
              f"prove_batch: {len(proofs)} proofs, {one_spy.calls} claims "
              f"through the per-claim route")
        chunks = -(-BATCH_CLAIMS // BATCH_CHUNK)
        print(f"  prove_batch of {BATCH_CLAIMS} claims at {BIG_STEPS} steps, "
              f"chunk {BATCH_CHUNK}, verify=True: all {BATCH_CLAIMS} "
              f"accepted, none retried; bulk prover {bulk_spy.seconds:.3f} "
              f"s = {BATCH_CLAIMS / bulk_spy.seconds:.4f} proofs/s, "
              f"{bulk_spy.seconds / chunks:.3f} s per chunk of "
              f"{BATCH_CHUNK} ({chunks} chunks, pipelined); with self-"
              f"verification and the store {total_s:.3f} s = "
              f"{BATCH_CLAIMS / total_s:.4f} proofs/s; peak device memory "
              f"{peak / 2 ** 30:.3f} GiB", flush=True)
        with Spy(prover, "mk_mimc_proof_batch_fused") as bulk_spy:
            t0 = time.perf_counter()
            resumed = stt.prove_batch(inps, BIG_STEPS, CONSTS, store=store,
                                      device=device)
            resume_s = time.perf_counter() - t0
        check(resumed == proofs and bulk_spy.calls == 0,
              "a resumed prove_batch did not load every claim from the "
              "store")
        print(f"  resumed prove_batch loaded all {BATCH_CLAIMS} claims from "
              f"the store in {resume_s:.3f} s, proving none", flush=True)

    per_chunk = {}
    for chunk in (BATCH_CHUNK, 4, 1):
        t0 = time.perf_counter()
        got = bulk(chunk_inps, chunk)
        per_chunk[chunk] = time.perf_counter() - t0
        check(got == proofs[:BATCH_CHUNK],
              f"chunk {chunk} gives other proofs than chunk {BATCH_CHUNK}")
    print(f"  {BATCH_CHUNK} claims at chunk 16 / 4 / 1: " + " / ".join(
        f"{BATCH_CHUNK / per_chunk[c]:.4f}" for c in (BATCH_CHUNK, 4, 1))
        + " proofs/s (" + " / ".join(f"{per_chunk[c]:.3f}" for c in
                                     (BATCH_CHUNK, 4, 1)) + " s); equal "
        "proofs", flush=True)

    for c in (0, BATCH_CLAIMS - 1):
        check(proofs[c] == stt.mk_mimc_proof(inps[c], BIG_STEPS, CONSTS,
                                             device=device),
              f"batch claim {c} differs from the serial proof")
    small = bulk([INP, 1, 2], 2, SMALL_STEPS)
    check(small[0] == small_oracle,
          f"the {SMALL_STEPS}-step batch claim differs from the oracle's")
    check(all(stt.verify_mimc_proof(x, SMALL_STEPS, CONSTS,
                                    stt.mimc_forward(x, SMALL_STEPS, CONSTS),
                                    q) for x, q in zip([INP, 1, 2], small)),
          f"verifier rejected a {SMALL_STEPS}-step batch proof")
    print(f"  claims 0 and {BATCH_CLAIMS - 1} (chunks 1 and {chunks}) equal "
          f"the serial mk_mimc_proof byte for byte; a {SMALL_STEPS}-step "
          f"batch claim (chunk 2 of 3 claims) equals the oracle's",
          flush=True)

    for q in (proofs[0], proofs[-1], small[0]):
        check(stt.deserialize_proof(stt.serialize_proof(q)) == q,
              "serialize -> deserialize did not give the proof back")
    print(f"  serialize -> deserialize gives claims 0, {BATCH_CLAIMS - 1} and "
          f"the {SMALL_STEPS}-step claim back; one {BIG_STEPS}-step proof: "
          f"bin_length {stt.bin_length(proofs[0])} B, raw_length "
          f"{stt.raw_length(proofs[0])} B", flush=True)
    bad = copy.deepcopy(proofs[5])
    leaf = bytearray(bad[2][0][0])
    leaf[0] ^= 1
    bad[2][0][0] = bytes(leaf)
    expect_rejected(lambda q: stt.verify_mimc_proof(
        5, BIG_STEPS, CONSTS, stt.mimc_forward(5, BIG_STEPS, CONSTS), q),
        bad, "a flipped byte in batch claim 5")
    print("  a flipped byte in batch claim 5 is rejected", flush=True)

    reps = 5
    t0 = time.perf_counter()
    for x in range(reps):
        mimc.trace_limbs(x, BIG_STEPS, CONSTS)
    native_ms = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    mimc.trace_host(0, BIG_STEPS, CONSTS)
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"  host trace per claim at {BIG_STEPS} steps: native "
          f"{native_ms:.3f} ms (mean of {reps}), plain bigints {plain_ms:.3f} "
          f"ms (one)", flush=True)
    return per_chunk[BATCH_CHUNK], launches, proofs


def phase_batch_ranks(proofs, launches):
    """Phase 12: config 5 over ranks. DP_RANKS ranks (parallel.launch.run;
    one card: they share it, over gloo) each prove_batch their slice of
    claims 0 .. DP_CLAIMS - 1 at BIG_STEPS steps in one chunk of
    DP_CHUNK, verified (`parallel.launch.batch_rank`); the proofs,
    gathered on rank 0 as wire bytes, equal phase 6's `proofs` of the
    same inputs. Prints each rank's figures and the aggregate, and puts
    rank 0's launches into `launches` (each rank's counted alone, from
    just before its steady prove_batch to just after)."""
    import torch
    from starks_tpu_torch.parallel import launch
    check(launch.batch_consts(BIG_STEPS) == CONSTS,
          "launch batch's round constants are not this script's")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = launch.run(launch.batch_rank, DP_RANKS, BIG_STEPS, DP_CLAIMS,
                     DP_CHUNK, "cuda", device="cuda",
                     timeout=DP_TIMEOUT_S)[0]
    wall = time.perf_counter() - t0
    check(out["proofs"] == proofs[:DP_CLAIMS],
          f"a proof gathered from {DP_RANKS} ranks differs from phase 6's")
    ranks = out["ranks"]
    for rank, r in enumerate(ranks):
        check(r["n"] == DP_CLAIMS // DP_RANKS and r["alone"] == 0,
              f"rank {rank} proved {r['n']} claims, {r['alone']} alone")
        check(r["launches"] == ranks[0]["launches"],
              f"rank {rank} launches {r['launches']}, rank 0 "
              f"{ranks[0]['launches']}")
    print(f"  {DP_RANKS} ranks ({out['transport']}) on "
          f"{sorted({r['device'] for r in ranks})}; the {DP_CLAIMS} proofs "
          f"gathered on rank 0 as wire bytes equal phase 6's byte for byte "
          f"({wall:.1f} s for the whole launch, start-up included); "
          f"{DP_RANKS} ranks share one card: correctness, not scaling",
          flush=True)
    launch.print_batch(out, BIG_STEPS, DP_CLAIMS, "one card")
    launches[BATCH_DP] = ranks[0]["launches"]


def phase_air_batch(device, fib_proof16, launches):
    """Phase 10: general AIR proofs over a claim axis
    (`prove_air_batch_fused`). AIR_CHUNK fib-square claims at BIG_STEPS
    steps in one chunk, counted alone: every claim accepted by
    `verify_air` with the output of fib_square_output, claim 0 equal to
    phase 5's serial proof and the last claim to its serial `prove_air`,
    byte for byte, a changed boundary value rejected; stage times and
    peak device memory; proofs/s at chunks of AIR_CHUNK, 4 and 1 (chunk 1
    on 4 claims; equal proofs); the host trace (`air.trace`, Python
    ints) per claim. Then
    MiMC as an AIR over MIMC_AIR_CLAIMS claims at SMALL_STEPS, each equal
    to its serial proof. Returns the chunk's stage-timed wall time and
    launch counts."""
    import torch
    import starks_tpu_torch as stt
    from starks_tpu_torch.models import fib_square as fib
    from starks_tpu_torch.models.mimc import mimc_air, mimc_forward
    air = fib.fib_square_air()
    claims = [[i + 1, 2 * i + 1] for i in range(AIR_CHUNK)]   # 0: [1, 1]

    def chunk_of_all(timings=None):
        return stt.prove_air_batch_fused(air, claims, BIG_STEPS,
                                         chunk=AIR_CHUNK, device=device,
                                         timings=timings)

    t0 = time.perf_counter()
    chunk_of_all()
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    steady = {}
    proofs, launches = counted(lambda: chunk_of_all(steady))
    peak = torch.cuda.max_memory_allocated(device)
    t0 = time.perf_counter()
    for (a, b), proof in zip(claims, proofs):
        check(stt.verify_air(air, BIG_STEPS, proof),
              f"verifier rejected AIR batch claim {[a, b]}")
        check(dict(proof[5])[(BIG_STEPS - 1, 1)]
              == fib.fib_square_output(a, b, BIG_STEPS),
              f"AIR batch claim {[a, b]}: output boundary differs")
    verify_s = time.perf_counter() - t0
    last = AIR_CHUNK - 1
    check(proofs[0] == fib_proof16,
          "AIR batch claim 0 differs from the serial fib-square proof")
    check(proofs[last] == stt.prove_air(air, claims[last], BIG_STEPS,
                                        device=device),
          f"AIR batch claim {last} differs from its serial prove_air")
    bad = copy.deepcopy(proofs[last])
    bad[5] = [(k, (v + 1) % fib.MODULUS) if k == (0, 0) else (k, v)
              for k, v in bad[5]]
    expect_rejected(lambda q: stt.verify_air(air, BIG_STEPS, q), bad,
                    "a changed boundary value in an AIR batch claim")
    print(f"  {AIR_BATCH}, counted alone: all {AIR_CHUNK} verified "
          f"({verify_s:.3f} s) with the outputs of fib_square_output; claims "
          f"0 and {last} equal the serial prove_air byte for byte; a changed "
          f"boundary value rejected; first call {first_s:.3f} s on phase 5's "
          f"cached set-up; peak device "
          f"memory {peak / 2 ** 30:.3f} GiB", flush=True)
    print_launches(launches)
    for stage, sec in steady.items():
        print(f"    {stage:<32s} {sec * 1e3:10.3f} ms", flush=True)

    # Chunk 1 proves the first 4 claims only: one at a time, they take
    # as long as the rest of the phase.
    rates = {}
    for chunk, count in ((AIR_CHUNK, AIR_CHUNK), (4, AIR_CHUNK), (1, 4)):
        t0 = time.perf_counter()
        got = stt.prove_air_batch_fused(air, claims[:count], BIG_STEPS,
                                        chunk=chunk, device=device)
        rates[chunk] = count / (time.perf_counter() - t0)
        check(got == proofs[:count],
              f"AIR chunk {chunk} gives other proofs than chunk {AIR_CHUNK}")
    print(f"  fib-square claims at chunk {AIR_CHUNK} / 4 / 1 ({AIR_CHUNK} / "
          f"{AIR_CHUNK} / 4 claims): " + " / ".join(
              f"{rates[c]:.4f}" for c in (AIR_CHUNK, 4, 1))
          + " proofs/s; equal proofs", flush=True)
    t0 = time.perf_counter()
    air.trace(claims[0], BIG_STEPS)
    print(f"  host trace (air.trace, Python ints) per claim at {BIG_STEPS} "
          f"steps: {(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)

    m_air = mimc_air(AIR_CONSTS)
    inps = [[INP + i] for i in range(MIMC_AIR_CLAIMS)]
    t0 = time.perf_counter()
    got = stt.prove_air_batch_fused(m_air, inps, SMALL_STEPS, device=device)
    batch_s = time.perf_counter() - t0
    for (x,), proof in zip(inps, got):
        check(proof == stt.prove_air(m_air, [x], SMALL_STEPS, device=device),
              f"MiMC-as-AIR batch claim {x} differs from its serial proof")
        check(stt.verify_air(m_air, SMALL_STEPS, proof)
              and dict(proof[5])[(SMALL_STEPS - 1, 0)]
              == mimc_forward(x, SMALL_STEPS, AIR_CONSTS),
              f"MiMC-as-AIR batch claim {x} rejected or wrong output")
    print(f"  MiMC as an AIR, {MIMC_AIR_CLAIMS} claims at {SMALL_STEPS} steps "
          f"in one chunk ({batch_s:.3f} s): each equals its serial proof, "
          f"verified, output of mimc_forward", flush=True)
    return steady["total"], launches


def config4_cases(device):
    """(name, shape, wrapper, plain, args, bytes, ops, warm) for each
    kernel at the shapes config 4 gives it: on one card the inverse DIF
    transform of the 2^20-step trace with 1/n, the DIT transform of its
    compact coefficients to 2^23 points (three passes), the D/B and L
    maps at 2^23 and fold4 at every FRI round from 2^23; over SHARDS
    shards (per rank) the four-step transforms' local DIF batches, the
    twiddle product, the D/B map of a shard with its halo, and round 0's
    fold of a shard's quarter slices."""
    import torch
    from starks_tpu_torch.ops import plimbs
    gen = torch.Generator().manual_seed(SEED + 9)
    steps, s = CONFIG4_STEPS, SHARDS
    n = steps * EXT
    edge = edge_elems(device)

    def arr(m, front=edge):
        return with_edges(rand_elems(m, gen, device), front)

    def one():
        return rand_elems(1, gen, device)[0]

    def dif_plain(x, tw, k=None, sc=None):
        return plimbs.dif_transform_plain(x, tw, sc)

    def dit_plain(x, tw, k=None, ext=1):
        return plimbs.dit_transform_plain(x, tw, ext)

    def db_bytes(m):
        return ELEM * (5 * m + EXT * len(CONSTS) + EXT + 3)

    db_ops = 5 * OPS_MUL + OPS_SQR + 5 * OPS_ADD
    p, xs, iz2, d, b = (arr(n) for _ in range(5))
    k_tab, zni, cp, cb = arr(EXT * len(CONSTS)), arr(EXT), arr(EXT), arr(EXT)
    last, slope, ia, sx, eta, sc = (one() for _ in range(6))
    cases = [
        ("dif_pass", "2^20 with 1/n", plimbs.dif_transform, dif_plain,
         (arr(steps), power_like(arr(steps)), None, sc),
         ELEM * (2 * steps + steps // 2), dif_ops(steps), True),
        ("dit_pass", "2^20 compact -> 2^23, 3 passes", plimbs.dit_transform,
         dit_plain, (arr(steps), arr(n), None, EXT),
         ELEM * (steps + n + n // 2), dit_ops(n, EXT), True),
        ("db_map", "2^23", plimbs.db_map, plimbs.db_map_plain,
         (p, xs, k_tab, zni, iz2, last, slope, ia, EXT), db_bytes(n),
         n * db_ops, False),
        ("l_map", "2^23", plimbs.l_map, plimbs.l_map_plain, (d, p, b, cp, cb),
         ELEM * (4 * n + 2 * EXT), n * (2 * OPS_MUL + 2 * OPS_ADD), False),
    ]
    ip = arr(n // 4)
    n_r, r = n, 0
    while n_r // 4 >= 2 ** 5:
        q = n_r // 4
        cases.append(("fold4", f"round {r}: 2^{n_r.bit_length() - 1} -> "
                      f"2^{q.bit_length() - 1}", plimbs.fold4,
                      plimbs.fold4_plain, (arr(n_r), ip, sx, eta, 2 * r),
                      ELEM * (n_r + 2 * q + 2),
                      q * (5 * OPS_MUL + 13 * OPS_ADD), True))
        n_r, r = q, r + 1
    check(r == 9, f"{r} FRI rounds at 2^23 points, expected 9")
    # Per rank of the sharded proof: the four-step splits of the trace
    # (2^10 x 2^10) and of the domain (2^11 x 2^12), each a batch of the
    # local columns or rows.
    for size, rows, scaled in ((2 ** 10, 2 ** 10 // s, True),
                               (2 ** 11, 2 ** 12 // s, False),
                               (2 ** 12, 2 ** 11 // s, False)):
        x = torch.stack([arr(size) for _ in range(rows)])
        cases.append(("dif_pass", f"four-step local: {rows} x 2^"
                      f"{size.bit_length() - 1}"
                      + (" with 1/n" if scaled else ""),
                      plimbs.dif_transform, dif_plain,
                      (x, power_like(arr(size)), None, sc if scaled else None),
                      ELEM * (2 * rows * size + size // 2),
                      rows * dif_ops(size, scaled), True))
    m = n // s
    cases.append(("mul", "four-step twiddle, 2^21 per rank", plimbs.mul,
                  plimbs.mul_plain, (arr(m), arr(m)), ELEM * 3 * m,
                  m * OPS_MUL, False))
    halo = arr(EXT)
    cases.append(("db_map", "a shard of 2^21 with its halo", plimbs.db_map,
                  plimbs.db_map_plain,
                  (p[:m], xs[:m], k_tab, zni, iz2[:m], last, slope, ia, EXT,
                   halo), db_bytes(m) + ELEM * EXT, m * db_ops, False))
    q_loc = n // 4 // s
    cases.append(("fold4", "round 0 of a shard: 4 x 2^19 quarter slices",
                  plimbs.fold4, plimbs.fold4_plain,
                  (arr(4 * q_loc), ip[q_loc:2 * q_loc], sx, eta, 0),
                  ELEM * (6 * q_loc + 2), q_loc * (5 * OPS_MUL + 13 * OPS_ADD),
                  True))
    return cases


def phase_config4_kernels(rows, device):
    """Phase 9, first part: each kernel at config 4's shapes equals its
    plain version exactly; its device time per launch beside its bound
    goes into its row's `config4` list. Then the forward NTT's points/s
    at 2^20 (the DIF transform, BASELINE.md:259)."""
    import torch
    from starks_tpu_torch.ops import plimbs
    sms, mhz = card_clocks(device)
    ops_per_s = INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=device).zero_
    for name, shape, wrapper, plain, args, nbytes, ops, warm in \
            config4_cases(device):
        err = max_abs_err(wrapper, plain, args)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        plain(*args)
        torch.cuda.synchronize(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        dev, per_call = kernel_times(lambda: wrapper(*args), device,
                                     None if warm else flush)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        entry = {"shape": shape, "max_abs_err": err, "ms": dev,
                 "call_ms": per_call, "plain_ms": plain_ms,
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "l2": "warm" if warm else "flushed"}
        rows[name].setdefault("config4", []).append(entry)
        print(f"  {name:<9s} {shape}: equal to plain (max_abs_err {err}); "
              f"device {dev:.6f} ms, per-call {per_call:.6f} ms, plain "
              f"{plain_ms:.3f} ms (one call), bound {entry['bound_ms']:.6f}"
              f" ms ({entry['bound_by']}, {entry['bound_ms'] / dev:.1%}), "
              f"L2 {entry['l2']}", flush=True)
        del args
    gen = torch.Generator().manual_seed(SEED + 10)
    n = CONFIG4_STEPS
    x, tw = rand_elems(n, gen, device), power_like(rand_elems(n, gen, device))
    dev, _ = kernel_times(lambda: plimbs.dif_transform(x, tw), device)
    print(f"  NTT at 2^20 points (forward DIF transform, "
          f"{-(-20 // plimbs.dif_pass_stages(n))} passes): device {dev:.6f} "
          f"ms, {n / dev * 1e3:.4e} points/s", flush=True)


def shard_rank(rank, steps):
    """One rank of a sharded proof on the card(s) (run by parallel.launch):
    a first proof with set-up, then a steady one, counted and with each
    collective timed. Returns what the parent checks and prints."""
    import torch
    import starks_tpu_torch as stt
    from starks_tpu_torch import prover
    from starks_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh()
    split = {}
    t0 = time.perf_counter()
    _, setup_launches = counted(lambda: prover._ShardedSetup.get(
        steps, stt.REFERENCE, mesh, timings=split))
    stt.mk_mimc_proof(INP, steps, CONSTS, mesh=mesh)
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(mesh.device)
    mesh.reset_counts()
    mesh.timed = True
    steady = {}
    proof, launches = counted(lambda: stt.mk_mimc_proof(
        INP, steps, CONSTS, mesh=mesh, timings=steady))
    return {"proof": proof, "first_s": first_s, "steady": steady,
            "launches": launches, "setup_launches": setup_launches,
            "setup_split": split,
            "counts": mesh.counts,
            "bytes": mesh.bytes, "seconds": mesh.seconds,
            "transport": mesh.transport, "device": str(mesh.device),
            "peak": torch.cuda.max_memory_allocated(mesh.device)}


def dif_passes(n) -> int:
    from starks_tpu_torch.ops import plimbs
    return -(-(n.bit_length() - 1) // plimbs.dif_pass_stages(n))


def phase_sharded(steps, want, launches):
    """Phase 9, sharded: SHARDS ranks, one row, each on cuda:(rank %
    device_count) (gloo through pinned host memory when ranks share a
    card, NCCL when each has its own), prove `steps`; every rank's proof
    equals `want` (the single-card proof) byte for byte. Prints each
    rank's stage times, collectives (count, bytes sent to other ranks,
    seconds) and launches, and puts rank 0's launches into `launches`."""
    import collections
    import torch
    from starks_tpu_torch.ops import fused
    from starks_tpu_torch.parallel import launch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = launch.run(shard_rank, SHARDS, steps, device="cuda",
                         timeout=SHARD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(all(r["proof"] == want for r in results),
          f"a {SHARDS}-rank {steps}-step proof differs from the single-card "
          f"proof")
    cards = collections.Counter(r["device"] for r in results)
    print(f"  {SHARDS} ranks ({launch.backend_for(SHARDS, 'cuda')}; "
          f"transport: {results[0]['transport']}); ranks per card: "
          + ", ".join(f"{dev} {k}" for dev, k in sorted(cards.items()))
          + f"; every rank's {steps}-step proof equals the single-card proof "
          f"byte for byte ({wall:.1f} s for the whole launch, start-up "
          f"included)", flush=True)
    rounds = len(fused.fri_round_schedule(steps * EXT, steps * 2, 16))
    n1_trace = 1 << ((steps.bit_length() - 1) // 2)
    n1_lde = 1 << (((steps * EXT).bit_length() - 1) // 2)
    want_dif = (dif_passes(n1_trace) + dif_passes(steps // n1_trace)
                + dif_passes(n1_lde) + dif_passes(steps * EXT // n1_lde))
    for rank, r in enumerate(results):
        a2a = r["counts"]["all_to_all_single"]
        check(a2a == 2 * 3 + 1 + rounds,
              f"rank {rank}: {a2a} all_to_all_single, expected 3 per "
              f"four-step transform (2), 1 for the padding and {rounds} for "
              f"the FRI rounds")
        check(r["launches"]["dif_pass"] == want_dif
              and r["launches"]["mul"] == 2
              and r["launches"]["dit_pass"] == 0
              and r["launches"]["fold4"] == rounds,
              f"rank {rank}: launches {r['launches']}")
        setup = {k: v for k, v in r["setup_launches"].items() if v}
        check(setup == {"sub": 2, "mul": 1, "batch_inv": 1},
              f"rank {rank}: its set-up launched {setup}, expected its 1/Z2 "
              f"on the card (sub 2, mul 1, batch_inv 1)")
        if rank == 0:
            print_setup_split(f"MiMC {steps} set-up, rank 0 of {SHARDS}",
                              r["setup_split"])
        print(f"  rank {rank} on {r['device']}: first call (with set-up, "
              f"its 1/Z2 rows on the card) {r['first_s']:.3f} s, peak memory "
              f"{r['peak'] / 2 ** 30:.3f} GiB; steady stages (ms): "
              + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in
                          r["steady"].items()), flush=True)
        print(f"    collectives (count, MB to other ranks, s): " + ", ".join(
            f"{k} {r['counts'][k]} / {r['bytes'][k] / 1e6:.3f} / "
            f"{r['seconds'][k]:.4f}" for k in r["counts"]), flush=True)
        print(f"    launches: " + ", ".join(
            f"{k} {v}" for k, v in r["launches"].items() if v), flush=True)
    launches[SHARDED.format(steps)] = results[0]["launches"]


def phase_config4(rows, device, proof16, launches):
    """Phase 9: benchmark config 4 (BASELINE.md:267), 2^20 steps, a 2^23-
    point domain: the kernels at its shapes; on one card a first proof
    (with set-up, which must build no table from Python ints per point)
    and a steady one, verified, with a flipped byte rejected, its peak
    memory and size; then sharded over SHARDS ranks at 2^16 steps
    (equal to phase 4's proof) and at 2^20 (equal to the one-card
    proof). Returns the one-card steady proof's wall time and the
    proof."""
    import torch
    import starks_tpu_torch as stt
    from starks_tpu_torch import prover
    from starks_tpu_torch.utils import native
    phase_config4_kernels(rows, device)
    torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    split = {}
    su, setup_s, launches[MIMC4 + SETUP] = setup_timed(
        lambda: prover._FusedSetup.get(CONFIG4_STEPS, stt.REFERENCE, device,
                                       timings=split), device)
    want = {"sub": 2, "mul": 1, "batch_inv": 1}
    got = {k: v for k, v in launches[MIMC4 + SETUP].items() if v}
    check(got == want, f"{MIMC4} set-up launches {got}, expected {want}")
    check(split.get("batch inverse") is not None,
          f"{MIMC4} set-up: no stage times (set-up already built?)")
    print_setup(MIMC4, setup_s, launches[MIMC4 + SETUP])
    print_setup_split(f"{MIMC4} set-up, one card", split)
    last = pow(su.G2, (CONFIG4_STEPS - 1) * EXT, MODULUS)
    t0 = time.perf_counter()
    host = native.inv_vanishing2(su.plan.xs_big.cpu().numpy(), 1, last)
    host_s = time.perf_counter() - t0
    check(su.inv_z2.cpu().numpy().tobytes() == host.tobytes(),
          f"{MIMC4} set-up: 1/Z2 differs from native.inv_vanishing2's")
    print(f"  {MIMC4} set-up: 1/Z2 over {CONFIG4_STEPS * EXT} points equals "
          f"the native runtime's (native.inv_vanishing2 {host_s:.3f} s on "
          f"the host, with the table's copy)", flush=True)
    proof, first, steady, launches[MIMC4] = prove_and_check(CONFIG4_STEPS,
                                                            device)
    peak = torch.cuda.max_memory_allocated(device)
    check(launches[MIMC4]["dit_pass"] == 3
          and launches[MIMC4]["dif_pass"] == 2
          and launches[MIMC4]["fold4"] == 9,
          f"{MIMC4} launches {launches[MIMC4]}")
    print(f"  {MIMC4}: set-up {setup_s:.3f} s; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; bin_length {stt.bin_length(proof)} B, "
          f"raw_length {stt.raw_length(proof)} B", flush=True)
    print(f"  sharded, {BIG_STEPS} steps:", flush=True)
    phase_sharded(BIG_STEPS, proof16, launches)
    print(f"  sharded, {CONFIG4_STEPS} steps:", flush=True)
    phase_sharded(CONFIG4_STEPS, proof, launches)
    return steady["total"], proof


def phase_device_trace(device, host_proofs, launches):
    """Phase 11: the all-device MiMC proof
    (`prover.mk_mimc_proof_fused(device_trace=True)`: the trace built on
    the card by one launch of the trace kernel, none of it on the host)
    at BIG_STEPS and CONFIG4_STEPS steps, run after phase 9 (whose
    set-up it shares) and before the profiler. Each proof, counted
    alone, equals the host-trace proof of phases 4 and 9
    (`host_proofs`) byte for byte and verifies; it launches exactly one
    trace kernel and every other kernel as often as that proof, and
    waits for the card exactly once more than it (the last row's
    read-back). Prints the stage times (the device trace a stage of its
    own) and the calls that wait for the card."""
    import starks_tpu_torch as stt
    from starks_tpu_torch import prover
    for steps, path, host_path in ((BIG_STEPS, MIMC_DEV, MIMC),
                                   (CONFIG4_STEPS, MIMC4_DEV, MIMC4)):
        def run(timings=None):
            return prover.mk_mimc_proof_fused(
                INP, steps, CONSTS, device_trace=True, device=device,
                timings=timings)
        steady = {}
        proof, launches[path] = counted(lambda: run(steady))
        check(proof == host_proofs[steps],
              f"the all-device {steps}-step proof differs from the "
              f"host-trace proof")
        out = stt.mimc_forward(INP, steps, CONSTS)
        check(stt.verify_mimc_proof(INP, steps, CONSTS, out, proof),
              f"verifier rejected the all-device {steps}-step proof")
        want = dict(launches[host_path], mimc_trace=1)
        check(launches[path] == want,
              f"{path} launches {launches[path]}, expected {want}")
        waits = count_syncs(run, device)
        host_waits = count_syncs(lambda: stt.mk_mimc_proof(
            INP, steps, CONSTS, device=device), device)
        check(waits == host_waits + 1,
              f"{path} waits for the card {waits} times, the host-trace "
              f"proof {host_waits}: expected one more (the last row)")
        print(f"  {path}: equals the host-trace proof byte for byte; "
              f"verified; {waits} calls that wait for the card, the "
              f"host-trace proof {host_waits} (torch.cuda sync debug mode)",
              flush=True)
        print_launches(launches[path])
        for stage, sec in steady.items():
            print(f"    {stage:<32s} {sec * 1e3:10.3f} ms", flush=True)


def phase_profiles(device, mimc_steady_s, air_steady_s, chunk_steady_s,
                   mimc4_steady_s, air_chunk_steady_s):
    """Phase 7: one more proof of each timed kind (MiMC 2^16 and 2^20 on
    one card, fib-square), one batch chunk and one AIR chunk, under
    torch.profiler, each with its launches held against the port's
    counters. It runs after every timed proof, so no timing follows a
    profiler run."""
    import starks_tpu_torch as stt
    from starks_tpu_torch.models import fib_square as fib
    for steps, steady_s in ((BIG_STEPS, mimc_steady_s),
                            (CONFIG4_STEPS, mimc4_steady_s)):
        print(f"  MiMC {steps} steps:", flush=True)
        profile_proof(lambda: stt.mk_mimc_proof(INP, steps, CONSTS,
                                                device=device),
                      device, steady_s)
    air = fib.fib_square_air()
    for steps, steady in air_steady_s.items():
        print(f"  fib-square {steps} steps:", flush=True)
        profile_proof(lambda: stt.prove_air(air, [1, 1], steps,
                                            device=device),
                      device, steady)
    print(f"  {BATCH}:", flush=True)

    def chunk():
        stt.mk_mimc_proof_batch_fused(list(range(BATCH_CHUNK)), BIG_STEPS,
                                      CONSTS, chunk=BATCH_CHUNK, device=device)
    profile_proof(chunk, device, chunk_steady_s)
    print(f"  {AIR_BATCH}:", flush=True)
    claims = [[i + 1, 2 * i + 1] for i in range(AIR_CHUNK)]
    profile_proof(lambda: stt.prove_air_batch_fused(
        air, claims, BIG_STEPS, chunk=AIR_CHUNK, device=device), device,
        air_chunk_steady_s)
    for what, run in ((MIMC, lambda: stt.mk_mimc_proof(
            INP, BIG_STEPS, CONSTS, device=device)), (BATCH, chunk)):
        print(f"  {what}: {count_syncs(run, device)} calls that wait for "
              f"the card (torch.cuda sync debug mode)", flush=True)


def count_syncs(run, device) -> int:
    """The calls in `run()` that make the host wait for the card (a
    blocking copy, a stream synchronize), as torch's sync debug mode
    reports them."""
    import warnings
    import torch
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


# The field kernels, as the profiler and cuobjdump name them (mangled
# or not), with a template argument: the DIT pass's butterflies per
# thread, the elementwise frames' op.
FIELD_KERNEL = re.compile(
    r"^(?:void )?(?:_Z\d+)?(dif_pass|dit_pass|stream_map|flat_map|binary|db"
    r"|l|fold4|mimc_trace|batch_inv_(?:up|top|down|runs))_kernel"
    r"(?:I(?:Li(\d+)E|\d+(\w+?)|Li(\d+E\d+\w+?))Ev|<([\w, ]+)>)?"
    r"(?:\(|P|$)")
# The wrapper (and LAUNCHES key) each kernel or template op serves.
KERNEL_KEYS = {"db": "db_map", "l": "l_map", "ScaleOp": "scale",
               "ScaleAccOp": "scale", "CubeOp": "cube", "MulOp": "mul",
               "AddOp": "add", "SubOp": "sub", "batch_inv_up": "batch_inv",
               "batch_inv_top": "batch_inv", "batch_inv_down": "batch_inv",
               "batch_inv_runs": "batch_inv"}
# A profiler session drops its first few launches of the port's kernels
# (on an H100 with torch 2.11, more as sessions accumulate in a
# process), while it keeps torch's kernels around them. So each profile
# first makes PROFILE_PRIMER launches of its own, waits for the card,
# and counts only the device events that start inside the proof's own
# range (`record_function`): none of the primer's can, and no marker
# event has to be listed.
PROFILE_PRIMER = 256
PROFILE_RANGE = "chip_smoke: profiled run"
# Sessions tried before a profile whose range lists no kernel on the
# card is reported as not measured.
PROFILE_TRIES = 3


def kernel_label(name) -> str:
    """A field kernel's short name, with its template arguments if any
    (dit_pass<2>, stream_map<CubeOp>, mimc_trace<SharedConsts,
    RedundantRound>, batch_inv_up<8>); other names as
    they are."""
    m = FIELD_KERNEL.match(name)
    if not m:
        return name
    arg = (m.group(2) or (m.group(3) and re.sub(r"\d+", ", ", m.group(3)))
           or (m.group(4) and re.sub(r"E\d+", ", ", m.group(4)))
           or m.group(5))
    return f"{m.group(1)}<{arg}>" if arg else m.group(1)


def kernel_key(m) -> str:
    """The wrapper (LAUNCHES key) a FIELD_KERNEL match belongs to."""
    if m.group(1) in ("stream_map", "flat_map", "binary"):
        return KERNEL_KEYS[m.group(3) or m.group(5)]
    return KERNEL_KEYS.get(m.group(1), m.group(1))


def prime_profiler(device):
    """PROFILE_PRIMER launches of the port's add kernel on one element,
    then a wait for the card, so that every one ends before the
    profiled range starts."""
    import torch
    from starks_tpu_torch.ops import plimbs
    one = torch.ones((1, 8), dtype=torch.int32, device=device)
    for _ in range(PROFILE_PRIMER):
        plimbs.add(one, one)
    torch.cuda.synchronize(device)


def profiled_events(run, device):
    """`run()` under torch.profiler after the primer: the device events
    (start ns, duration us, name) of the profiler's raw (kineto) events
    that start inside the range around `run()`, those that start
    before it, and the port's counters (LAUNCHES) for the run. The raw
    events hold the same device events as prof.events(), which first
    builds a tree of every CPU and CUDA event (~540k for a 2^16-step
    proof: 46 s of host time a profile on the H100's host, against 3 s
    for these)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from starks_tpu_torch.ops import plimbs
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prime_profiler(device)
        with record_function(PROFILE_RANGE):
            plimbs.reset_launches()
            run()
            torch.cuda.synchronize(device)
        counts = dict(plimbs.LAUNCHES)
    raw = list(prof.profiler.kineto_results.events())
    start = min(evt.start_ns() for evt in raw if evt.name() == PROFILE_RANGE)
    # The range itself is listed on the card's timeline too, spanning the
    # run's kernels: it is no kernel.
    events = sorted((evt.start_ns(), evt.duration_ns() / 1e3, evt.name())
                    for evt in raw
                    if evt.device_type() == torch.autograd.DeviceType.CUDA
                    and evt.name() != PROFILE_RANGE)
    inside = [evt for evt in events if evt[0] >= start]
    return inside, events[:len(events) - len(inside)], counts


def count_inv_launches(rows, device):
    """The CUDA kernels one `plimbs.batch_inv` call launches at one
    element and at each size of INV_TIMED, as torch.profiler lists them
    (FIELD_KERNEL's batch_inv_up/top/down), in one session after the
    primer, each call inside a `record_function` range of its own: the
    kernels that start between a range's start and the next's belong to
    its call. Each count must be 2L - 1 for the L levels of
    `plimbs.batch_inv_levels`. More is a fault of the scan; fewer, in
    every one of PROFILE_TRIES sessions, leaves the count not measured
    (the profiler loses launches; a scan that skipped a kernel would
    fail phase 2's values). The counts, and each kernel's device time
    under the profiler, go into the batch_inv row."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from starks_tpu_torch.ops import plimbs
    gen = torch.Generator().manual_seed(SEED + 21)
    sizes = (1,) + INV_TIMED
    want = {n: 2 * len(plimbs.batch_inv_levels(
        n, *plimbs.batch_inv_shape(n))) - 1 for n in sizes}
    for attempt in range(1, PROFILE_TRIES + 1):
        arrays = {n: rand_elems(n, gen, device) for n in sizes}
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prime_profiler(device)
            for n in sizes:
                with record_function(f"chip_smoke: batch_inv {n}"):
                    plimbs.batch_inv(arrays[n])
                    torch.cuda.synchronize(device)
        raw = list(prof.profiler.kineto_results.events())
        starts = sorted((evt.start_ns(), int(evt.name().split()[-1]))
                        for evt in raw
                        if evt.name().startswith("chip_smoke: batch_inv ")
                        and evt.device_type()
                        == torch.autograd.DeviceType.CPU)
        got = dict.fromkeys(sizes, 0)
        kernel_us = {n: {} for n in sizes}
        for evt in raw:
            m = FIELD_KERNEL.match(evt.name())
            if (evt.device_type() != torch.autograd.DeviceType.CUDA
                    or not m or kernel_key(m) != "batch_inv"):
                continue
            owner = [n for t, n in starts if t <= evt.start_ns()]
            if owner:
                got[owner[-1]] += 1
                us = kernel_us[owner[-1]]
                label = kernel_label(evt.name())
                us[label] = us.get(label, 0.0) + evt.duration_ns() / 1e3
        check(all(got[n] <= want[n] for n in sizes),
              f"batch_inv launched more CUDA kernels a call than its levels "
              f"need: {got} against {want}")
        if got == want:
            break
        print(f"  batch_inv CUDA launches, profiler session {attempt} of "
              f"{PROFILE_TRIES}: {got}, short of {want}", flush=True)
    else:
        got = dict.fromkeys(sizes)
    row = rows["batch_inv"]
    for n in INV_TIMED:
        row["by_size"][n]["cuda_launches"] = got[n]
        row["by_size"][n]["profiled_kernel_us"] = kernel_us[n]
    row["cuda_launches_per_call"] = got[row["elements"]]
    print("  batch_inv CUDA launches a call, profiler (levels' 2L - 1): "
          + ", ".join(f"{n} elements {got[n]} ({want[n]})" for n in sizes)
          + ("" if got[1] is not None else "; not measured"), flush=True)
    for n in sizes:
        print(f"    {n} elements, device us under the profiler: " + ", ".join(
            f"{k} {v:.3f}" for k, v in kernel_us[n].items()), flush=True)


def profile_proof(run, device, steady_s):
    """One more proof (`run`) under torch.profiler (`profiled_events`):
    the CUDA kernels it launched, their device time, that time's share
    of the steady (stage-timed) wall time, the device time of the field
    kernels, and each field kernel's launches as the profiler lists them
    beside the port's counters (LAUNCHES) for the same run. Launches the
    profiler lost are printed per kernel, and then the busy share is
    marked a lower bound. A session whose range lists no kernel on the
    card is tried again, PROFILE_TRIES sessions in all; after that the
    profile is printed as not measured."""
    for attempt in range(1, PROFILE_TRIES + 1):
        events, before, counts = profiled_events(run, device)
        kernels = [evt for evt in events if "memcpy" not in evt[2].lower()
                   and "memset" not in evt[2].lower()]
        if kernels:
            break
        print(f"  profiler session {attempt} of {PROFILE_TRIES} listed no "
              f"kernel on the card in the profiled range ({len(before)} "
              f"device events before it)", flush=True)
    else:
        print("  profiled proof: not measured (the profiler listed no "
              "kernel on the card)", flush=True)
        return
    primer = sum(bool(FIELD_KERNEL.match(name)) for _, _, name in before)
    device_us, field_us, seen = 0.0, {}, {}
    for _, us, name in kernels:
        device_us += us
        m = FIELD_KERNEL.match(name)
        if m:
            key = kernel_key(m)
            field_us[key] = field_us.get(key, 0.0) + us
            seen[key] = seen.get(key, 0) + 1
    lost = {k: v - seen.get(k, 0) for k, v in counts.items()
            if v != seen.get(k, 0)}
    busy = device_us / 1e6 / steady_s
    print(f"  profiled proof: {len(kernels)} CUDA kernel launches, "
          f"{device_us / 1e6:.5f} s of kernel time, device busy {busy:.2%}"
          f"{' (a lower bound: launches lost)' if lost else ''} of the "
          f"steady {steady_s:.5f} s; field kernels (ms): "
          + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in
                      sorted(field_us.items(), key=lambda kv: -kv[1])),
          flush=True)
    print(f"    field kernel launches, profiler / counters: " + ", ".join(
        f"{k} {seen.get(k, 0)}/{v}" for k, v in counts.items() if v)
        + (f"; LOST by the profiler: {lost}" if lost else
           "; none lost (the profile is whole)")
        + f"; primer: {primer} of {PROFILE_PRIMER} listed"
        + (f"; session {attempt} of {PROFILE_TRIES}" if attempt > 1 else ""),
        flush=True)


def phase_launches(rows, launches):
    """Phase 8: each path launched every kernel it runs, the NTTs only
    through the multi-stage passes (one DIF and one DIT transform for
    all of a proof's columns: <= 3 DIF or DIT pass launches per MiMC
    2^16 proof and <= 2 per fib-square 2^13 proof), and the MiMC path no
    scale (the LDE's 1/n is in the DIF transform); one batch chunk
    launches each kernel exactly as often as one MiMC 2^16 proof, and
    one AIR chunk as often as one fib-square 2^16 proof (the claim axis,
    not a loop over claims); prints the scale and add counts of every
    path (the AIR sums take each scaled term with scale's accumulator,
    so no add follows a scale); each kernel row gets the count of its
    own main path and those of every path."""
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(launches[path][name] > 0,
                  f"kernel {name} never ran on the {path} path")
    for chunk, one in ((BATCH, MIMC), (AIR_BATCH, FIB_BIG),
                       (BATCH_DP, MIMC)):
        for name, count in launches[one].items():
            check(launches[chunk][name] == count,
                  f"{launches[chunk][name]} {name} launches per {chunk}, "
                  f"{count} per {one} proof")
        print(f"  {chunk}: every kernel's launches equal one {one} "
              f"proof's", flush=True)
    for path in (MIMC4, SHARDED.format(BIG_STEPS), MIMC4_SHARDED, MIMC_DEV,
                 MIMC4_DEV, TRACE, BATCH_DP, FIB_BIG + SETUP, FIB + SETUP,
                 MIMC_AIR + SETUP, MIMC4 + SETUP):
        extra = [k for k, v in launches[path].items()
                 if v and k not in PATH_KERNELS[path]]
        check(not extra, f"the {path} path launched {extra}")
    check(launches[MIMC]["scale"] == 0,
          f"{launches[MIMC]['scale']} scale launches on the {MIMC} path")
    for name in ("dif_pass", "dit_pass"):
        check(launches[MIMC][name] <= 3,
              f"{launches[MIMC][name]} {name} launches on the {MIMC} path")
        check(launches[FIB][name] <= 2,
              f"{launches[FIB][name]} {name} launches on the {FIB} path")
    for name in ("scale", "add"):
        print(f"  {name} launches per path: " + " / ".join(
            str(launches[p][name]) for p in PATH_KERNELS) + " ("
            + " / ".join(PATH_KERNELS) + ")", flush=True)
    for name, row in rows.items():
        row["path"] = next(p for p, ks in PATH_KERNELS.items() if name in ks)
        row["launches"] = launches[row["path"]][name]
        row["launches_by_path"] = {p: launches[p][name] for p in PATH_KERNELS}
        print(f"  {name:<10s} " + ", ".join(
            f"{p} {n}" for p, n in row["launches_by_path"].items()),
            flush=True)


def announce(title):
    """A phase's title line, with the seconds since the script started."""
    print(f"{title} [{time.perf_counter() - STARTED:.1f} s]", flush=True)


def setups_main(root) -> int:
    """`--setups [ROOT]` (the module docstring): the set-ups of the port
    in ROOT, timed and profiled."""
    import cProfile
    import pstats
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(root).resolve()))
    import starks_tpu_torch as stt
    from starks_tpu_torch import prover
    from starks_tpu_torch.air import _FusedAIRSetup
    from starks_tpu_torch.models import fib_square as fib
    from starks_tpu_torch.models.mimc import mimc_air
    device = torch.device("cuda", 0)
    print(f"set-ups of {Path(stt.__file__).parent}; {card_line()}",
          flush=True)
    air = fib.fib_square_air()
    stt.prove_air(air, [1, 1], AIR_CHECK_STEPS, device=device)
    builds = {f"fib-square {SMALL_STEPS}": lambda: _FusedAIRSetup(
                  air, SMALL_STEPS, stt.REFERENCE, device),
              f"fib-square {BIG_STEPS}": lambda: _FusedAIRSetup(
                  air, BIG_STEPS, stt.REFERENCE, device),
              f"MiMC-as-AIR {SMALL_STEPS}": lambda: _FusedAIRSetup(
                  mimc_air(AIR_CONSTS), SMALL_STEPS, stt.REFERENCE, device),
              f"MiMC {CONFIG4_STEPS}": lambda: prover._FusedSetup(
                  CONFIG4_STEPS, stt.REFERENCE, device)}
    for name, build in builds.items():
        seconds = []
        for _ in range(SETUP_REPS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            build()
            torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
        print(f"  {name} set-up (s): " + ", ".join(f"{s:.5f}"
                                                    for s in seconds),
              flush=True)
    name = f"fib-square {BIG_STEPS}"
    host = cProfile.Profile()
    host.enable()
    builds[name]()
    torch.cuda.synchronize(device)
    host.disable()
    print(f"  {name} set-up under cProfile:", flush=True)
    pstats.Stats(host, stream=sys.stdout).sort_stats("tottime").print_stats(
        SETUP_PROFILE_ROWS)
    events, _, counts = profiled_events(builds[name], device)
    print(f"  {name} set-up under torch.profiler: {len(events)} device "
          f"events, {sum(us for _, us, _ in events) / 1e3:.3f} ms on the "
          f"card; launches " + ", ".join(f"{k} {v}" for k, v in
                                         counts.items() if v), flush=True)
    return 0


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--setups"]:
        return setups_main(sys.argv[2] if len(sys.argv) > 2 else ".")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from starks_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable: {exc}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)

    announce("phase 1: card and build")
    card = phase_build(_build)

    announce(f"phase 2: kernels against plain versions at {BIG_STEPS}-step "
             f"shapes")
    rows = phase_kernels(BIG_STEPS, device)
    phase_claims(rows, device)
    phase_elementwise_claims(rows, device)
    trace_launches = phase_trace(rows, device)
    phase_batch_inv(rows, device)
    phase_dif_designs(device)
    phase_dit_designs(device)
    phase_stream_turns(device)

    announce("phase 3: main path, small proof")
    small_oracle = phase_small_proof(SMALL_STEPS, device)
    announce("phase 4: main path, large proof")
    proof16, mimc_steady_s, mimc_launches = phase_big_proof(BIG_STEPS,
                                                           device)

    announce("phase 5: general AIR proofs")
    air_steady_s, launches, fib_proof16 = phase_air(device)
    launches[MIMC] = mimc_launches
    launches[TRACE] = trace_launches

    announce(f"phase 6: batch proving ({BATCH_CLAIMS} x {BIG_STEPS} steps, "
             f"chunk {BATCH_CHUNK}, verified)")
    chunk_steady_s, launches[BATCH], batch_proofs = phase_batch(
        device, small_oracle)

    # Before phase 7: a profiler session slows every later launch.
    announce(f"phase 12: config 5 over {DP_RANKS} ranks ({DP_CLAIMS} x "
             f"{BIG_STEPS} steps, chunk {DP_CHUNK}, verified)")
    phase_batch_ranks(batch_proofs, launches)

    announce(f"phase 10: AIR proofs over a claim axis ({AIR_CHUNK} x "
             f"fib-square {BIG_STEPS} steps in one chunk)")
    air_chunk_steady_s, launches[AIR_BATCH] = phase_air_batch(
        device, fib_proof16, launches)

    # Config 4 runs before phase 7: a profiler session slows every later
    # launch in the process.
    announce(f"phase 9: benchmark config 4 ({CONFIG4_STEPS} steps, "
             f"{CONFIG4_STEPS * EXT}-point domain), one card and {SHARDS} "
             f"shards")
    mimc4_steady_s, proof4 = phase_config4(rows, device, proof16, launches)

    announce(f"phase 11: the all-device MiMC proof (device trace; "
             f"{BIG_STEPS} and {CONFIG4_STEPS} steps)")
    phase_device_trace(device, {BIG_STEPS: proof16, CONFIG4_STEPS: proof4},
                       launches)

    announce("phase 7: profiled proofs")
    phase_profiles(device, mimc_steady_s, air_steady_s, chunk_steady_s,
                   mimc4_steady_s, air_chunk_steady_s)
    count_inv_launches(rows, device)

    announce("phase 8: launches on the main paths")
    phase_launches(rows, launches)
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
