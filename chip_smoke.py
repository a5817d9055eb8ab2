#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (starks_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. print the card's name and power limit; build the CUDA kernels from
     starks_tpu_torch/csrc/ into build/ and print the build time and the
     compiler's register report;
  2. each kernel against its plain PyTorch version on seeded random
     inputs (plus edge values) at the shapes of a 2^16-step proof, the
     NTT stages at their first, middle and last stage, the elementwise
     ops (mul, add, sub) with full, 8-periodic and constant operands on
     either side, exact equality; time each (CUDA events, median) beside
     its plain version and its bound;
  3. the main path: a 2^13-step proof, equal byte for byte to the spec
     oracle (oracle/stark.py) and accepted by the port's verifier;
  4. a 2^16-step proof (2^19-point evaluation domain), accepted by the
     port's verifier, with one flipped byte rejected; per-stage times;
  5. general AIR proofs (benchmark config 3): fib-square at 2^10 steps on
     the card equal to the CPU path byte for byte; fib-square at 2^13 and
     2^16 accepted, with a changed boundary value and a flipped leaf byte
     rejected, the output equal to fib_square_output, per-stage times,
     launches per proof; the declarative form equal to the closure form
     at 2^13; MiMC written as an AIR at 2^13 accepted with the output of
     mimc_forward (the path of the cube kernel);
  6. one more MiMC 2^16 and fib-square 2^13 and 2^16 proof each under
     torch.profiler, after all timed proofs: CUDA launches, device busy
     share against the steady stage-timed wall time, device time of the
     field kernels;
  7. every kernel's launches on each main path: the steady MiMC 2^16,
     fib-square 2^13 and 2^16 proofs and the MiMC-as-AIR proof, each
     counted alone (counts set to 0 just before it, read just after);
     each kernel > 0 on every path that runs it; one JSON line of kernel
     rows, each with the count of its own main path and the counts of
     every path, and the result line.

Needs one CUDA card; imports nothing of JAX or of the JAX package.
"""

import copy
import json
import re
import statistics
import subprocess
import sys
import time

SEED = 20261016
CONSTS = [(i ** 7) ^ 42 for i in range(64)]
INP = 3
SMALL_STEPS = 2 ** 13
BIG_STEPS = 2 ** 16
AIR_CHECK_STEPS = 2 ** 10     # card against the CPU path
AIR_CONSTS = CONSTS[:16]      # MiMC as an AIR: one 16-entry column
EXT = 8

# Bound model. Bytes: HBM at 3.35 TB/s (H100 SXM data sheet). Operations:
# 32-bit integer multiply-adds at 64 per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0), times the card's SM count and maximum SM clock, read
# at run time.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_CLOCK_PER_SM = 64
ELEM = 32                     # bytes per field element
# Least 32-bit integer operations per field op in csrc/field.cuh. A modmul
# takes 64 (schoolbook) + 8 + 2 (folds by 350) variable 32x32->64
# products, each two multiply-adds (low and high word); products by
# 2^32 - 1 and all carry adds are left out. An add or sub takes at least
# one operation per word. So the operations bound is a least time.
OPS_MUL = 2 * (64 + 8 + 2)
OPS_ADD = 8

SRC = "starks_tpu_torch/csrc/kernels.cu"
REPLACES = {
    "dif_stage": "starks_tpu/ops/plimbs.py:154",
    "dit_stage": "starks_tpu/ops/plimbs.py:161",
    "scale": "starks_tpu/ops/plimbs.py:175",
    "db_map": "starks_tpu/ops/plimbs.py:181",
    "l_map": "starks_tpu/ops/plimbs.py:203",
    "fold4": "starks_tpu/ops/plimbs.py:212",
    "mul": "starks_tpu/ops/plimbs.py:149",
    "add": "starks_tpu/ops/plimbs.py:279",
    "sub": "starks_tpu/ops/plimbs.py:284",
    "cube": "starks_tpu/ops/plimbs.py:289",
}
# The main paths, each counted alone, and the kernels each must launch.
# A kernel's row reports the count of the first path here that runs it.
NTT_FRI = ["dif_stage", "dit_stage", "scale", "fold4"]
FIB = f"fib-square {SMALL_STEPS}"
FIB_BIG = f"fib-square {BIG_STEPS}"
MIMC = f"MiMC {BIG_STEPS}"
MIMC_AIR = f"MiMC-as-AIR {SMALL_STEPS}"
PATH_KERNELS = {
    FIB: NTT_FRI + ["mul", "add", "sub"],
    FIB_BIG: NTT_FRI + ["mul", "add", "sub"],
    MIMC: NTT_FRI + ["db_map", "l_map"],
    MIMC_AIR: NTT_FRI + ["mul", "add", "sub", "cube"],
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


def edge_elems(device):
    from starks_tpu_torch.ops import limbs as fl
    from starks_tpu_torch.utils.conversions import ints_to_tensor
    m = fl.MODULUS
    return ints_to_tensor([0, 1, 2, m - 1, m - 2, 2 ** 255, (1 << 240) - 1],
                          device)


def int_ops_per_s(device) -> float:
    """Peak 32-bit integer multiply-adds per second of the card."""
    import torch
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi: {res.stderr.strip()}")
    mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"  {sms} SMs at {mhz:.0f} MHz max: "
          f"{INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6:.4e} int32 "
          f"multiply-adds/s", flush=True)
    return INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6


def kernel_cases(steps, device):
    """(name, wrapper, plain, [args, ...], bytes, ops) for each kernel at
    the shapes a `steps`-step proof gives it, with edge values up front.
    Every args tuple is checked and timed; the first is bounded and goes
    into the kernel's row. The NTT stages are checked at their first,
    middle and last stage."""
    import torch
    from starks_tpu_torch.ops import plimbs
    gen = torch.Generator().manual_seed(SEED)
    n_big = steps * EXT
    edge = edge_elems(device)
    ne = edge.shape[0]

    def arr(n):
        a = rand_elems(n, gen, device)
        a[:ne] = edge
        return a

    def one():
        return rand_elems(1, gen, device)[0]

    const = rand_elems(1, gen, device)          # [1, 8], read periodically

    x_small, tw_small = arr(steps), arr(steps)
    x_big, tw_big = arr(n_big), arr(n_big)
    p, xs, iz2 = arr(n_big), arr(n_big), arr(n_big)
    k_tab, zni = arr(EXT * len(CONSTS)), arr(EXT)
    d, b, cp, cb = arr(n_big), arr(n_big), arr(EXT), arr(EXT)
    ip = arr(n_big // 4)
    s, last, slope, ia = one(), one(), one(), one()
    sx, eta, inv4 = one(), one(), one()
    q = n_big // 4

    def stage_bytes(n):          # x in, out, stage-0 twiddles n/2
        return ELEM * (2 * n + n // 2)

    def stages(x, tw):
        logn = x.shape[0].bit_length() - 1
        return [(x, tw, t) for t in (0, logn // 2, logn - 1)]

    return [
        ("dif_stage", plimbs.dif_stage, plimbs.dif_stage_plain,
         stages(x_small, tw_small), stage_bytes(steps),
         steps // 2 * (OPS_MUL + 2 * OPS_ADD)),
        ("scale", plimbs.scale, plimbs.scale_plain, [(x_small, s)],
         ELEM * (2 * steps + 1), steps * OPS_MUL),
        ("dit_stage", plimbs.dit_stage, plimbs.dit_stage_plain,
         stages(x_big, tw_big), stage_bytes(n_big),
         n_big // 2 * (OPS_MUL + 2 * OPS_ADD)),
        ("db_map", plimbs.db_map, plimbs.db_map_plain,
         [(p, xs, k_tab, zni, iz2, last, slope, ia, EXT)],
         ELEM * (5 * n_big + k_tab.shape[0] + EXT + 3),
         n_big * (6 * OPS_MUL + 5 * OPS_ADD)),
        ("l_map", plimbs.l_map, plimbs.l_map_plain, [(d, p, b, cp, cb)],
         ELEM * (4 * n_big + 2 * EXT), n_big * (2 * OPS_MUL + 2 * OPS_ADD)),
        ("fold4", plimbs.fold4, plimbs.fold4_plain,
         [(x_big, ip, sx, eta, inv4)], ELEM * (n_big + 2 * q + 3),
         q * (6 * OPS_MUL + 11 * OPS_ADD)),
        ("mul", plimbs.mul, plimbs.mul_plain,
         [(x_big, p), (d, zni), (const, xs)], ELEM * 3 * n_big,
         n_big * OPS_MUL),
        ("add", plimbs.add, plimbs.add_plain,
         [(x_big, p), (const, xs), (d, cp)], ELEM * 3 * n_big,
         n_big * OPS_ADD),
        ("sub", plimbs.sub, plimbs.sub_plain,
         [(x_big, p), (zni, xs), (b, const)], ELEM * 3 * n_big,
         n_big * OPS_ADD),
        ("cube", plimbs.cube, plimbs.cube_plain, [(x_big,)],
         ELEM * 2 * n_big, n_big * 2 * OPS_MUL),
    ]


def time_ms(fn, reps, device):
    """Median ms of `reps` single calls, each timed with CUDA events
    after the L2 cache (50 MB) is overwritten."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=device)
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_kernels(steps, device, reps=20, plain_reps=3):
    """Phase 2: each kernel equals its plain version; times and bounds."""
    ops_per_s = int_ops_per_s(device)
    rows = {}
    for name, wrapper, plain, cases, nbytes, ops in kernel_cases(steps,
                                                                 device):
        err = max(max_abs_err(wrapper, plain, args) for args in cases)
        args = cases[0]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        row = {"name": name, "route": "cuda", "source": SRC,
               "replaces": REPLACES[name], "launches": 0,
               "max_abs_err": err,
               "ms": time_ms(lambda: wrapper(*args), reps, device),
               "plain_ms": time_ms(lambda: plain(*args), plain_reps, device),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": None}
        rows[name] = row
        print(f"  {name:<10s} equal to plain in {len(cases)} case(s) "
              f"(max_abs_err {err}); "
              f"kernel {row['ms']} ms, plain {row['plain_ms']} ms, "
              f"bound {row['bound_ms']:.6f} ms ({row['bound_by']})",
              flush=True)
        if len(cases) > 1:
            print("    kernel ms in the other cases: " + ", ".join(
                str(time_ms(lambda a=a: wrapper(*a), reps, device))
                for a in cases[1:]), flush=True)
    return rows


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
    """Phase 3: byte equality with the spec oracle, and the verifier."""
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


def phase_big_proof(steps, device):
    """Phase 4: a large proof verifies; a flipped byte is rejected.
    Returns the steady proof's wall time and launch counts."""
    import starks_tpu_torch as stt
    first, steady = {}, {}
    stt.mk_mimc_proof(INP, steps, CONSTS, device=device, timings=first)
    proof, launches = counted(lambda: stt.mk_mimc_proof(
        INP, steps, CONSTS, device=device, timings=steady))
    out = stt.mimc_forward(INP, steps, CONSTS)
    t0 = time.perf_counter()
    check(stt.verify_mimc_proof(INP, steps, CONSTS, out, proof),
          "verifier rejected the large proof")
    verify_s = time.perf_counter() - t0
    leaf = bytearray(proof[2][0][0])
    leaf[0] ^= 1
    proof[2][0][0] = bytes(leaf)
    expect_rejected(
        lambda q: stt.verify_mimc_proof(INP, steps, CONSTS, out, q), proof,
        "a tampered proof")
    print(f"  {steps}-step proof verified in {verify_s:.3f} s; tampered "
          f"proof rejected", flush=True)
    print_launches(launches)
    print_stages(first, steady)
    return steady["total"], launches


def print_stages(first, steady):
    print(f"  first call (with setup): total {first['total']:.4f} s",
          flush=True)
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
    Returns the steady fib-square wall times by steps, and the launch
    counts of each counted path."""
    import starks_tpu_torch as stt
    from starks_tpu_torch.models import fib_square as fib
    from starks_tpu_torch.models.mimc import mimc_air, mimc_forward
    air = fib.fib_square_air()

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
        print_stages(first, steady)
        steady_s[steps] = steady["total"]
        proofs[steps] = proof

    d_proof = stt.prove_air(fib.fib_square_air_declarative(), [1, 1],
                            SMALL_STEPS, device=device)
    check(d_proof == proofs[SMALL_STEPS],
          "the declarative fib-square proof differs from the closure form's")
    print(f"  declarative fib-square {SMALL_STEPS}-step proof equals the "
          f"closure form's byte for byte", flush=True)

    m_air = mimc_air(AIR_CONSTS)
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
          f"mimc_forward ({t1 - t0:.3f} s incl. setup)", flush=True)
    print_launches(launches[MIMC_AIR])
    return steady_s, launches


def phase_profiles(device, mimc_steady_s, air_steady_s):
    """Phase 6: one more proof of each timed kind under torch.profiler.
    It runs after every stage-timed proof, so no timing follows a
    profiler run."""
    import starks_tpu_torch as stt
    from starks_tpu_torch.models import fib_square as fib
    print(f"  MiMC {BIG_STEPS} steps:", flush=True)
    profile_proof(lambda: stt.mk_mimc_proof(INP, BIG_STEPS, CONSTS,
                                            device=device),
                  device, mimc_steady_s)
    air = fib.fib_square_air()
    for steps, steady in air_steady_s.items():
        print(f"  fib-square {steps} steps:", flush=True)
        profile_proof(lambda: stt.prove_air(air, [1, 1], steps,
                                            device=device),
                      device, steady)


# The field kernels, as the profiler names them (mangled or not).
FIELD_KERNEL = re.compile(
    r"^(?:void )?(?:_Z\d+)?(dif|dit|scale|db|l|fold4|mul|add|sub|cube)"
    r"_kernel(?:\(|P|$)")


def profile_proof(run, device, steady_s):
    """One more proof (`run`) under torch.profiler: the CUDA kernels it
    launched, their device time, that time's share of the steady
    (stage-timed) wall time, and the device time of the field kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    launches, device_us, field_us = 0, 0.0, {}
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or "memcpy" in evt.name.lower()
                or "memset" in evt.name.lower()):
            continue
        us = evt.time_range.elapsed_us()
        launches += 1
        device_us += us
        m = FIELD_KERNEL.match(evt.name)
        if m:
            field_us[m.group(1)] = field_us.get(m.group(1), 0.0) + us
    check(launches > 0, "the profiler saw no kernel on the card")
    print(f"  profiled proof: {launches} CUDA kernel launches, "
          f"{device_us / 1e6:.5f} s of kernel time, device busy "
          f"{device_us / 1e6 / steady_s:.2%} of the steady "
          f"{steady_s:.5f} s; field kernels (ms): "
          + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in
                      sorted(field_us.items(), key=lambda kv: -kv[1])),
          flush=True)


def phase_launches(rows, launches):
    """Phase 7: each path launched every kernel it runs; each kernel row
    gets the count of its own main path and those of every path."""
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(launches[path][name] > 0,
                  f"kernel {name} never ran on the {path} path")
    for name, row in rows.items():
        row["path"] = next(p for p, ks in PATH_KERNELS.items() if name in ks)
        row["launches"] = launches[row["path"]][name]
        row["launches_by_path"] = {p: launches[p][name] for p in PATH_KERNELS}
        print(f"  {name:<10s} " + ", ".join(
            f"{p} {n}" for p, n in row["launches_by_path"].items()),
            flush=True)


def main() -> int:
    import torch
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

    print("phase 1: card and build", flush=True)
    card = card_line()
    print(f"  card: {card}", flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{lib_path.name}", flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"    {line.strip()}", flush=True)

    print(f"phase 2: kernels against plain versions at {BIG_STEPS}-step "
          f"shapes", flush=True)
    rows = phase_kernels(BIG_STEPS, device)

    print("phase 3: main path, small proof", flush=True)
    phase_small_proof(SMALL_STEPS, device)
    print("phase 4: main path, large proof", flush=True)
    mimc_steady_s, mimc_launches = phase_big_proof(BIG_STEPS, device)

    print("phase 5: general AIR proofs", flush=True)
    air_steady_s, launches = phase_air(device)
    launches[MIMC] = mimc_launches

    print("phase 6: profiled proofs", flush=True)
    phase_profiles(device, mimc_steady_s, air_steady_s)

    print("phase 7: launches on the main paths", flush=True)
    phase_launches(rows, launches)
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
