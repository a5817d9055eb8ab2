"""torch.profiler around a traced run's window, and its reduction.

A profiler session drops its first few launches of the program's own
kernels (launched through ctypes, not through torch), more as sessions
accumulate in a process, while it keeps torch's. So the session first
makes PRIMER launches of the program's add kernel and waits for the
card, and the reduction counts only the device events that start inside
the window's own `record_function` range: none of the primer's can.

The reduction reads the profiler's raw (kineto) events: the device's
busy time as the union of every device interval (kernels, copies,
fills) inside the window, the kernels' time by name, the field kernels'
time (FIELD_KERNEL, the program's CUDA kernels by name), the kernel
launches, and the idle gaps between device intervals, each named by the
innermost host event that spans its middle.
"""

import heapq
import re
from contextlib import contextmanager

import torch

PRIMER = 256
RANGE = "portbench: window"
SMALL_GAP_NS = 20_000
SMALL_GAP_NAME = "gaps under 20 us"
TOP = 10
# The program's field kernels as the profiler names them (mangled or
# not): csrc/kernels.cu's NTT passes, elementwise frames, maps, fold,
# trace and batch-inverse kernels.
FIELD_KERNEL = re.compile(
    r"^(?:void )?(?:_Z\d+)?(dif_pass|dit_pass|stream_map|flat_map|binary|db"
    r"|l|fold4|mimc_trace|batch_inv_(?:up|top|down))_kernel")


def kernel_label(name: str) -> str:
    m = FIELD_KERNEL.match(name)
    if m:
        return m.group(1) + "_kernel"
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:120]


def _is_annotation(name: str) -> bool:
    """A range the profiler draws on the card's timeline beside the
    kernels it spans (the window's own, NCCL's "nccl:..." ones): no
    device work of its own."""
    return name == RANGE or name.startswith("nccl:")


def _is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


@contextmanager
def session(device, primer):
    """Profile the body, after `primer()` (PRIMER launches of the
    program's kernels) and a wait for the card; yields a dict that holds
    the reduction (`reduce`) once the body has ended."""
    from torch.profiler import ProfilerActivity, profile, record_function
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    out = {}
    sync()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])) as prof:
        for _ in range(PRIMER):
            primer()
        sync()
        with record_function(RANGE):
            yield out
            sync()
    out.update(reduce(prof.profiler.kineto_results.events()))


def reduce(raw) -> dict:
    """The window's numbers from raw profiler events (objects with
    name(), start_ns(), duration_ns() and device_type())."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, win = [], [], None
    for e in raw:
        name = e.name()
        if e.device_type() == cuda:
            if not _is_annotation(name):
                s = e.start_ns()
                dev.append((s, s + e.duration_ns(), name))
        elif name == RANGE:
            win = (e.start_ns(), e.start_ns() + e.duration_ns())
        else:
            s = e.start_ns()
            host.append((s, s + e.duration_ns(), name))
    if win is None:
        return {}
    w0, w1 = win
    dev = [(s, min(e, w1), n) for s, e, n in dev if w0 <= s < w1]
    host = [h for h in host if h[0] < w1 and h[1] > w0]
    return reduce_intervals(dev, host, w0, w1)


def reduce_intervals(dev, host, w0: int, w1: int) -> dict:
    """`dev` and `host`: (start ns, end ns, name) of device and host
    events; [w0, w1) the window."""
    dev.sort()
    busy_ns, gaps = 0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_ns += cur_e - cur_s
                gaps.append((cur_e, s))
            else:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
        gaps.append((cur_e, w1))
    else:
        gaps.append((w0, w1))
    by_kernel, field_ns, launches = {}, 0, 0
    for s, e, name in dev:
        label = kernel_label(name)
        by_kernel[label] = by_kernel.get(label, 0) + (e - s)
        if not _is_copy(name):
            launches += 1
        if FIELD_KERNEL.match(name):
            field_ns += e - s
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "kernel_launches": launches, "field_kernel_s": field_ns / 1e9,
            "device_ops": sorted(([k, v / 1e9] for k, v in by_kernel.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> list:
    """Idle seconds by the innermost host event over each gap's middle
    (the latest-starting one that spans it), found in one sweep over
    the middles in order; gaps under SMALL_GAP_NS summed apart."""
    host.sort()
    totals = {}
    big = []
    for s, e in gaps:
        if e <= s:
            continue
        if e - s < SMALL_GAP_NS:
            totals[SMALL_GAP_NAME] = totals.get(SMALL_GAP_NAME, 0) + (e - s)
        else:
            big.append(((s + e) // 2, e - s))
    big.sort()
    live, k = [], 0                  # max-heap on start: (-start, end, name)
    for mid, length in big:
        while k < len(host) and host[k][0] <= mid:
            heapq.heappush(live, (-host[k][0], host[k][1], host[k][2]))
            k += 1
        # Events that end before this middle end before every later one.
        while live and live[0][1] < mid:
            heapq.heappop(live)
        name = live[0][2] if live else "no host event"
        totals[name] = totals.get(name, 0) + length
    return sorted(([k, v / 1e9] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:TOP]
