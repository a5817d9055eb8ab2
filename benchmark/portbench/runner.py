"""One run of one cell: its traffic's window, the metrics read from the
record, the correctness check, and the result's line."""

import gc
import statistics
import sys

import torch

from . import bound, card, check, manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "starks_tpu", "oracle")


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name (before the first dot),
    compared whole, is JAX's, the JAX package's or the oracle's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def forbidden_anywhere(result: dict) -> list:
    """What `forbidden_loaded` finds in this process, and what the
    cell's other processes (the sharded cell's ranks) found in theirs
    once the window had closed; takes their list out of `result`."""
    return forbidden_loaded() + result.pop("forbidden_in_ranks")


def _free_program_state():
    from starks_tpu_torch import prover
    prover._FusedSetup._cache.clear()
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _device_info(cell, device) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": cell.chips,
                "sms": None, "max_sm_clock_mhz": None}
    return card.describe(device, cell.chips)


def run_cell(cell: "manifest.Cell", seed: int, seconds: float, trace: bool,
             device, t_start: float, overrides: dict = None) -> dict:
    """The result object of one run (`overrides`: the program's protocol
    values changed, for the control)."""
    rec = cell.driver().run(cell.config, cell.traffic, seed, seconds, trace,
                            device, overrides)
    rec["setup_s"] = rec["setup_end"] - t_start
    info = _device_info(cell, device)
    if info["sms"]:
        rec["field_least_s"] = bound.proof_least_seconds(
            cell.config, info["sms"], info["max_sm_clock_mhz"])
    _report_times(rec, t_start)
    _free_program_state()
    checks = check.check(rec, cell.config, cell.traffic, seed, device)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {k: info[k] for k in ("platform", "kind", "count")}
    dev["memory_peak_bytes"] = rec["memory_peak_bytes"]
    if "power_limit_w" in info:
        dev["power_limit_w"] = info["power_limit_w"]
    result = {"correct": all(check.holds(v, b, k) for _, v, b, k in checks),
              "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": dev}
    prof = rec.get("profile") or {}
    if trace and prof:
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["forbidden_in_ranks"] = rec.get("forbidden_loaded", [])
    result["checks"] = {name: {"value": v, kind: b}
                        for name, v, b, kind in checks}
    for name, v, b, kind in checks:
        print(f"check {name} {v} {kind} {b}", file=sys.stderr, flush=True)
    return result


def _report_times(rec: dict, t_start: float):
    last, parts = t_start, []
    for stage, t in rec.get("setup_marks", []):
        parts.append(f"{stage} {t - last:.6f}")
        last = t
    print("portbench: set-up split (s): " + ", ".join(parts),
          file=sys.stderr, flush=True)
    times = rec.get("times") or []
    if times:
        print(f"portbench: {len(times)} timed ({rec['time_unit']}): median "
              f"{statistics.median(times):.6f} s, max {max(times):.6f} s; "
              f"window {rec['window_s']:.6f} s, {rec['completed']} proofs, "
              f"set-up {rec['setup_s']:.6f} s; each: "
              + " ".join(f"{t:.4f}" for t in times),
              file=sys.stderr, flush=True)
