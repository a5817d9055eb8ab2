"""What the per-layer readers (benchmark/metrics/) share. Each returns
None where the record holds nothing to read, and the metric is then
left out of the run's line."""

import statistics

HASH_STAGES = ("merkle #1", "linear combination + merkle #2",
               "spot-check bundles", "fri")


def per_proof(total, rec):
    """A total over the traced part of the window, per proof in it."""
    n = rec.get("profiled_proofs")
    return total / n if n else None


def profile(rec) -> dict:
    return rec.get("profile") or {}


def field_roofline(rec):
    """100 x the least time of the window's field work (the frozen bound
    model, per proof from the configuration's shapes) over the device
    time of the program's field kernels in the profiled window."""
    prof = profile(rec)
    if not prof.get("field_kernel_s") or not rec.get("field_least_s"):
        return None
    return 100.0 * rec["profiled_proofs"] * rec["field_least_s"] / \
        prof["field_kernel_s"]


def launches_per_proof(rec):
    prof = profile(rec)
    if not prof.get("kernel_launches"):
        return None
    return per_proof(prof["kernel_launches"], rec)


def device_idle_pct(rec):
    prof = profile(rec)
    if not prof.get("window_s") or not prof.get("busy_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def head_proof_s(rec):
    """Median seconds of a proof in the traced run's unprofiled head:
    the record's per-proof times before the profiled part."""
    times = rec.get("times") or []
    head = times[:len(times) - rec.get("profiled_proofs", 0)]
    return statistics.median(head) if head else None


def hash_stages_s(rec):
    """Mean over the window's proofs of the stages that build the trees,
    the spot-check bundles and FRI, as the prover's `timings=` names
    them (the first by the start of its key)."""
    stages = rec.get("timings") or []
    if not stages:
        return None
    sums = [sum(v for k, v in t.items()
                if any(k.startswith(s) for s in HASH_STAGES))
            for t in stages]
    return sum(sums) / len(sums)


def mesh_total(rec, what: str):
    """Rank 0's total of `what` over the collectives, a proof of the
    traced run's unprofiled head (where `Mesh.timed` was on)."""
    mesh = rec.get("mesh")
    if not mesh or not mesh["proofs"]:
        return None
    return sum(mesh[what].values()) / mesh["proofs"]
