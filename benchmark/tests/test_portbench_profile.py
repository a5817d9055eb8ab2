"""The per-layer arithmetic on recorded profiler events."""

import pytest

from portbench import manifest, profile, readers


class Ev:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)


DIF = "void dif_pass_kernel<2>(int const*, int*)"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>(int)"


def recorded():
    """A window of 1000 us: host ops, and on the card a field kernel,
    a torch kernel overlapping it, a copy, a primer launch before the
    window and an NCCL annotation over the torch kernel."""
    return [Ev(profile.RANGE, 1_000_000, 1_000_000, False),
            Ev("aten::add", 1_000_000, 300_000, False),
            Ev("cudaStreamSynchronize", 1_500_000, 400_000, False),
            Ev("void add_kernel(int)", 900_000, 5_000, True),
            Ev(DIF, 1_100_000, 100_000, True),
            Ev(ADD, 1_150_000, 100_000, True),
            Ev("nccl:all_reduce", 1_150_000, 100_000, True),
            Ev("Memcpy DtoH (Device -> Pinned)", 1_600_000, 50_000, True),
            Ev(ADD, 1_665_000, 10_000, True)]


def test_reduce_counts_only_the_window():
    r = profile.reduce(recorded())
    assert r["window_s"] == pytest.approx(1e-3)
    # Union: [1.10, 1.25] + [1.60, 1.65] + [1.665, 1.675] ms.
    assert r["busy_s"] == pytest.approx((150 + 50 + 10) * 1e-6)
    assert r["kernel_launches"] == 3
    assert r["field_kernel_s"] == pytest.approx(100e-6)
    ops = dict(r["device_ops"])
    assert ops["dif_pass_kernel"] == pytest.approx(100e-6)
    assert "nccl:all_reduce" not in ops


def test_idle_gaps_named_by_the_host_op_over_them():
    gaps = dict(profile.reduce(recorded())["idle_gaps"])
    assert gaps["aten::add"] == pytest.approx(100e-6)          # [1.0, 1.1]
    # [1.25, 1.6]: no host op over its middle; the tail [1.675, 2.0]
    # under the wait for the card.
    assert gaps["no host event"] == pytest.approx(350e-6)
    assert gaps[profile.SMALL_GAP_NAME] == pytest.approx(15e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(325e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 210e-6)


def test_no_window_no_numbers():
    assert profile.reduce(recorded()[1:]) == {}


def _rec(**kw):
    rec = {"completed": 4, "profiled_proofs": 4, "window_s": 2.0,
           "setup_s": 3.0,
           "field_least_s": 1e-4,
           "profile": {"window_s": 2.0, "busy_s": 0.5,
                       "kernel_launches": 400, "field_kernel_s": 8e-4}}
    rec.update(kw)
    return rec


def test_readers_on_a_record():
    rec = _rec(timings=[{"merkle #1 (P||D||B)": 1.0, "fri": 2.0, "lde": 5.0},
                        {"linear combination + merkle #2": 1.0,
                         "spot-check bundles": 1.0}],
               mesh={"seconds": {"a": 0.15, "b": 0.15}, "bytes": {"a": 3e6},
                     "proofs": 3},
               memory_peak_bytes=6_308_253_696,
               times=[1.0, 3.0, 2.0, 9.0, 9.0, 9.0, 9.0])
    read = {m: manifest.reader(m)(rec) for m in (
        "setup_s", "proofs_per_s", "proof_s", "memory_peak_gb",
        "proof_s.single", "field_roofline.batch",
        "launches_per_proof.single", "device_idle_pct.batch",
        "hash_stages_s.single", "collective_s.shard4",
        "collective_mb.shard4")}
    assert read == pytest.approx({
        "setup_s": 3.0, "proofs_per_s": 2.0, "proof_s": 0.5,
        "memory_peak_gb": 6.308253696, "proof_s.single": 2.0,
        "field_roofline.batch": 50.0, "launches_per_proof.single": 100.0,
        "device_idle_pct.batch": 75.0, "hash_stages_s.single": 2.5,
        "collective_s.shard4": 0.1, "collective_mb.shard4": 1.0})


def test_readers_without_anything_to_read_return_none():
    rec = _rec(profile={}, timings=[], mesh=None)
    assert readers.field_roofline(rec) is None
    assert readers.device_idle_pct(rec) is None
    assert readers.launches_per_proof(rec) is None
    assert readers.hash_stages_s(rec) is None
    assert readers.head_proof_s(rec) is None
    assert manifest.reader("memory_peak_gb")(rec) is None
    assert readers.mesh_total(rec, "bytes") is None


@pytest.mark.parametrize("seconds", [0.6, 0.2])
def test_a_traced_window_profiles_only_its_last_part(monkeypatch, seconds):
    """The profiled part is the last PROFILED_S; before it comes a head
    of one call at least, also where the window is shorter."""
    import time
    from portbench import drive
    monkeypatch.setattr(drive, "PROFILED_S", 0.3)
    calls, starts = [], []

    def step():
        calls.append(time.perf_counter())
        time.sleep(0.02)

    window_s, prof = drive.run_window(
        seconds, step, True, "cpu", on_trace_start=lambda: starts.append(
            len(calls)))
    assert window_s >= seconds
    assert len(starts) == 1 and 0 < starts[0] < len(calls)
    assert min(seconds, 0.3) <= prof["window_s"] < window_s


def test_an_untraced_window_has_no_profile():
    from portbench import drive
    starts = []
    window_s, prof = drive.run_window(0.05, lambda: None, False, "cpu",
                                      on_trace_start=lambda: starts.append(1))
    assert window_s >= 0.05 and prof == {} and starts == []


@pytest.mark.parametrize("cell, metrics", [
    ("mimc20.single", ["hash_stages_s.single"]),
    ("mimc20.shard4", ["collective_s.shard4", "collective_mb.shard4"])])
def test_traced_runs_time_stages_and_collectives_before_the_profiler(
        monkeypatch, cell, metrics):
    """A traced run asks for stage times and collective times in the
    window's unprofiled head, and for none under the profiler."""
    import time
    import _small
    from portbench import drive, runner
    from starks_tpu_torch import prover
    monkeypatch.setattr(drive, "PROFILED_S", 0.3)
    asked, profiling = [], []
    real_session, real_prove = profile.session, prover.mk_mimc_proof

    def session(*a, **k):
        profiling.append(True)
        return real_session(*a, **k)

    def prove(*a, **k):
        asked.append((bool(profiling), k.get("timings") is not None))
        return real_prove(*a, **k)
    monkeypatch.setattr(profile, "session", session)
    monkeypatch.setattr(prover, "mk_mimc_proof", prove)
    res = runner.run_cell(_small.small_cell(cell, check_claims=1),
                          2 ** 31 + 93, 0.6, True, "cpu", time.time())
    assert res["correct"]
    for m in metrics:
        assert res["metrics"][m]["value"] > 0
    if cell == "mimc20.single":
        assert (False, True) in asked and (True, True) not in asked
