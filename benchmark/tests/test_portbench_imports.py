"""Nothing the benchmark loads is JAX, the JAX package or the oracle,
by top-level module name compared whole (the program's name,
starks_tpu_torch, begins with the JAX package's); the reference loads
nothing of the program either."""

import importlib.util
import json
import subprocess
import sys
import types

import pytest

import _small
from portbench import manifest

HARNESS = ["portbench", "portbench.bound", "portbench.card",
           "portbench.check", "portbench.drive", "portbench.manifest",
           "portbench.profile", "portbench.readers", "portbench.runner",
           "portbench.drivers.batch", "portbench.drivers.single",
           "portbench.drivers.sharded", "refstark", "starks_tpu_torch",
           "starks_tpu_torch.parallel.launch"]


def _top_level_loaded(modules, readers=False) -> set:
    code = ("import importlib, json, sys\n"
            f"sys.path[:0] = [{str(manifest.BENCH)!r}, "
            f"{str(manifest.ROOT)!r}]\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n")
    if readers:
        code += ("from portbench import manifest\n"
                 "for m in manifest.load()['end_to_end'] + "
                 "manifest.load()['per_layer']:\n"
                 "    manifest.reader(m['name'])\n")
    code += ("print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         cwd=str(manifest.ROOT))
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_harness_and_readers_load_no_jax():
    loaded = _top_level_loaded(HARNESS, readers=True)
    assert "starks_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "starks_tpu", "oracle"}


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level_loaded(["refstark"])
    assert "refstark" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "starks_tpu",
                         "starks_tpu_torch", "oracle"}


def test_forbidden_loaded_compares_whole_names(monkeypatch):
    from portbench import runner
    monkeypatch.setitem(sys.modules, "starks_tpu_torchx", sys)
    assert runner.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "starks_tpu.fake", sys)
    assert runner.forbidden_loaded() == ["starks_tpu"]


@pytest.mark.parametrize("rank_main, code", [
    (None, 0), (_small.rank_loading_jax, 3)])
def test_sharded_ranks_report_what_they_loaded(monkeypatch, capsys,
                                               rank_main, code):
    """run.py on the sharded cell (the look for a card skipped, at a small
    size on the CPU): every rank names what it loaded once the window
    has closed, and a rank that loaded JAX leaves the run without a
    result."""
    from portbench.drivers import sharded
    spec = importlib.util.spec_from_file_location(
        "portbench_run", manifest.BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setattr(run, "DEVICE", "cpu")
    monkeypatch.setattr(run.card, "require", lambda count: None)
    monkeypatch.setattr(run, "manifest", types.SimpleNamespace(
        Cell=lambda name: _small.small_cell(name, check_claims=1)))
    if rank_main:
        monkeypatch.setattr(sharded, "rank_main", rank_main)
    assert run.main(["--workload", "mimc20.shard4", "--seed",
                     str(2 ** 31 + 91), "--seconds", "0.5",
                     "--trace", "0"]) == code
    out, err = capsys.readouterr()
    if code:
        assert out.strip() == ""
        assert "jax (rank 0)" in err and "jax (rank 3)" in err
    else:
        assert json.loads(out.strip().splitlines()[-1])["correct"]
