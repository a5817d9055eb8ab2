"""BENCHMARK.json and every file it names load by name, and keep the
benchmark's own rules."""

import json
import re

import pytest

from portbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_are_plain_and_unique():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = manifest.Cell(cell)
    assert c.chips in (1, 4)
    assert c.config["reduced"] == []
    assert c.driver().run
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_lists_every_metric_meant_for_it(cell):
    c = manifest.Cell(cell)
    listed = {m["name"] for m in BENCH["per_layer"]
              if cell in m.get("workloads", [])}
    assert listed == {m["name"] for m in c.per_layer}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(manifest.reader(metric))


@pytest.mark.parametrize("conf", BENCH["configs"])
def test_config_file_matches_its_entry(conf):
    cfg = json.loads((manifest.ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"]
    assert cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    assert cfg["round_constants"] == [(i ** 7) ^ 42 for i in range(64)]
    assert int(cfg["modulus"]) == 2 ** 256 - 351 * 2 ** 32 + 1


def test_at_most_one_cell_on_four_chips():
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
