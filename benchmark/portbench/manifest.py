"""BENCHMARK.json and the files it names, found by name.

A cell is an entry of `workloads`; its configuration is the file its
`configs` entry names, its traffic the data file
benchmark/traffic/<traffic>.json, which names the module
(benchmark/portbench/drivers/<driver>.py) that runs it; each metric is
read by benchmark/metrics/<metric name>.py. A later cell, configuration,
traffic mix or metric is a new file and a new entry: nothing here names
one.
"""

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One workload with its configuration, traffic and metrics."""

    def __init__(self, name: str, bench: dict = None, root: Path = ROOT):
        bench = bench or load(root)
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.chips = name, entry["chips"]
        conf = next(c for c in bench["configs"]
                    if c["name"] == entry["config"])
        self.config = json.loads((root / conf["file"]).read_text())
        self.traffic = json.loads(
            (BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)
                          and m["moves"] in e2e]

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")


def reader(metric: str):
    """The `read(record)` function of benchmark/metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
