"""benchmark/run.py as the benchmark runs it: without a card it exits
with an error and prints no result; on the card a short run of each
one-chip cell prints a correct result line."""

import json
import subprocess
import sys

import pytest

from portbench import manifest

RUN = str(manifest.BENCH / "run.py")


def _run(cell, seconds, trace=0):
    return subprocess.run(
        [sys.executable, RUN, "--workload", cell, "--seed", str(2 ** 31 + 5),
         "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=str(manifest.ROOT))


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run("mimc16.batch", 1)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA card" in res.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell", ["mimc16.batch", "mimc20.single"])
def test_a_short_run_on_the_card(card, cell):
    res = _run(cell, 2, trace=1)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0 and list(out)[-1] == "checks"
