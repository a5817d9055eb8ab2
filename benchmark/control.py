"""The control of `correct`: the program with one guarantee of the
configuration broken, in the program's place, which every check has to
find not correct.

    python3 benchmark/control.py --workload CELL --seconds S SEED [SEED ...]

runs the cell's window once per seed (a short window at the cell's own
load: each run proves and compares as many claims as a run of the
benchmark does) with the program's protocol changed by CONTROL: half
the spot checks the configuration states, the step that would tempt a
prover to save work. It prints each seed's numbers compared and a last
line of JSON with every run's. The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from portbench import card, manifest, runner  # noqa: E402


def control_overrides(cfg: dict) -> dict:
    return {"spot_checks": cfg["spot_checks"] // 2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    cell = manifest.Cell(args.workload)
    card.require(cell.chips)
    runs = []
    for seed in args.seeds:
        res = runner.run_cell(cell, seed, args.seconds, False, "cuda:0",
                              time.time(), control_overrides(cell.config))
        runs.append({"seed": seed, "correct": res["correct"],
                     "checks": res["checks"]})
        print(f"control {args.workload} seed {seed}: correct "
              f"{res['correct']}, " + ", ".join(
                  f"{k} {v['value']}" for k, v in res["checks"].items()),
              flush=True)
    print(json.dumps({"workload": args.workload, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
