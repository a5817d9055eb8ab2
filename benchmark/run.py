"""The benchmark of starks_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

runs the cell of BENCHMARK.json named CELL on the cards of this machine
(none present: exit 2, no result) and prints, as the last line of its
standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device and, traced, breakdown; each number that decided `correct`
comes last, under "checks", and again on standard error.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from portbench import card, manifest, runner  # noqa: E402

DEVICE = "cuda:0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.Cell(args.workload)
    try:
        card.require(cell.chips)
    except card.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    result = runner.run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), DEVICE, T_START)
    found = runner.forbidden_anywhere(result)
    if found:
        print(f"portbench: modules of JAX, the JAX package or the oracle "
              f"were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
