"""Readings the limits of ``correct`` are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 12 --first <seed>

Sets the cell's load up once, then for each seed takes request 0 of a run
of that seed: the numbers compared for the program's answer, and for the
load's control (the answer, or the reference, in the precision below the
configuration's). Prints one JSON line a seed and, last, each number's
largest reading over the program's answers (the lower reading) and
smallest over the controls (the upper one). Runs on the card; at cell size.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.run import Cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--controls", type=int, default=None,
                    help="run the control on the first N seeds only (default: all)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    load = cell.load(args.first, "cuda")
    load.setup()
    lower, upper = {}, {}
    for j in range(args.seeds):
        seed = args.first + 7919 * j
        with_control = args.controls is None or j < args.controls
        got, control = load.calibrate(seed, control=with_control)
        for name, v in got.items():
            lower[name] = max(lower.get(name, float("-inf")), v)
        for name, v in (control or {}).items():
            upper[name] = min(upper.get(name, float("inf")), v)
        print(json.dumps({"seed": seed, "answer": got, "control": control}), flush=True)
    load.finish()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
