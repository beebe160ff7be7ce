"""The control of a cell: the reference one precision lower, in the
program's place.

    python3 -m portbench.control --workload <cell> --seed <n> [--seed <n> ...]

For each seed this computes, with the plain reference in bfloat16, what the
program would produce in a run of that seed (the kind's `control_numbers`:
a sweep's first request, a trading cell's first ticks) and hands it to the
same judgement a run makes.  Every line printed is one seed's numbers
beside the cell's limits; a sound limit is failed by at least one number
on every seed.  No run of the benchmark runs this;
`portbench/tests/test_portbench_control.py` does, small on the CPU and at
the cell's size on the card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys


def control_numbers(spec: dict, seed: int, device: str) -> dict:
    kind = importlib.import_module(f"portbench.kinds.{spec['config']['kind']}")
    return kind.control_numbers(kind.Cell(spec["config"], spec["traffic"], seed, device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import run

    spec = run.load_cell(args.workload)
    limits = spec["config"]["limits"]
    for seed in args.seed:
        numbers = control_numbers(spec, seed, args.device)
        failed = sorted(k for k, v in numbers.items() if not v <= limits.get(k, -1.0))
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers,
                          "limits": limits, "fails": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
