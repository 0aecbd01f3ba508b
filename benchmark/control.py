"""The control of a cell's check: the cell's comparison with the reference
put in the program's place, computed in TF32 (or, for a gradient-step cell,
with a fault planted in it), at the cell's own size, on the seeds given.
One JSON line a seed: {"workload", "seed", "fault", "numbers", "seconds"}.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 [--fault half_batch]

The benchmark's own runs never run it; its readings set the upper end of
each limit in benchmark/limits/ (PERF.md).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from benchmark import harness

    for seed in args.seeds:
        cell = harness.load_cell(ROOT, args.workload, seed, device=args.device)
        job = harness.job_module(cell)
        t0 = time.perf_counter()
        numbers = job.control(cell, **({"fault": args.fault} if args.fault else {}))
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "numbers": numbers, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
