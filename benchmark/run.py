"""Run one cell of BENCHMARK.json on the card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (scene compile, kernel build, warm-up)
counts as `setup_s`; then the cell's jobs run back to back for `--seconds`
(with `--trace 1`, under torch.profiler, for the traffic's `trace_jobs`
jobs at most); then a sample of what the window produced is compared with
the plain reference (`benchmark/reference/`). The last line of standard
output is one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error and the result's last key.

The run fails (exit code 1, no result) without as many CUDA devices as the
cell asks for, or when a module of JAX or of the JAX package was loaded.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(ROOT / "build" / "torch_kernels")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def power_limit():
    """The card's power limit as nvidia-smi prints it, or None."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload, args.seed)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "power_limit": power_limit()}
    print(f"device: {device_info['kind']}, power limit {device_info['power_limit']}",
          file=sys.stderr, flush=True)
    try:
        result = harness.run_cell(cell, args.seconds, trace=bool(args.trace),
                                  t_start=harness.process_start_time(), device_info=device_info)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    bad = harness.forbidden_loaded()
    if bad:
        print(f"the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
