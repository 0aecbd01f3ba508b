"""The harness: one cell of BENCHMARK.json, from set-up through the measured
window to the check against the plain reference.

Everything that belongs to one configuration, traffic mix or metric is found
by its name: `configs/<name>.json` (through BENCHMARK.json's `file`),
`traffic/<name>.json`, whose `kind` names the job module `jobs/<kind>.py`,
`limits/<workload>.json` (the limit of each number the check compares),
`end_to_end/<metric>.py` and `metrics/<metric>.py`. A later cell, traffic
mix or metric is added as new files and entries; no file here changes.
"""

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "misaki_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The module in file `path`: metric names hold dots, so readers are
    loaded by path, not imported by name."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of the spec, with its configuration, traffic and limits
    loaded, and the run's seed and device."""
    root: Path            # the checkout: BENCHMARK.json and the `paths`
    bench: Path           # the benchmark's folder
    spec: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: str = "cuda"

    @property
    def name(self):
        return self.workload["name"]

    def path(self, rel):
        """A path of the config or traffic files, relative to the checkout."""
        return str(self.root / rel)

    def metrics(self, section):
        """The entries of `end_to_end` or `per_layer` this cell reports: those
        whose `workloads` list it; without that key, every cell's (a
        per-layer metric: every cell that reports its `moves`)."""
        if section == "end_to_end":
            return [m for m in self.spec[section] if self.name in m.get("workloads", [self.name])]
        e2e = {m["name"] for m in self.metrics("end_to_end")}
        return [m for m in self.spec[section]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def load_cell(root, workload, seed, device="cuda"):
    """The cell named `workload` of `root`/BENCHMARK.json."""
    root = Path(root)
    bench = root / "benchmark"
    spec = load_json(root / "BENCHMARK.json")
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload '{workload}' in {root / 'BENCHMARK.json'}")
    w = found[0]
    cfg_entry = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    return Cell(root=root, bench=bench, spec=spec, workload=w,
                config=load_json(root / cfg_entry["file"]),
                traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(bench / "limits" / f"{workload}.json"),
                seed=int(seed), device=device)


def job_module(cell):
    return load_module(cell.bench / "jobs" / f"{cell.traffic['kind']}.py",
                       f"benchmark_job_{cell.traffic['kind']}")


def reader(cell, section, name):
    """The reader of metric `name`: `end_to_end/<name>.py` or
    `metrics/<name>.py`, each with `read(run)` -> a number or None."""
    folder = "end_to_end" if section == "end_to_end" else "metrics"
    return load_module(cell.bench / folder / f"{name}.py",
                       f"benchmark_{folder}_{name.replace('.', '_')}")


def forbidden_loaded(modules=None):
    """The modules whose top-level name, taken whole, is one the program may
    not load."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_MODULES)


def process_start_time():
    """The wall-clock time this process started, from /proc (Linux)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


@dataclass
class Run:
    """What a run measured, for the readers."""
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies: list = field(default_factory=list)   # seconds of each whole job
    peak_window_bytes: int = 0
    trace: object = None                            # tracing.Trace of a traced run
    jobs_traced: int = 0

    @property
    def jobs(self):
        return len(self.latencies)


def check_numbers(cell, numbers):
    """-> (correct, [(name, value, limit)]): each number at most its limit
    (a NaN fails)."""
    rows = []
    for name, value in numbers.items():
        limit = cell.limits[name]
        rows.append((name, value, limit))
    correct = bool(rows) and all(v <= lim for _, v, lim in rows)
    return correct, rows


def run_cell(cell, seconds, trace=False, t_start=None, device_info=None, err=None):
    """Set up, measure, check; returns the result's dict (the last line a run
    prints). `device_info`: the dict for the result's `device`, without the
    peak; None on the CPU, where the tests drive this."""
    import torch

    err = err or (lambda line: print(line, file=sys.stderr, flush=True))
    t_start = time.time() if t_start is None else t_start
    job = job_module(cell)
    on_cuda = cell.device.startswith("cuda")

    state = job.setup(cell)
    if on_cuda:
        torch.cuda.synchronize()
    run = Run(cell=cell, setup_s=time.time() - t_start)
    setup_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()

    if trace:
        from benchmark import tracing

        max_jobs = int(cell.traffic["trace_jobs"])
        max_s = min(float(cell.traffic["trace_seconds"]), seconds)
        with tracing.Tracer(cell) as tracer:
            w0 = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                with tracing.span("bench.job"):
                    job.step(state, len(run.latencies))
                run.latencies.append(time.perf_counter() - t0)
                if len(run.latencies) >= max_jobs or time.perf_counter() - w0 >= max_s:
                    break
            run.window_s = time.perf_counter() - w0
        run.trace = tracer.result()
        run.jobs_traced = run.jobs
    else:
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            t0 = time.perf_counter()
            job.step(state, len(run.latencies))
            run.latencies.append(time.perf_counter() - t0)
        run.window_s = time.perf_counter() - w0
    run.peak_window_bytes = torch.cuda.max_memory_allocated() if on_cuda else 0

    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"the run loaded forbidden modules: {', '.join(bad)}")

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(section):
        value = reader(cell, section, m["name"]).read(run)
        if value is None:
            if section == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m['name']} found nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    numbers = job.check(state, cell, run)
    err(f"reference check: {time.perf_counter() - t_check:.1f} s")
    correct, rows = check_numbers(cell, numbers)
    result = {"correct": correct, "attempted": run.jobs, "failed": 0,
              "metrics": metrics}
    if device_info is not None:
        result["device"] = dict(device_info, memory_peak_bytes=max(setup_peak,
                                                                   run.peak_window_bytes))
        if trace:
            result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    if trace:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    for name, v, lim in rows:
        err(f"check {name} = {v!r} (limit {lim!r})" + ("" if v <= lim else "  FAILED"))
    err(f"correct = {correct}")
    return result

