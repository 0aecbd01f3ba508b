"""The traced window: torch.profiler over the cell's jobs, its Chrome trace
written into the checkout and read back into device intervals, kernel
launches and host spans for the per-layer readers.

Device busy time is the union of the intervals in which a kernel, a memcpy
or a memset ran, clipped to the window: the `bench.window` span, which the
harness opens around the traced jobs. Each job ends with its result in host
memory, so no device work of the window runs past it.
"""

import json
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench.window"
JOB = "bench.job"


def span(name):
    """A host span of the benchmark's own (a user annotation in the trace)."""
    return torch.profiler.record_function(name)


def trace_path(cell):
    """The trace file of the cell's traced run, at a fixed path in the
    checkout (each traced run of the cell overwrites it)."""
    return Path(cell.root) / "build" / "benchmark" / "traces" / f"{cell.name}.trace.json"


class Tracer:
    """Profiles the block (CPU ops and CUDA activity, no shapes, stacks or
    memory), inside a `bench.window` span, and exports the trace."""

    def __init__(self, cell):
        self.cell = cell
        self.path = trace_path(cell)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cell.device.startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                           with_stack=False, profile_memory=False)
        self._span = None

    def __enter__(self):
        self.prof.__enter__()
        self._span = span(WINDOW)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.path))
        return False

    def result(self):
        with open(self.path) as f:
            return Trace(json.load(f)["traceEvents"])


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Trace:
    """The events of one traced window. Times in microseconds as the trace
    gives them; the properties in seconds."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW]
        if not win:
            raise ValueError(f"the trace holds no '{WINDOW}' span")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.host_tid = win[0].get("tid")
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS
                       and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = [e for e in xs if e.get("cat") in HOST_CATS]
        self.runtime = [e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        self.jobs = [e for e in xs if e.get("name") == JOB]

    def _clipped(self, evs):
        return [(max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1))
                for e in evs]

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self):
        return union_length(self._clipped(self.device)) * 1e-6

    def kernel_seconds(self, match):
        """Summed device time of the kernels whose name `match` accepts."""
        return sum(float(e["dur"]) for e in self.kernels if match(e["name"])) * 1e-6

    def kernels_launched_within(self, prefix):
        """The kernels whose launch (a runtime call, linked by its
        correlation id) lies inside a host op whose name starts with
        `prefix`, on the same thread."""
        ranges = {}
        for e in self.host:
            if e["name"].startswith(prefix):
                ranges.setdefault(e.get("tid"), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for v in ranges.values():
            v.sort()
        inside = set()
        for r in self.runtime:
            corr = r.get("args", {}).get("correlation")
            spans = ranges.get(r.get("tid"), ())
            t = float(r["ts"])
            if corr is not None and any(s <= t <= e for s, e in spans):
                inside.add(corr)
        return [k for k in self.kernels if k.get("args", {}).get("correlation") in inside]

    def idle_gaps(self):
        """(start, end) of each interval of the window in which no device op
        ran, longest first."""
        gaps, cur = [], self.t0
        for s, e in sorted(self._clipped(self.device)):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < self.t1:
            gaps.append((cur, self.t1))
        return sorted(gaps, key=lambda g: g[0] - g[1])

    def host_op_at(self, t):
        """The innermost host op or span of the window's thread running at
        time t (the shortest that covers it)."""
        best = None
        for e in self.host:
            if e.get("tid") != self.host_tid or e["name"] == WINDOW:
                continue
            s = float(e["ts"])
            if s <= t <= s + float(e["dur"]) and (best is None or e["dur"] < best["dur"]):
                best = e
        return best["name"] if best is not None else "host: outside any op"

    def breakdown(self, top=10):
        """{"device_ops": the `top` device ops by summed time, "idle_gaps":
        the `top` longest idle gaps, each named by the host op that ran at
        its middle} as [name, seconds] lists."""
        by_name = {}
        for e in self.device:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = [[self.host_op_at(0.5 * (s + e)), (e - s) * 1e-6]
                for s, e in self.idle_gaps()[:top]]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}
