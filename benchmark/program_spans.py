"""The program's own spans and counters in a traced run, for the per-layer
readers.

Spans: the `misaki.*` user annotations that misaki_tpu_torch/utils/tracing.py
records while a profiler runs, taken on the thread that opened the
`bench.window` span and clipped to the window. A layer's host time is the
time inside its span and inside none of the spans of the layers below it,
summed over the window. The names are copied here, so that no later change
to the program moves what a reader measures.

Counters: `misaki_tpu_torch.utils.tracing.read()` after the window, which
covers exactly the traced window's profiler session.

A program without these spans or counters gives None, never an error.
"""

FRAME = "misaki.frame"
CHUNK = "misaki.chunk"
BOUNCE = "misaki.bounce"
CAST = "misaki.cast"
DENSITY = "misaki.density"


def merged(intervals):
    """Sorted, disjoint (start, end) covering the same points as
    `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def minus(a, b):
    """The length of the points of disjoint sorted `a` that lie in none of
    disjoint sorted `b`."""
    total, j = 0.0, 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                total += b[k][0] - cur
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            total += e - cur
    return total


def spans(trace, *names):
    """Disjoint sorted (start, end) in microseconds covered by the spans
    `names` on the window's host thread, clipped to the window."""
    out = []
    for e in trace.host:
        if (e.get("cat") == "user_annotation" and e["name"] in names
                and e.get("tid") == trace.host_tid):
            s, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            s, end = max(s, trace.t0), min(end, trace.t1)
            if end > s:
                out.append((s, end))
    return merged(out)


def host_ms(run, name, lower=()):
    """ms a job on the window's host thread inside span `name` and inside
    none of the spans `lower`; None without a `name` span."""
    t = run.trace
    if t is None or not run.jobs_traced:
        return None
    a = spans(t, name)
    if not a:
        return None
    b = spans(t, *lower) if lower else []
    return minus(a, b) * 1e-3 / run.jobs_traced


def counts():
    """The program's counters of the traced window, {name: int}, or None
    where the program has none."""
    try:
        from misaki_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.read()
