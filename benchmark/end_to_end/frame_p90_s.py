"""frame_p90_s: the 90th percentile of the latencies of every frame in the
window (statistics.quantiles, n=10); reported in cells that complete 100
frames or more, so that ten lie beyond it."""

import statistics


def read(run):
    if run.jobs < 2:
        return None
    return statistics.quantiles(run.latencies, n=10)[8]
