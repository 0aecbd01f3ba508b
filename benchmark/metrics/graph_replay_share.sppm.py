"""graph_replay_share.sppm: of the photon-mapping iterations the traced
window ran (the program's counter `ppm.iterations`), the share that ran as a
replay of a captured CUDA graph (`ppm.graph.replays`), which the host
launches at once, rather than op by op from the host. None where the program
has no such counters or ran no iteration."""

from benchmark import program_spans as ps


def read(run):
    c = ps.counts()
    if c is None or not c.get("ppm.iterations"):
        return None
    return c.get("ppm.graph.replays", 0) / c["ppm.iterations"]
