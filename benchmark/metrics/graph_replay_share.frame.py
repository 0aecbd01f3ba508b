"""graph_replay_share.frame: of the path chunks the traced window rendered
(the program's counter `path.chunks`), the share that ran as a replay of a
captured CUDA graph (`path.graph.replays`), which the host launches at once,
rather than op by op from the host. None where the program has no such
counters or rendered no chunk."""

from benchmark import program_spans as ps


def read(run):
    c = ps.counts()
    if c is None or not c.get("path.chunks"):
        return None
    return c.get("path.graph.replays", 0) / c["path.chunks"]
