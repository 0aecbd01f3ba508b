"""The readers of `graph_replay_share.sppm` and `graph_replay_share.frame`
(benchmark/metrics/) on synthetic counter dicts: replays over iterations or
chunks, and None where the program counts none or has no such counters (a
program older than the counters)."""

from pathlib import Path

import pytest

from benchmark import harness
from benchmark import program_spans as ps

BENCH = Path(harness.__file__).parent


@pytest.fixture
def reader():
    return harness.load_module(BENCH / "metrics" / "graph_replay_share.sppm.py",
                               "t_graph_replay_share_sppm")


class Run:
    trace, jobs_traced = None, 0


@pytest.mark.parametrize("counts,want", [
    ({"ppm.iterations": 16, "ppm.graph.replays": 16}, 1.0),
    ({"ppm.iterations": 16, "ppm.graph.replays": 14}, 0.875),
    ({"ppm.iterations": 8, "ppm.graph.replays": 0}, 0.0),
    ({"ppm.iterations": 8}, 0.0),
    ({"ppm.iterations": 0, "ppm.graph.replays": 0}, None),
    ({"cast.closest.rays": 100, "density.photons": 5}, None),
    ({}, None),
    (None, None),
])
def test_replays_over_iterations(reader, monkeypatch, counts, want):
    monkeypatch.setattr(ps, "counts", lambda: counts)
    assert reader.read(Run) == want


@pytest.fixture
def frame_reader():
    return harness.load_module(BENCH / "metrics" / "graph_replay_share.frame.py",
                               "t_graph_replay_share_frame")


@pytest.mark.parametrize("counts,want", [
    ({"path.chunks": 16, "path.graph.replays": 16}, 1.0),
    ({"path.chunks": 8, "path.graph.replays": 6}, 0.75),
    ({"path.chunks": 4, "path.graph.replays": 0}, 0.0),
    ({"path.chunks": 4}, 0.0),
    ({"path.chunks": 0, "path.graph.replays": 0}, None),
    ({"ppm.iterations": 8, "ppm.graph.replays": 8}, None),
    ({"cast.closest.rays": 100}, None),
    ({}, None),
    (None, None),
])
def test_replays_over_chunks(frame_reader, monkeypatch, counts, want):
    monkeypatch.setattr(ps, "counts", lambda: counts)
    assert frame_reader.read(Run) == want
