"""The reader of `graph_replay_share.sppm` (benchmark/metrics/) on synthetic
counter dicts: replays over iterations, and None where the program counts
no iteration or has no such counters (a program older than the counters)."""

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
