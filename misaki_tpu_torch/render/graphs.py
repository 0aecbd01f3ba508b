"""A scene's work step captured as one CUDA graph and replayed: a path chunk
(`render/driver.py`) or a photon-mapping iteration (`render/ppm.py`).

A step whose shapes and launch arguments depend on nothing but the scene's
configuration can be captured once and replayed for every later step: the
same kernels in the same order, launched by the device from one host call
instead of one by one from Python, so the result is the eager step's to the
bit. What changes from step to step (a chunk's first lane, a seed's words)
is read from a small int64 input buffer, whose (1,) views the step's torch
ops broadcast to the same bits as the Python ints of the eager step. After
the words the buffer holds the graph's own device counters
(`tracing.recording`), which each replay's input row zeroes.

A scene holds at most one graph of each kind, in its `__dict__` (the
compiled scene is a frozen dataclass), with the graph's private memory
pool; one captured under another key is dropped. The key names everything
the capture baked in, and every tensor of the scene's tables by address
and shape, so a table replaced in the scene captures anew.
"""

import dataclasses
from typing import Any, NamedTuple

import torch

from misaki_tpu_torch.utils import tracing


def table_key(x, out):
    """Append (data_ptr, shape) of every tensor of a scene's tables to
    `out`: a table replaced in place of another changes it."""
    if isinstance(x, torch.Tensor):
        out.append((x.data_ptr(), tuple(x.shape)))
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            table_key(getattr(x, f.name), out)
    return out


class Graph(NamedTuple):
    """One captured step of a scene under `key`: it reads its words from
    `inputs` and writes `out` (the tensors it owns) in place; `rec` is what
    its Python added (`tracing.Recording`)."""
    key: tuple
    graph: Any
    out: Any
    inputs: Any
    rec: Any

    def replay(self, row):
        """Run the step of input row `row`: its words, then zeros for the
        counter slots (on the device, or in pinned host memory)."""
        self.inputs.copy_(row, non_blocking=True)
        self.graph.replay()
        tracing.replayed(self.rec)


def cached(scene, attr, key):
    """The scene's graph `attr` if it was captured under `key`; one under
    another key is dropped."""
    graph = scene.__dict__.get(attr)
    if graph is not None and graph.key != key:
        del scene.__dict__[attr]
        graph = None
    return graph


def capture(scene, attr, key, n_words, device, step, replays):
    """Capture `step(words)`, which runs the step on `n_words` (1,) int64
    words and returns the tensors it writes, as a CUDA graph on `device`;
    cache it with the scene as `attr` and return it. Each replay adds 1 to
    the host counter `replays`. Call it after an eager step of the scene,
    so that the kernels are built, their settings made and the device
    tables cached: capturing runs nothing."""
    inputs = torch.zeros(n_words + len(tracing.DEVICE_COUNTERS), dtype=torch.int64,
                         device=device)
    words = tuple(inputs[i:i + 1] for i in range(n_words))
    cuda_graph = torch.cuda.CUDAGraph()
    with tracing.recording(inputs[n_words:]) as rec, \
            torch.cuda.graph(cuda_graph, capture_error_mode="thread_local"):
        out = step(words)
        tracing.add(replays, 1)
    graph = Graph(key, cuda_graph, out, inputs, rec)
    scene.__dict__[attr] = graph
    return graph
