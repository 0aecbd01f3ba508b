"""The port's spans and counters, read from a torch.profiler trace, and the
host counts of the hand-written kernels' launches.

Tracing is on exactly while a torch.profiler session runs, as
`torch.autograd._profiler_enabled()` reports: any `torch.profiler.profile`
turns it on (a benchmark's traced window, an operator's own), and nothing
else does. Then

* `span(name)` is a `torch.profiler.record_function`, so each span lands in
  the session's trace as a `user_annotation` event of the thread that
  opened it, on the clock of the device's kernels. With no profiler
  running it returns one shared no-op context manager: an untraced frame
  pays one check a span, and no allocation or device work.
* the counters count. A host counter is an int the host adds to, where it
  knows the value. A device counter is a slot of one int64 buffer a device,
  which the kernels that already read the data add to (one atomic add a
  block, where the pointer they are given is not null); on the CPU the plain
  twins count the same with torch ops. The first span or count under a
  newly started session zeroes them all; a device's buffer is allocated at
  its first use in the session, the one launch that counting adds. A new
  session is seen where the profiler is found running after a span, a count
  or `read()` found it stopped, so two sessions with none of these between
  them count as one. `read()` gives the counts of the current or last
  session as host ints, after one copy a device.

Spans, one a layer boundary:

  misaki.frame    a whole frame: `render_ppm`, and `driver.render` after its
                  hand-off to `render_ppm` (one a frame)
  misaki.chunk    a chunk of lanes (`driver._render_chunk`); in a training
                  step, the forward
  misaki.bounce   an iteration of a bounce or depth loop (the integrators'
                  `sample_path`, `sample_direct`, `sample_volpath`; ppm's
                  camera and photon passes)
  misaki.cast     a closest-hit or any-hit cast (`traverse.intersect`,
                  `ray_test`): the rays' packing, the launch, the unpacking
  misaki.density  a density estimate (`ppm.density_estimate`,
                  `_density_glossy`): packing, workspace and launches
  misaki.film_sum the sum of a rank's film over the ranks
                  (`parallel/sharding.py` `mesh_sum` in a sharded frame)

On a frame's host thread casts and estimates lie in bounce spans or directly
in the frame, so the frame's time splits into entry (the frame outside any
bounce, cast or estimate), bounces (outside casts and estimates), casts and
estimates.

Counters:

  cast.closest.rays       host: the rays of each closest-hit cast, unpadded
  cast.closest.live       device: those with maxt >= mint (dead lanes and
                          the pad carry mint 0, maxt -1)
  cast.closest.nodes      device: the inner BVH2 nodes those rays visit (each
                          slab-tests its two children), counted by the CUDA
                          kernel alone (the CPU twin walks no BVH2)
  cast.closest.faces      device: the faces those rays run Moller-Trumbore
                          on, counted as cast.closest.nodes is
  density.photons         host: P of each estimate
  density.visible_points  host: L of each estimate
  density.alive           device: photons alive (the estimate's keys pass)
  density.contributing    device: photons alive with wi . n > 0
  density.live            device: visible points valid and not glossy (the
                          gather), each once
  ppm.iterations          host: photon-mapping iterations, eager or replayed
  ppm.graph.replays       host: the iterations that ran as a replay of a
                          captured CUDA graph (`render/ppm.py`)
  path.chunks             host: the chunks of lanes `driver._render_chunk`
                          renders, eager or replayed
  path.graph.replays      host: the chunks that ran as a replay of a
                          captured CUDA graph (`render/driver.py`)
  rng.floats              host: the floats each PCG32 group of draws drew
                          (`core/rng.py` `next_floats`, its k)
  rng.kernel.floats       host: those of them the PCG32 kernel drew
  shard.ranks             host: the ranks of each sharded frame
  shard.lanes             host: this rank's lanes of each sharded frame
  shard.film_sum.bytes    host: the bytes each all-reduce of a sharded
                          frame's film sums

A CUDA graph runs no Python, so what the Python of its one captured
iteration or chunk adds is recorded: under `recording(slots)` the host
counts and the launches go to the `Recording`, not to the session or
`launches`, and the kernels add to the graph's own device counters `slots`
(zeroed by whoever replays the graph, before each replay). `replayed(rec)`,
after each replay, adds the recorded launches to `launches` and, while
tracing is on, the recorded host counts and the graph's device counters to
the session.

`launches` is always on, and not zeroed by a session: the launches of each
hand-written kernel in the process ("closest", "anyhit", "fetch",
"fetch_bwd"; "density", one a density estimate, and "density_cuda", the
CUDA kernels those estimates enqueued; "pcg32", one a seeding or a group
of draws).
"""

import contextlib

import torch

FRAME = "misaki.frame"
CHUNK = "misaki.chunk"
BOUNCE = "misaki.bounce"
CAST = "misaki.cast"
DENSITY = "misaki.density"
FILM_SUM = "misaki.film_sum"

CAST_RAYS = "cast.closest.rays"
CAST_LIVE = "cast.closest.live"
CAST_NODES = "cast.closest.nodes"
CAST_FACES = "cast.closest.faces"
DENSITY_PHOTONS = "density.photons"
DENSITY_VPS = "density.visible_points"
DENSITY_ALIVE = "density.alive"
DENSITY_CONTRIBUTING = "density.contributing"
DENSITY_LIVE = "density.live"
PPM_ITERATIONS = "ppm.iterations"
PPM_REPLAYS = "ppm.graph.replays"
PATH_CHUNKS = "path.chunks"
PATH_REPLAYS = "path.graph.replays"
RNG_FLOATS = "rng.floats"
RNG_KERNEL_FLOATS = "rng.kernel.floats"
SHARD_RANKS = "shard.ranks"
SHARD_LANES = "shard.lanes"
SHARD_FILM_SUM_BYTES = "shard.film_sum.bytes"

HOST_COUNTERS = (CAST_RAYS, DENSITY_PHOTONS, DENSITY_VPS, PPM_ITERATIONS, PPM_REPLAYS,
                 PATH_CHUNKS, PATH_REPLAYS, RNG_FLOATS, RNG_KERNEL_FLOATS, SHARD_RANKS,
                 SHARD_LANES, SHARD_FILM_SUM_BYTES)
# the device buffer's slots, in this order; the density kernel takes the
# address of DENSITY_ALIVE and writes that slot and the next two, the
# closest-hit kernel that of CAST_NODES and writes it and the next
DEVICE_COUNTERS = (CAST_LIVE, DENSITY_ALIVE, DENSITY_CONTRIBUTING, DENSITY_LIVE, CAST_NODES,
                   CAST_FACES)
COUNTERS = HOST_COUNTERS + DEVICE_COUNTERS

launches = dict.fromkeys(("closest", "anyhit", "fetch", "fetch_bwd", "density",
                          "density_cuda", "pcg32"), 0)

_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


class _Session:
    """The counts of the current or last profiler session."""

    def __init__(self):
        self.running = False            # a profiler was running at the last look
        self.host = dict.fromkeys(COUNTERS, 0)
        self.buffers = {}               # device -> int64 (len(DEVICE_COUNTERS),)


_session = _Session()


class Recording:
    """What the Python of one captured CUDA graph adds, replayed with it:
    `host` counts, `launches`, and `slots`, the graph's own device counters
    (an int64 tensor of len(DEVICE_COUNTERS) on the graph's device)."""

    def __init__(self, slots):
        self.slots = slots
        self.host = dict.fromkeys(COUNTERS, 0)
        self.launches = dict.fromkeys(launches, 0)


_recording = None


def enabled():
    """Whether a profiler session is running; the first look under a new
    session zeroes the counts."""
    if not _profiler_enabled():
        _session.running = False
        return False
    if not _session.running:
        _session.host = dict.fromkeys(COUNTERS, 0)
        _session.buffers = {}
        _session.running = True
    return True


def span(name):
    """A span of the trace named `name` (one of the constants above); the
    shared no-op where no profiler runs."""
    if not enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def add(name, n):
    """Add `n` (an int, or a CPU tensor that holds one) to counter `name`,
    while tracing is on; while recording, to the recording."""
    if _recording is not None:
        _recording.host[name] += int(n)
    elif enabled():
        _session.host[name] += int(n)


def _buffer(device):
    """The session's device counters on `device`, allocated at first use."""
    buf = _session.buffers.get(device)
    if buf is None:
        buf = torch.zeros(len(DEVICE_COUNTERS), dtype=torch.int64, device=device)
        _session.buffers[device] = buf
    return buf


def _address(buf, name):
    return buf.data_ptr() + buf.element_size() * DEVICE_COUNTERS.index(name)


def device_counter(device, name):
    """The address of device counter `name` on `device` for a kernel to add
    to, or None while tracing is off (the kernel then counts nothing); while
    recording, the address of the recording's slot, traced or not."""
    if _recording is not None:
        return _address(_recording.slots, name)
    if not enabled():
        return None
    return _address(_buffer(device), name)


@contextlib.contextmanager
def recording(slots):
    """Record, for a CUDA graph captured inside, what its Python adds: the
    host counts and launches go to the yielded `Recording`, and the kernels
    count into `slots` (see `Recording`)."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording(slots)
    before = dict(launches)
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
        for k in launches:
            rec.launches[k] = launches[k] - before[k]
            launches[k] = before[k]


def replayed(rec):
    """Count one replay of the graph recorded in `rec`: its launches, and
    while tracing is on its host counts and its device counters (one add on
    the device). Looks at the profiler once."""
    for k, v in rec.launches.items():
        launches[k] += v
    if enabled():
        for k, v in rec.host.items():
            _session.host[k] += v
        _buffer(rec.slots.device).add_(rec.slots)


def read():
    """{counter: int} of the current or last profiler session, each device
    counter summed over the devices."""
    enabled()
    out = dict(_session.host)
    for buf in _session.buffers.values():
        for name, v in zip(DEVICE_COUNTERS, buf.cpu().tolist()):
            out[name] += v
    return out


def reset_launches():
    """Zero every count of `launches`."""
    for k in launches:
        launches[k] = 0
