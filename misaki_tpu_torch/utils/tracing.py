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

On a frame's host thread casts and estimates lie in bounce spans or directly
in the frame, so the frame's time splits into entry (the frame outside any
bounce, cast or estimate), bounces (outside casts and estimates), casts and
estimates.

Counters:

  cast.closest.rays       host: the rays of each closest-hit cast, unpadded
  cast.closest.live       device: those with maxt >= mint (dead lanes and
                          the pad carry mint 0, maxt -1)
  density.photons         host: P of each estimate
  density.visible_points  host: L of each estimate
  density.alive           device: photons alive (the estimate's keys pass)
  density.contributing    device: photons alive with wi . n > 0
  density.live            device: visible points valid and not glossy (the
                          gather), each once

`launches` is always on, and not zeroed by a session: the launches of each
hand-written kernel in the process ("closest", "anyhit", "fetch",
"fetch_bwd"; "density", one a density estimate, and "density_cuda", the
CUDA kernels those estimates enqueued).
"""

import contextlib

import torch

FRAME = "misaki.frame"
CHUNK = "misaki.chunk"
BOUNCE = "misaki.bounce"
CAST = "misaki.cast"
DENSITY = "misaki.density"

CAST_RAYS = "cast.closest.rays"
CAST_LIVE = "cast.closest.live"
DENSITY_PHOTONS = "density.photons"
DENSITY_VPS = "density.visible_points"
DENSITY_ALIVE = "density.alive"
DENSITY_CONTRIBUTING = "density.contributing"
DENSITY_LIVE = "density.live"

HOST_COUNTERS = (CAST_RAYS, DENSITY_PHOTONS, DENSITY_VPS)
# the device buffer's slots, in this order; the density kernel takes the
# address of DENSITY_ALIVE and writes that slot and the next two
DEVICE_COUNTERS = (CAST_LIVE, DENSITY_ALIVE, DENSITY_CONTRIBUTING, DENSITY_LIVE)
COUNTERS = HOST_COUNTERS + DEVICE_COUNTERS

launches = dict.fromkeys(("closest", "anyhit", "fetch", "fetch_bwd", "density",
                          "density_cuda"), 0)

_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


class _Session:
    """The counts of the current or last profiler session."""

    def __init__(self):
        self.running = False            # a profiler was running at the last look
        self.host = dict.fromkeys(COUNTERS, 0)
        self.buffers = {}               # device -> int64 (len(DEVICE_COUNTERS),)


_session = _Session()


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
    while tracing is on."""
    if enabled():
        _session.host[name] += int(n)


def device_counter(device, name):
    """The address of device counter `name` on `device` for a kernel to add
    to, or None while tracing is off (the kernel then counts nothing)."""
    if not enabled():
        return None
    buf = _session.buffers.get(device)
    if buf is None:
        buf = torch.zeros(len(DEVICE_COUNTERS), dtype=torch.int64, device=device)
        _session.buffers[device] = buf
    return buf.data_ptr() + buf.element_size() * DEVICE_COUNTERS.index(name)


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
