"""Rendering and training over several processes on torch.distributed
(misaki_tpu/parallel/sharding.py).

Design, as misaki_tpu's:
  * the scene is replicated: every rank holds the whole compiled scene on
    its own device;
  * the global lane space [0, W*H*spp) is split into contiguous,
    spp-aligned blocks, one a rank (`lane_blocks`); each rank renders its
    block through `driver._render_chunk` into a zero film of its own;
  * the films are summed with `all_reduce`, exact up to the order of float
    adds because splatting is additive;
  * a train step takes the loss of the summed film on every rank and
    back-propagates its film gradient into each rank's own film; the
    leaves' gradients are then summed over the ranks (`train_step_sharded`
    says why this, and not a differentiable all-reduce).
Lane seeding is global (driver.make_rng), so the image is the one-process
image up to the order of float adds, whatever the number of ranks.

A rank is one process with one device. "nccl" joins processes that have a
card each; "gloo" joins processes on the CPU, and processes that share one
card (NCCL refuses two ranks on one device).

`render_sharded` and `train_step_sharded` are what one rank runs: every
rank of a group calls them together. `ShardedRenderer` is a standing group
that serves frame after frame to one caller, which is its rank 0.
"""

import math
import multiprocessing.connection
import multiprocessing.resource_tracker
import os
import pickle
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from misaki_tpu_torch.diff.backprop import GRAD_CHUNK
from misaki_tpu_torch.diff.train import DEFAULT_TRAIN_LEAVES, train_step
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.render import film as film_mod
from misaki_tpu_torch.render import integrator as integ
from misaki_tpu_torch.scene.compiler import target_device
from misaki_tpu_torch.utils import cuda_build, tracing

# how long a spawned rank waits in a collective before it fails
SPAWN_TIMEOUT = timedelta(minutes=10)


def init_distributed(init_method=None, world_size=None, rank=None, backend=None,
                     device="cuda", timeout=None):
    """Join this process to a process group (misaki_tpu's `init_distributed`,
    :31-47) and return its device: cuda:{local rank % cards}, the local rank
    from LOCAL_RANK where a launcher sets it and `rank` otherwise, or the
    CPU where `device` asks for it. Without a CUDA device "cuda" raises:
    there is no fallback to the CPU. A no-op, but for the device, when
    `world_size` is None or 1 and no `init_method` is given.

    backend: "nccl" for one process a card, "gloo" on the CPU and for
    several processes that share one card; it is never chosen here."""
    device = target_device(device, "init_distributed")
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if world_size in (None, 1) and init_method is None:
        return device
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_distributed: backend 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("init_distributed: nccl needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kw)
    return device


@dataclass(frozen=True)
class Mesh:
    """Ranks on named axes as one rank sees them (a jax.sharding.Mesh's
    counterpart): the shape, the axis names, this process's flat rank
    (host * n_chip + chip on a (host, chip) mesh), and per axis the process
    group of the ranks that differ only along that axis (None where the mesh
    is one process without a process group)."""

    shape: tuple
    names: tuple
    rank: int
    groups: tuple

    @property
    def size(self):
        return math.prod(self.shape)


def _mesh(shape, names, device):
    device = target_device(device, "make_mesh")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs a process group: call "
                             "init_distributed first")
        return Mesh(shape, names, 0, (None,) * len(shape))
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks; the process group has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    # ranks laid out row-major, so the flat rank is the global one
    dm = init_device_mesh(device.type, shape, mesh_dim_names=names)
    return Mesh(shape, names, dist.get_rank(), tuple(dm.get_group(a) for a in names))


def make_mesh(n_devices, device="cuda", axis_name="wavefront"):
    """1D mesh of the `n_devices` ranks of the process group (misaki_tpu's
    `make_mesh`, :63-75); a single process without a process group gives
    a mesh of one. `device`: the rank's, as init_distributed returned it."""
    return _mesh((n_devices,), (axis_name,), device)


def make_host_chip_mesh(n_hosts=None, device="cuda", axis_names=("host", "chip")):
    """2D (host, chip) mesh of the process group's ranks (misaki_tpu's
    `make_host_chip_mesh`, :50-60), rank = host * n_chip + chip. `n_hosts`
    defaults to the world size over LOCAL_WORLD_SIZE (a launcher's), else 1:
    a single host gives (1, ranks), which splits lanes as the 1D mesh
    does."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_hosts is None:
        n_hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not split over {n_hosts} hosts")
    return _mesh((n_hosts, world // n_hosts), axis_names, device)


def lane_blocks(n_total, spp, n_dev):
    """-> [(lane0, lane1)] a rank: misaki_tpu's split (sharding.py:83-84),
    blocks of ceil(ceil(n_total / n_dev) / spp) * spp lanes from lane 0, so
    every block starts on a pixel. Blocks past n_total are empty; the last
    one that is not may be short."""
    per = -(-(-(-n_total // n_dev)) // spp) * spp
    return [(min(r * per, n_total), min((r + 1) * per, n_total)) for r in range(n_dev)]


def mesh_sum(x, mesh):
    """Sum `x` over the mesh's ranks in place, the minor axis first (on a
    (host, chip) mesh the chip group, then the host group, as misaki_tpu's
    psums, :143-144) -> x."""
    for group in reversed(mesh.groups):
        if group is not None:
            dist.all_reduce(x, group=group)
    return x


def _block(mesh, scene):
    _check_integrator(scene)
    spp = scene.spp
    return lane_blocks(scene.film_width * scene.film_height * spp, spp, mesh.size)[mesh.rank]


def _check_integrator(scene):
    if scene.integrator not in driver.FILM_INTEGRATORS:
        raise NotImplementedError(
            f"a sharded render of the '{scene.integrator}' integrator: only "
            f"{', '.join(driver.FILM_INTEGRATORS)} render into the 5-channel film")


def _render_block(scene, block, seed, depth_cap, chunk_size, ranks):
    """A zero film (flat) with the lanes [lane0, lane1) of `block` rendered
    into it in chunks of at most `chunk_size` lanes (`driver.pick_chunk`).
    One column past the film's guard rows, which no splat reaches, holds 1
    in its first channel: summed over the ranks it counts the films in the
    sum (`ShardedRenderer.render` checks it). Raises where the block leaves
    the frame or does not start on a pixel."""
    lane0, lane1 = block
    W, H, spp = scene.film_width, scene.film_height, scene.spp
    n_total = W * H * spp
    if not (0 <= lane0 <= lane1 <= n_total and lane0 % spp == 0):
        raise ValueError(f"lane block {block} of a {n_total}-lane frame: a block lies in the "
                         f"frame and starts on a pixel ({spp} lanes)")
    tracing.add(tracing.SHARD_RANKS, ranks)
    tracing.add(tracing.SHARD_LANES, lane1 - lane0)
    # new_film_flat's layout, and the column
    guard = film_mod.pad_rows(W, scene.filter_type, scene.filter_stddev)
    film_flat = torch.zeros((5, H * W + 2 * guard + 1), dtype=torch.float32,
                            device=scene.device)
    film_flat[0, -1] = 1.0
    chunk = driver.pick_chunk(chunk_size, spp, max(lane1 - lane0, 1))
    return driver.render_lanes(scene, film_flat, lane0, lane1, seed, chunk, depth_cap)


def _film_sum(film_flat, mesh):
    """`mesh_sum` of a rank's film, inside the `misaki.film_sum` span."""
    reduces = sum(g is not None for g in mesh.groups)
    tracing.add(tracing.SHARD_FILM_SUM_BYTES,
                reduces * film_flat.numel() * film_flat.element_size())
    with tracing.span(tracing.FILM_SUM):
        return mesh_sum(film_flat, mesh)


def render_sharded(mesh, scene, seed=0, depth_cap=8, chunk_size=driver.DEFAULT_CHUNK):
    """The frame's film (H, W, 5) on every rank (misaki_tpu's
    `render_sharded`, :78-111): this rank's block of lanes rendered into a
    zero film in chunks of at most `chunk_size` lanes (`driver.pick_chunk`),
    then summed over the mesh (`mesh_sum`). `scene` lies on the rank's
    device."""
    with torch.inference_mode():
        film_flat = _render_block(scene, _block(mesh, scene), seed, depth_cap, chunk_size,
                                  mesh.size)
        _film_sum(film_flat, mesh)
        return film_mod.film_from_flat(film_flat, scene.film_height, scene.film_width,
                                       scene.filter_type, scene.filter_stddev)


def render_sharded_2d(mesh, scene, seed=0, depth_cap=8, chunk_size=driver.DEFAULT_CHUNK):
    """`render_sharded` on a (host, chip) mesh (misaki_tpu's
    `render_sharded_2d`, :117-153): lanes split host-major then chip-minor,
    the same split as the 1D mesh's, and the film summed over the chip
    group first, the host group second."""
    if len(mesh.shape) != 2:
        raise ValueError(f"render_sharded_2d needs a (host, chip) mesh, not {mesh.shape}")
    return render_sharded(mesh, scene, seed, depth_cap, chunk_size)


def train_step_sharded(mesh, scene, target_rgb, seed=0, depth_cap=4,
                       leaves=DEFAULT_TRAIN_LEAVES, chunk_size=GRAD_CHUNK):
    """-> (loss, {leaf: gradient}) of mean((rgb - target_rgb)^2) over the
    mesh, the same on every rank (misaki_tpu's `train_step_sharded`,
    :156-181; `diff/train.py` `train_step` on one device):
      1. each rank renders its block's film f_r under autograd;
      2. a detached copy of it is summed over the mesh: F = sum_r f_r;
      3. every rank develops F and takes the loss and dL/dF;
      4. `torch.autograd.backward(f_r, dL/dF)`, since dL/df_r = dL/dF;
      5. each leaf's gradient is summed over the mesh.
    A block of more than `chunk_size` lanes takes `image_grads`' primal and
    chunked re-render. A differentiable all-reduce under every rank's copy
    of the loss would instead sum world-size equal film adjoints in its
    backward, and step 5 would count each block world-size times."""
    lanes = _block(mesh, scene)
    loss, grads = train_step(scene, target_rgb, seed, depth_cap, leaves,
                             chunk_size=chunk_size, lanes=lanes,
                             reduce=lambda flat: mesh_sum(flat, mesh))
    return loss, {k: mesh_sum(g.contiguous(), mesh) for k, g in grads.items()}


# ---- ranks in processes of their own (tests, graft_entry, chip_smoke) ----

def sharded_job(device, tasks):
    """A rank's work for `run_ranks`: for each (kind, scene, mesh shape,
    kwargs) of `tasks`, a mesh of that shape ((n,) or (n_host, n_chip)) and
    `scene` moved to the rank's device, then kind "render"
    (`render_sharded`, `render_sharded_2d` on a 2D mesh) or "train"
    (`train_step_sharded`, kwargs `target_rgb` and the rest) -> [result]."""
    out = []
    for kind, scene, shape, kw in tasks:
        mesh = (make_mesh(shape[0], device) if len(shape) == 1 else
                make_host_chip_mesh(shape[0], device))
        fn = {"render": render_sharded if len(shape) == 1 else render_sharded_2d,
              "train": train_step_sharded}[kind]
        out.append(fn(mesh, scene.to(device), **kw))
    return out


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _spawn_main(rank, world_size, tmp, backend, device, job, args):
    """One rank of `run_ranks`: join the group, run the job, write its
    result beside the store."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dev = init_distributed(f"file://{tmp}/store", world_size, rank, backend, device=device,
                           timeout=SPAWN_TIMEOUT)
    try:
        torch.save(_to_cpu(job(dev, *args)), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world_size, job, *args, backend="gloo", device="cuda"):
    """Start `world_size` processes (torch.multiprocessing, start method
    spawn), join them in one process group through a file store in a
    temporary directory, and call `job(device, *args)` in each with the
    rank's device (init_distributed's). -> [each rank's result, on the
    CPU]. `job` is a module-level function of this package: the processes
    import it by name. Raises where a rank raised."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_spawn_main, nprocs=world_size, join=True,
                                    args=(world_size, tmp, backend, device, job, args))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                for r in range(world_size)]


# ---- a standing group of ranks (ShardedRenderer) ----

# a request, as int64 words broadcast from rank 0 over the side group: the
# op, the seed, the chunk size, the depth cap, then (lane0, lane1) a rank
_STOP, _RENDER = 0, 1
_HEAD = 4
# how often rank 0 looks at the rank processes while they start (while it
# waits for a frame on its card, it looks between queries of the card)
_POLL_S = 0.05
# how long the ranks of a failed group get to end, and to write their
# errors, before they are killed
_GRACE_S = 5.0
# how long a rank waits for rank 0's next request: a standing group may
# idle between frames for as long as its caller likes
_IDLE_TIMEOUT = timedelta(days=365)


def _join(store, world, rank, device):
    """Join the group of a ShardedRenderer through `store`, over NCCL on
    cards and gloo on the CPU -> (mesh of the ranks, the gloo side group
    that carries rank 0's requests)."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, world_size=world, rank=rank,
                            timeout=SPAWN_TIMEOUT)
    side = dist.new_group(backend="gloo", timeout=_IDLE_TIMEOUT)
    return make_mesh(world, device), side


def _frame(mesh, scene, block, seed, depth_cap, chunk_size):
    """One rank's part of a frame: its block rendered, then the film summed
    over the ranks -> the summed film (flat)."""
    film_flat = _render_block(scene, block, seed, depth_cap, chunk_size, mesh.size)
    return _film_sum(film_flat, mesh)


def _serve(i, world, store_path, device_type, scene):
    """Rank i + 1 of a ShardedRenderer, in a process of its own: hold the
    scene on cuda:{rank} (or the CPU), join the group, and render this
    rank's block of each frame rank 0 asks for into the film's sum, until
    rank 0 says stop."""
    rank = i + 1
    if device_type == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    scene = scene.to(device)
    store = dist.FileStore(store_path, world)
    store.set(f"ready{rank}", "1")
    mesh, side = _join(store, world, rank, device)
    req = torch.zeros(_HEAD + 2 * world, dtype=torch.int64)
    try:
        while True:
            dist.broadcast(req, 0, group=side)
            op, seed, chunk_size, depth_cap, *lanes = req.tolist()
            if op == _STOP:
                break
            block = (lanes[2 * rank], lanes[2 * rank + 1])
            with torch.inference_mode():
                _frame(mesh, scene, block, seed, depth_cap, chunk_size)
    except BaseException:
        dist.distributed_c10d._abort_process_group()
        raise
    dist.destroy_process_group()


class ShardedRenderer:
    """A standing group of `ranks` processes that render frames of one
    scene together: the caller's process is rank 0, on cuda:0 (or the CPU),
    and ranks 1..ranks-1 are started once (torch.multiprocessing, spawn),
    each holding the scene on cuda:{rank} (or the CPU). The ranks join over
    NCCL on cards, one process a card, and over gloo on the CPU.

    Each `render` sends the request to the other ranks over a gloo side
    group (a rank waiting for the next frame holds no kernel on its card);
    then every rank renders its `lane_blocks` block with
    `driver.render_lanes` and the films are summed with `mesh_sum`, as
    `render_sharded` does, and rank 0 develops the sum. Rank 0 then checks
    that the sum counts every rank's film: an all-reduce that a failed rank
    left can end on the others' cards (NCCL aborts it) with a partial sum.
    The frame is the one-process frame up to the order of float adds.

    A rank that raises or dies makes `render` and `close` raise, within
    SPAWN_TIMEOUT, with every rank's error; the other ranks are then
    stopped, and the group is closed. A closed group leaves no process
    behind: not its ranks, nor multiprocessing's resource tracker where
    the group's start started it. A context manager: leaving it closes the
    group."""

    def __init__(self, scene, ranks, device="cuda"):
        device = target_device(device, "ShardedRenderer")
        _check_integrator(scene)
        if ranks < 1:
            raise ValueError(f"ShardedRenderer: ranks must be at least 1, not {ranks}")
        if dist.is_initialized():
            raise RuntimeError("ShardedRenderer: this process already belongs to a process "
                               "group")
        if device.type == "cuda":
            if torch.cuda.device_count() < ranks:
                raise ValueError(f"ShardedRenderer: {ranks} ranks need {ranks} CUDA devices; "
                                 f"found {torch.cuda.device_count()}")
            device = torch.device("cuda", 0)
            # built once here, not by every rank at its first launch
            cuda_build.compile_all()
        self.ranks = ranks
        self._scene = scene.to(device)
        self._n_total = scene.film_width * scene.film_height * scene.spp
        # spawning starts the tracker unless this process runs one already
        self._own_tracker = multiprocessing.resource_tracker._resource_tracker._pid is None
        self._tmp = tempfile.TemporaryDirectory()
        store_path = os.path.join(self._tmp.name, "store")
        store = dist.FileStore(store_path, ranks)
        # daemons: a caller that exits without close() ends its ranks, where
        # the interpreter would otherwise wait for them at exit
        self._ctx = torch.multiprocessing.start_processes(
            _serve, args=(ranks, store_path, device.type, scene.to("cpu")),
            nprocs=ranks - 1, join=False, daemon=True, start_method="spawn")
        self._joined = False
        try:
            self._wait_for(lambda: store.check([f"ready{r}" for r in range(1, ranks)]),
                           _POLL_S)
            self._mesh, self._side = _join(store, ranks, 0, device)
            self._joined = True
        except BaseException as e:
            self._fail(e)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def render(self, seed=0, chunk_size=driver.DEFAULT_CHUNK,
               depth_cap=integ.DEFAULT_MAX_DEPTH_CAP):
        """The frame, as `driver.render` returns it: {"film" (H, W, 5),
        "rgb" (H, W, 3), "alpha" (H, W)} on rank 0's device, the frame's
        work done there when it returns."""
        self._check_open()
        scene = self._scene
        with tracing.span(tracing.FRAME):
            try:
                blocks = lane_blocks(self._n_total, scene.spp, self.ranks)
                self._send(_RENDER, seed, chunk_size, depth_cap, blocks)
                with torch.inference_mode():
                    film_flat = _frame(self._mesh, scene, blocks[0], seed, depth_cap,
                                       chunk_size)
                    film = film_mod.film_from_flat(film_flat, scene.film_height,
                                                   scene.film_width, scene.filter_type,
                                                   scene.filter_stddev)
                    rgb, alpha = film_mod.develop(film)
                if scene.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                    self._wait_for(done.query, 0.0)
                films = int(film_flat[0, -1])
                if films != self.ranks:
                    raise RuntimeError(f"ShardedRenderer: the film's sum holds {films} of "
                                       f"{self.ranks} ranks' films")
            except BaseException as e:
                self._fail(e)
        return {"film": film, "rgb": rgb, "alpha": alpha}

    def close(self):
        """Stop the ranks and leave the group; raises where a rank failed.
        Closing a closed group does nothing."""
        if self._ctx is None:
            return
        try:
            self._send(_STOP, 0, 0, 0, [(0, 0)] * self.ranks)
            dist.destroy_process_group()
            self._joined = False
            deadline = time.monotonic() + SPAWN_TIMEOUT.total_seconds()
            for p in self._ctx.processes:
                p.join(max(0.0, deadline - time.monotonic()))
            if any(p.exitcode != 0 for p in self._ctx.processes):
                raise RuntimeError("ShardedRenderer: a rank did not stop cleanly")
        except BaseException as e:
            self._fail(e)
        self._ctx = None
        self._tmp.cleanup()
        self._stop_tracker()

    def _check_open(self):
        if self._ctx is None:
            raise RuntimeError("ShardedRenderer: the group is closed")

    def _send(self, op, seed, chunk_size, depth_cap, blocks):
        words = [op, int(seed), int(chunk_size), int(depth_cap)]
        words += [v for block in blocks for v in block]
        dist.broadcast(torch.tensor(words, dtype=torch.int64), 0, group=self._side)

    def _wait_for(self, ready, poll_s):
        """Wait until `ready()`, looking at the rank processes every `poll_s`
        seconds (0: between calls of `ready`); raises where one of them has
        ended, or after SPAWN_TIMEOUT."""
        deadline = time.monotonic() + SPAWN_TIMEOUT.total_seconds()
        sentinels = [p.sentinel for p in self._ctx.processes]
        while not ready():
            if multiprocessing.connection.wait(sentinels, poll_s):
                raise RuntimeError("ShardedRenderer: a rank process ended")
            if time.monotonic() > deadline:
                raise TimeoutError(f"ShardedRenderer: no progress in {SPAWN_TIMEOUT}")

    def _fail(self, cause):
        """Stop every rank after `cause` and raise, with each rank's own
        error where it wrote one; the group is then closed."""
        ctx, self._ctx = self._ctx, None
        deadline = time.monotonic() + _GRACE_S
        for p in ctx.processes:
            p.join(max(0.0, deadline - time.monotonic()))
        killed = [p.is_alive() for p in ctx.processes]
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        errors = []
        for i, (p, path) in enumerate(zip(ctx.processes, ctx.error_files)):
            if os.path.exists(path):
                with open(path, "rb") as f:
                    errors.append(f"-- rank {i + 1}:\n{pickle.load(f)}")
                os.remove(path)
            elif not killed[i] and p.exitcode != 0:
                errors.append(f"-- rank {i + 1}: ended with exit code {p.exitcode}")
        if self._joined:
            dist.distributed_c10d._abort_process_group()
            self._joined = False
        self._tmp.cleanup()
        self._stop_tracker()
        if errors and isinstance(cause, Exception):
            raise RuntimeError("ShardedRenderer: the group failed\n" + "\n".join(errors)) \
                from cause
        raise cause

    def _stop_tracker(self):
        """Stop multiprocessing's resource tracker where the group's start
        started it (its ranks have ended): it would outlive the group, to
        the end of this process, and an orphan tracker is left unreaped
        where nothing reaps orphans. A later spawn starts it again."""
        if self._own_tracker:
            multiprocessing.resource_tracker._resource_tracker._stop()
