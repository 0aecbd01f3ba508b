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
"""

import math
import os
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
from misaki_tpu_torch.scene.compiler import target_device
from misaki_tpu_torch.utils.logging import synced_clock

# the integrators whose 5-channel film misaki_tpu's `_render_chunk` splats;
# its photon integrators (and `aov`'s wider film) stay unsharded
SHARDED_INTEGRATORS = ("path", "direct", "volpath", "debug")
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
    if scene.integrator not in SHARDED_INTEGRATORS:
        raise NotImplementedError(
            f"a sharded render of the '{scene.integrator}' integrator: only "
            f"{', '.join(SHARDED_INTEGRATORS)} render into the 5-channel film")
    spp = scene.spp
    return lane_blocks(scene.film_width * scene.film_height * spp, spp, mesh.size)[mesh.rank]


def render_sharded(mesh, scene, seed=0, depth_cap=8, chunk_size=driver.DEFAULT_CHUNK):
    """The frame's film (H, W, 5) on every rank (misaki_tpu's
    `render_sharded`, :78-111): this rank's block of lanes rendered into a
    zero film in chunks of at most `chunk_size` lanes (`driver.pick_chunk`),
    then summed over the mesh (`mesh_sum`). `scene` lies on the rank's
    device."""
    lane0, lane1 = _block(mesh, scene)
    W, H, spp = scene.film_width, scene.film_height, scene.spp
    with torch.inference_mode():
        film_flat = film_mod.new_film_flat(H, W, 5, scene.filter_type, scene.filter_stddev,
                                           device=scene.device)
        chunk = driver.pick_chunk(chunk_size, spp, max(lane1 - lane0, 1))
        driver.render_lanes(scene, film_flat, lane0, lane1, seed, chunk, depth_cap)
        mesh_sum(film_flat, mesh)
        return film_mod.film_from_flat(film_flat, H, W, scene.filter_type, scene.filter_stddev)


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
    (`train_step_sharded`, kwargs `target_rgb` and the rest) -> [(result,
    seconds)], each timed with the device synchronised at both ends."""
    out = []
    for kind, scene, shape, kw in tasks:
        mesh = (make_mesh(shape[0], device) if len(shape) == 1 else
                make_host_chip_mesh(shape[0], device))
        scene = scene.to(device)
        t0 = synced_clock(device)
        fn = {"render": render_sharded if len(shape) == 1 else render_sharded_2d,
              "train": train_step_sharded}[kind]
        res = fn(mesh, scene, **kw)
        out.append((res, synced_clock(device) - t0))
    return out


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _spawn_main(rank, world_size, tmp, backend, device, t0, job, args):
    """One rank of `run_ranks`: join the group, run the job, write its
    result beside the store."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dev = init_distributed(f"file://{tmp}/store", world_size, rank, backend, device=device,
                           timeout=SPAWN_TIMEOUT)
    try:
        start_s = time.time() - t0
        result = job(dev, *args)
        torch.save({"result": _to_cpu(result), "start_s": start_s},
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world_size, job, *args, backend="gloo", device="cuda"):
    """Start `world_size` processes (torch.multiprocessing, start method
    spawn), join them in one process group through a file store in a
    temporary directory, and call `job(device, *args)` in each with the
    rank's device (init_distributed's). -> ([each rank's result, on the
    CPU], seconds from the start until the group was up). `job` is a
    module-level function of this package: the processes import it by
    name. Raises where a rank raised."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        torch.multiprocessing.spawn(_spawn_main, nprocs=world_size, join=True,
                                    args=(world_size, tmp, backend, device, t0, job, args))
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                for r in range(world_size)]
    return [o["result"] for o in outs], max(o["start_s"] for o in outs)
