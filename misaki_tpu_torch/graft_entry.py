"""Entry points of the port (the counterparts of the JAX package's
`__graft_entry__.py`):

entry(device)              -> (fn, example_args): one 2^11-lane chunk of
                              the cbox path trace rendered into a film.
dryrun_multichip(n, device) -> runs the sharded train step (render -> loss
                              -> gradients, the film and the gradients
                              summed over the ranks) twice in n processes
                              joined over gloo, and checks its gradients.
"""

from pathlib import Path

import numpy as np

CBOX_XML = Path(__file__).resolve().parent / "scenes" / "cbox" / "scene.xml"


def _small_scene(spp=4, width=32, height=24, device="cuda"):
    from misaki_tpu_torch.scene.compiler import load_and_compile

    scene = load_and_compile(str(CBOX_XML), spp=spp, width=width, height=height, device=device)
    return scene.replace(max_depth=4)


def entry(device="cuda"):
    """-> (fn, example_args): `fn(scene, film_flat, lane0, seed)` renders one
    chunk of 2^11 lanes (a multiple of the 4 spp: pixel-aligned) of the
    in-repo cbox at 32x24 x 4 spp, depth cap 3, into the flat film and
    returns it."""
    from misaki_tpu_torch.render import film as film_mod
    from misaki_tpu_torch.render.driver import _render_chunk

    scene = _small_scene(device=device)
    W, H, spp = scene.film_width, scene.film_height, scene.spp
    n_total = W * H * spp
    chunk = 1 << 11
    film_flat = film_mod.new_film_flat(H, W, 5, scene.filter_type, scene.filter_stddev,
                                       device=scene.device)

    def fn(scene, film_flat, lane0, seed):
        return _render_chunk(scene, film_flat, lane0, n_total, seed, chunk, 3)

    return fn, (scene, film_flat, 0, 0)


def _dryrun_rank(device, scene, target):
    """One rank of `dryrun_multichip`: two sharded train steps, seeds 0 and
    1 -> (loss 0, {leaf: gradient}, loss 1)."""
    import torch.distributed as dist

    from misaki_tpu_torch.parallel.sharding import make_mesh, train_step_sharded

    mesh = make_mesh(dist.get_world_size(), device)
    scene = scene.to(device)
    loss0, grads = train_step_sharded(mesh, scene, target, seed=0, depth_cap=3)
    loss1, _ = train_step_sharded(mesh, scene, target, seed=1, depth_cap=3)
    return float(loss0), grads, float(loss1)


def dryrun_multichip(n_devices, device="cuda"):
    """`n_devices` processes joined over gloo (CUDA tensors where `device`
    is "cuda": gloo, unlike NCCL, lets ranks share one card) run the sharded
    train step twice, seeds 0 and 1, on cbox at 32x24 x max(4, n) spp;
    raises unless every rank has the same loss and gradients, the gradients
    are finite, at least one leaf's is non-zero, and the second loss is
    finite and differs from the first."""
    from misaki_tpu_torch.parallel.sharding import run_ranks

    scene = _small_scene(spp=max(4, n_devices), device="cpu")
    target = np.zeros((scene.film_height, scene.film_width, 3), np.float32)
    results, _ = run_ranks(n_devices, _dryrun_rank, scene, target, backend="gloo",
                           device=device)
    l0, grads, l1 = results[0]
    for r, (r0, g, r1) in enumerate(results[1:], 1):
        if (r0, r1) != (l0, l1) or any(not g[k].equal(grads[k]) for k in grads):
            raise RuntimeError(f"rank {r} ended the step with another loss or gradient")
    leaves = [g.numpy() for g in grads.values()]
    if not all(np.isfinite(g).all() for g in leaves):
        raise RuntimeError("non-finite gradients")
    n_nonzero = sum(np.abs(g).sum() > 0 for g in leaves)
    if n_nonzero == 0:
        raise RuntimeError("every gradient is zero")
    if not (np.isfinite(l1) and l1 != l0):
        raise RuntimeError("the second step did not run again")
    print(f"dryrun_multichip({n_devices}): loss={l0:.6f} ok (grads finite, "
          f"{n_nonzero}/{len(leaves)} leaves nonzero)")
