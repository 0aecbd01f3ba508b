"""The gradient of an image loss with respect to scene-parameter leaves.

A frame's autograd graph grows with its lanes, about 4 KB of device memory
a lane (16 GiB for the 256x256 x 64 spp benchmark frame; Figure 2's
1280x720 x 128 spp would need about 490 GB). A frame of at most
`chunk_size` lanes is differentiated in one pass: rendered under autograd,
developed, the loss taken and back-propagated. A larger frame takes two
passes, and it is the same gradient:

  1. the primal: `render()` (under inference_mode, as any frame), then the
     loss on a detached copy of the film, through `film.develop`, which
     gives dL/dfilm;
  2. the re-render: the frame again, chunk by chunk, each chunk splatted
     into a zero film with the leaves requiring grad, and
     `torch.autograd.backward(film_c, dL/dfilm)`; the leaves' `.grad` sums
     the chunks.

It is exact because the film is the sum of its chunks' splats, and a
chunk's render is a deterministic function of its lanes and the seed
(driver.py), whatever the chunk size. For the same reason one process may
differentiate a block of the frame's lanes while others render the rest
(parallel/sharding.py `train_step_sharded`): the loss is taken on the sum
of the blocks' films, and its film gradient goes back into the block's own.
"""

import torch

from misaki_tpu_torch.diff.leaves import get_leaves, replace_leaves
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.render import film as film_mod
from misaki_tpu_torch.utils.logging import synced_clock

# Lanes per autograd chunk: the graph of one chunk is what must fit on the
# card. On an H100 80GB (chip_smoke.py phase 15 (d)) envlit's graph peaks at
# about 4 KB of device memory a lane (4.4 / 8.3 / 15.8 GiB at 2^20 / 2^21 /
# 2^22 lanes; cbox 12.1 GiB at 2^22), and fewer, larger chunks take less
# time (the frame is host-bound): 2^22 lanes differentiate the whole
# 256x256 x 64 spp frame in one pass and leave room on the card for a graph
# four times envlit's per lane.
GRAD_CHUNK = 1 << 22


def image_grads(scene, names, loss_fn, seed=0, depth_cap=4, chunk_size=GRAD_CHUNK,
                stats=None, lanes=None, reduce=None):
    """-> (loss (0-d tensor), rgb (H, W, 3), {name: gradient of the loss})
    for `loss_fn(rgb)` of the `path`, `direct` or `volpath` image of `scene`, with
    respect to the leaves `names` (misaki_tpu_torch.diff.DIFF_LEAVES). A
    frame of at most `chunk_size` lanes (rounded down to whole pixels, as
    `render()` does) is differentiated in one pass; a larger one takes a
    primal in `render()`'s default chunks and a re-render in `chunk_size`
    chunks.

    `lanes` (lane0, lane1), spp-aligned: the gradient of these lanes' film
    only (by default the frame's). `reduce`: where given, a function that
    sums a detached (C, flat) film over the processes that render the other
    lanes, in place; the loss, the image and dL/dfilm are then the summed
    film's, and dL/dfilm goes back into these lanes' film (`chunk_size` or
    fewer lanes are rendered once, under autograd).

    `stats`: a dict that, where given, receives the seconds of the primal
    (0 in one pass) and of the render under autograd with its backward (the
    device synchronised at each end), the chunk and the chunk count of that
    render and, on CUDA, its peak device memory in bytes."""
    if scene.integrator not in ("path", "direct", "volpath"):
        raise NotImplementedError(f"gradients of the '{scene.integrator}' integrator")
    W, H, spp = scene.film_width, scene.film_height, scene.spp
    dev = scene.device
    leaves = {k: v.detach().requires_grad_() for k, v in get_leaves(scene, names).items()}
    scene_g = replace_leaves(scene, leaves)
    n_total = W * H * spp
    lane0, lane1 = (0, n_total) if lanes is None else lanes
    chunk = driver.pick_chunk(chunk_size, spp, max(lane1 - lane0, 1))
    n_chunks = -(-(lane1 - lane0) // chunk)

    def new_flat():
        return film_mod.new_film_flat(H, W, 5, scene.filter_type, scene.filter_stddev,
                                      device=dev)

    def to_film(flat):
        return film_mod.film_from_flat(flat, H, W, scene.filter_type, scene.filter_stddev)

    def chunk_flat(c):
        c0 = lane0 + c * chunk
        return driver.render_lanes(scene_g, new_flat(), c0, min(c0 + chunk, lane1), seed,
                                   chunk, depth_cap)

    t0 = synced_clock(dev) if stats is not None else None
    if stats is not None and dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if n_chunks == 1 and reduce is None:
        # one pass: the loss of the frame's own graph
        t1 = t0
        rgb, _ = film_mod.develop(to_film(chunk_flat(0)))
        loss = loss_fn(rgb)
        if loss.requires_grad:
            loss.backward()
    else:
        # the film of the lanes, under autograd where it is one chunk (kept
        # for the backward), else a primal without a graph
        own = chunk_flat(0) if n_chunks == 1 else None
        if own is not None:
            primal = own.detach().clone()
        else:
            with torch.inference_mode():
                primal = driver.render_lanes(
                    scene, new_flat(), lane0, lane1, seed,
                    driver.pick_chunk(driver.DEFAULT_CHUNK, spp, max(lane1 - lane0, 1)),
                    depth_cap)
            primal = primal.clone()
        if reduce is not None:
            reduce(primal)
        film = to_film(primal).clone().requires_grad_()
        rgb, _ = film_mod.develop(film)
        loss = loss_fn(rgb)
        (grad_film,) = torch.autograd.grad(loss, film)
        if stats is not None:
            t1 = synced_clock(dev)
            if dev.type == "cuda" and own is None:
                torch.cuda.reset_peak_memory_stats(dev)
        for c in range(n_chunks):
            img_c = to_film(own if own is not None else chunk_flat(c))
            if img_c.requires_grad:
                torch.autograd.backward(img_c, grad_film)
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in leaves.items()}
    if stats is not None:
        t2 = synced_clock(dev)
        stats.update(primal_s=t1 - t0, backward_s=t2 - t1, chunk=chunk, chunks=n_chunks,
                     peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                     else None)
    return loss.detach(), rgb.detach(), grads
