"""Wavefront ray intersection — the Embree replacement
(reference scene.cpp:216-273: rtcIntersect1 / rtcOccluded1).

Every scene intersects through the cluster-BVH kernels (accel/cluster.py):
on CUDA tensors the hand-written kernels, on CPU tensors their plain twins.
Rays are vec3 tuples of (L,) tensors.

Casts carry no gradient (misaki_tpu/accel/traverse.py:351-402, the
detached-sampling convention of misaki_tpu_torch.diff): the rays are
detached going in and every result coming out, so on the CPU the plain
twins' arithmetic stays out of the autograd graph too.
"""

from misaki_tpu_torch.accel import cluster
from misaki_tpu_torch.utils import tracing


def _detached(o, d, mint, maxt):
    return (tuple(c.detach() for c in o), tuple(c.detach() for c in d), mint.detach(),
            maxt.detach())


def intersect(scene, o, d, mint, maxt, coherent=True, fd_rows=None):
    """Closest hit (Scene::ray_intersect, scene.cpp:216-253). Returns
    {"t", "prim", "u", "v", "fd"} with t = inf and prim = -1 on a miss and
    "fd" the winner's (N_FACE_COLS, L) face row.

    `coherent` and `fd_rows` are the JAX package's relayout hints; the
    port's kernels walk each ray on its own and return whole face rows, so
    both are accepted and ignored. Intersections carry no gradient."""
    with tracing.span(tracing.CAST):
        hit = cluster.intersect_clusters(scene.cluster, *_detached(o, d, mint, maxt))
        return {k: v.detach() for k, v in hit.items()}


def ray_test(scene, o, d, mint, maxt, coherent=False):
    """Shadow-ray occlusion (Scene::ray_test, scene.cpp:255-273); True =
    occluded."""
    with tracing.span(tracing.CAST):
        return cluster.ray_test_clusters(scene.cluster, *_detached(o, d, mint, maxt)).detach()
