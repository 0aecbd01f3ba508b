"""Wavefront ray intersection — the Embree replacement
(reference scene.cpp:216-273: rtcIntersect1 / rtcOccluded1).

Every scene intersects through the cluster-BVH kernels (accel/cluster.py):
on CUDA tensors the hand-written kernels, on CPU tensors their plain twins.
Rays are vec3 tuples of (L,) tensors.
"""

from misaki_tpu_torch.accel import cluster


def intersect(scene, o, d, mint, maxt, coherent=True, fd_rows=None):
    """Closest hit (Scene::ray_intersect, scene.cpp:216-253). Returns
    {"t", "prim", "u", "v", "fd"} with t = inf and prim = -1 on a miss and
    "fd" the winner's (N_FACE_COLS, L) face row.

    `coherent` and `fd_rows` are the JAX package's relayout hints; the
    port's kernels walk each ray on its own and return whole face rows, so
    both are accepted and ignored. Intersections carry no gradient."""
    return cluster.intersect_clusters(scene.cluster, o, d, mint, maxt)


def ray_test(scene, o, d, mint, maxt, coherent=False):
    """Shadow-ray occlusion (Scene::ray_test, scene.cpp:255-273); True =
    occluded."""
    return cluster.ray_test_clusters(scene.cluster, o, d, mint, maxt)
