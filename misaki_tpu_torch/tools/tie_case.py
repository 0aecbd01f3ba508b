"""An accel in which every hit is an exact tie across clusters.

`merge_clusters(acc, acc)` holds every face twice, in two sets of clusters;
the copy's face ids follow the original's, so the tie rule (smallest t, then
the largest face id) must pick the copy on every hit. The tests and
`chip_smoke.py` hold the closest-hit kernel and its plain twin to that rule
on it.
"""

import numpy as np

from misaki_tpu_torch.accel.cluster import build_bvh
from misaki_tpu_torch.scene.types import ClusterAccel


def _halves(lo, hi):
    """Tree over the cluster ids [lo, hi) that halves the id range."""
    if hi - lo == 1:
        return lo
    mid = (lo + hi) // 2
    return _halves(lo, mid), _halves(mid, hi)


def merge_clusters(a, b):
    """One accel over the clusters of `a`, then those of `b` (CPU tables, as
    `build_clusters` returns them); b's face ids follow a's. The BVH2's root
    splits the two, and on each side the top levels halve the cluster ids.
    With `b` a copy of `a`, every hit is an exact tie between two faces in
    different clusters, which the larger face id (b's) must win."""
    ta, tb = np.asarray(a.tri), np.array(b.tri)
    n_a = int((ta[:, :, 9] >= 0).sum())
    tb[:, :, 9] = np.where(tb[:, :, 9] >= 0, tb[:, :, 9] + n_a, -1.0)
    Ca, Cb = a.n_clusters, b.n_clusters
    C = Ca + Cb
    bounds = np.empty((8, max(-(-C // 128) * 128, 128)), np.float32)
    bounds[0:3], bounds[3:6], bounds[6:8] = np.inf, -np.inf, 0.0
    bounds[:, :Ca] = np.asarray(a.bounds)[:, :Ca]
    bounds[:, Ca:C] = np.asarray(b.bounds)[:, :Cb]
    tri = np.concatenate([ta, tb])
    nodes, leaf_tri = build_bvh(tri, (_halves(0, Ca), _halves(Ca, C)))
    return ClusterAccel(bounds=bounds, tri=tri,
                        tab=np.concatenate([np.asarray(a.tab), np.asarray(b.tab)]),
                        nodes=nodes, leaf_tri=leaf_tri, n_clusters=C)
