"""bvh_nodes_per_ray.frame: the inner BVH2 nodes a live closest-hit ray of
the traced window visited, each slab-testing its two children, on average:
the program's counters `cast.closest.nodes` over `cast.closest.live` (rays
with maxt >= mint), both counted in the closest-hit kernel. None where the
program has no such counters or counted none (the CPU twin walks no BVH2)."""

from benchmark import program_spans as ps


def read(run):
    c = ps.counts()
    if c is None or not c.get("cast.closest.nodes") or not c.get("cast.closest.live"):
        return None
    return c["cast.closest.nodes"] / c["cast.closest.live"]
