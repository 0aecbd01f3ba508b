"""bvh_faces_per_ray.frame: the faces a live closest-hit ray of the traced
window ran Moller-Trumbore on, on average: the program's counters
`cast.closest.faces` over `cast.closest.live` (rays with maxt >= mint), both
counted in the closest-hit kernel. None where the program has no such
counters or counted none (the CPU twin walks no BVH2)."""

from benchmark import program_spans as ps


def read(run):
    c = ps.counts()
    if c is None or not c.get("cast.closest.faces") or not c.get("cast.closest.live"):
        return None
    return c["cast.closest.faces"] / c["cast.closest.live"]
