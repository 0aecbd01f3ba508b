"""bsdf_kind_lane_share.frame: of the lane evaluations of BSDF kinds in the
traced window (the program's counter `bsdf.kind_lanes`: each `eval_bsdf`,
`pdf_bsdf` and `sample_bsdf` call computes every kind of the scene over
every lane), the share that the calls kept (`bsdf.lanes`, one kind a lane).
1 on a scene of one kind; 1 / k where k kinds each run over every lane.
None where the program has no such counters or shaded nothing."""

from benchmark import program_spans as ps


def read(run):
    c = ps.counts()
    if c is None or not c.get("bsdf.kind_lanes"):
        return None
    return c.get("bsdf.lanes", 0) / c["bsdf.kind_lanes"]
