"""nee_lane_share.frame: of the lanes the emitter samplers of next-event
estimation ran over in the traced window (the program's counter
`nee.sampler_lanes`: each `sample_emitter_direct` call runs every emitter's
sampler over every lane), the share that the calls kept (`nee.lanes`, one
sample a lane). 1 with one emitter; 1 / n where n emitters each sample
every lane. None where the program has no such counters or sampled
nothing."""

from benchmark import program_spans as ps


def read(run):
    c = ps.counts()
    if c is None or not c.get("nee.sampler_lanes"):
        return None
    return c.get("nee.lanes", 0) / c["nee.sampler_lanes"]
