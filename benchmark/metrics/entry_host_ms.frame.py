"""entry_host_ms.frame: host ms a frame inside the program's `misaki.frame`
span and outside its bounce, cast and density spans (the chunk loop, the
primary rays, the first hit's interaction, the splat and the develop), on
the traced window's host thread."""

from benchmark import program_spans as ps


def read(run):
    return ps.host_ms(run, ps.FRAME, (ps.BOUNCE, ps.CAST, ps.DENSITY))
