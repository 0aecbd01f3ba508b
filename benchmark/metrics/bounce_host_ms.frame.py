"""bounce_host_ms.frame: host ms a frame inside the program's
`misaki.bounce` spans (each iteration of a bounce or depth loop) and outside
its cast and density spans, on the traced window's host thread."""

from benchmark import program_spans as ps


def read(run):
    return ps.host_ms(run, ps.BOUNCE, (ps.CAST, ps.DENSITY))
