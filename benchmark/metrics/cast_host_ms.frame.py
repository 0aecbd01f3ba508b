"""cast_host_ms.frame: host ms a frame inside the program's `misaki.cast`
spans (the rays' packing, the closest-hit or any-hit launch and the
unpacking), on the traced window's host thread."""

from benchmark import program_spans as ps


def read(run):
    return ps.host_ms(run, ps.CAST)
