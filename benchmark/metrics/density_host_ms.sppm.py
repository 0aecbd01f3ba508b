"""density_host_ms.sppm: host ms a photon frame inside the program's
`misaki.density` spans (each density estimate: packing, workspace and
launches; the glossy estimate), on the traced window's host thread."""

from benchmark import program_spans as ps


def read(run):
    return ps.host_ms(run, ps.DENSITY)
