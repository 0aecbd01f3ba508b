"""rng_kernel_share.frame: of the PCG32 floats the traced window drew (the
program's counter `rng.floats`, each group of draws its k), the share the
hand-written PCG32 kernel drew (`rng.kernel.floats`) rather than the torch
ops of the limb arithmetic. None where the program has no such counters or
drew nothing."""

from benchmark import program_spans as ps


def read(run):
    c = ps.counts()
    if c is None or not c.get("rng.floats"):
        return None
    return c.get("rng.kernel.floats", 0) / c["rng.floats"]
