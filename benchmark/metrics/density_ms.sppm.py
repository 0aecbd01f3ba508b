"""density_ms.sppm: device time, per photon frame, of the density estimate's
kernels (csrc/ppm_density.cu, named density_*_kernel), in ms."""

import re

from benchmark import peaks

_NAME = re.compile(r"\b" + peaks.DENSITY_KERNEL_PREFIX + r"\w*_kernel\b")


def read(run):
    t = run.trace
    if t is None or not run.jobs_traced:
        return None
    seconds = t.kernel_seconds(lambda n: _NAME.search(n) is not None)
    if seconds <= 0:
        return None
    return seconds * 1e3 / run.jobs_traced
