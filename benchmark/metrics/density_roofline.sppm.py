"""density_roofline.sppm: the least time the traced window's density
estimates need, over the device time of the kernels density_ms.sppm sums
(named density_*_kernel), in percent.

The work is counted from the program's counters of the window: each
estimate must read the bytes the function needs once and write its outputs
once, 4 (P + 6 alive + 7 contributing + L + 7 live + 5 L) bytes (every
photon's alive flag; an alive photon's wi and n; a contributing one's
position and flux; every visible point's live flag; a live one's position,
tested direction and r2; phi and count written), at the published 3.35
TB/s: the definitions of misaki_tpu_torch/tools/profile_ppm_density.py
`bounds`. Summed over the estimates, the bytes are the same sum of the
counters `density.photons` (P), `density.visible_points` (L),
`density.alive`, `density.contributing` and `density.live`. Its FP32 side
lies about 10 times below."""

import re

from benchmark import peaks
from benchmark import program_spans as ps

_NAME = re.compile(r"\b" + peaks.DENSITY_KERNEL_PREFIX + r"\w*_kernel\b")


def least_bytes(c):
    return 4 * (c["density.photons"] + 6 * c["density.alive"] + 7 * c["density.contributing"]
                + c["density.visible_points"] + 7 * c["density.live"]
                + 5 * c["density.visible_points"])


def read(run):
    t = run.trace
    if t is None or not run.jobs_traced:
        return None
    c = ps.counts()
    if c is None or not c.get("density.photons"):
        return None
    seconds = t.kernel_seconds(lambda n: _NAME.search(n) is not None)
    if seconds <= 0:
        return None
    return 100.0 * least_bytes(c) / peaks.HBM_BYTES_PER_S / seconds
