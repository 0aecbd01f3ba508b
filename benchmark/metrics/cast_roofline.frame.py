"""cast_roofline.frame: the least time the casts of the traced frames need,
over the device time of the cast kernels, in percent.

The work is counted from the job, not from the kernels: every ray a frame
casts (the camera ray, and a closest-hit and a shadow ray each bounce
iteration, for each of W x H x spp samples), each ray's inputs read once
and outputs written once, and the face table once a launch
(peaks.cast_bytes_per_frame), at the published 3.35 TB/s. The time is the
summed device time of the kernels named in peaks.CLOSEST_KERNELS and
peaks.ANYHIT_KERNELS. A later kernel that moves fewer bytes, or a fusion of
the casts into another kernel, is held to the same work."""

from benchmark import peaks


def _is_cast(name):
    return any(k in name for k in peaks.CLOSEST_KERNELS + peaks.ANYHIT_KERNELS)


def read(run):
    t = run.trace
    if t is None or not run.jobs_traced:
        return None
    seconds = t.kernel_seconds(_is_cast)
    if seconds <= 0:
        return None
    need = peaks.cast_bytes_per_frame(run.cell.config, run.cell.traffic) * run.jobs_traced
    return 100.0 * need / peaks.HBM_BYTES_PER_S / seconds
