"""launches_per_frame: the CUDA kernels that ran in the traced window (one a
launch) over the frames traced."""


def read(run):
    t = run.trace
    if t is None or not run.jobs_traced or not t.kernels:
        return None
    return len(t.kernels) / run.jobs_traced
