"""frame_s: the measured window over the whole frames completed in it (the
window ends with the last frame's image in host memory)."""


def read(run):
    return run.window_s / run.jobs if run.jobs else None
