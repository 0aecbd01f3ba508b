"""step_s: the measured window over the whole gradient steps completed in it
(the window ends with the last step's loss in host memory)."""


def read(run):
    return run.window_s / run.jobs if run.jobs else None
