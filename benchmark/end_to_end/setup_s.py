"""setup_s: seconds from the process's start to the first timed job (torch
and CUDA initialised, the scene compiled, the kernels built or loaded, the
warm-up job or the first steps run)."""


def read(run):
    return run.setup_s
