"""forward_ms.step: device time, per gradient step, of the kernels launched
inside the program's `misaki.chunk` spans (the render under autograd), on
the thread that opened them, in ms. The backward's kernels are launched by
the autograd engine's thread (backward_ms.step), so the two do not
overlap."""

from benchmark import program_spans as ps


def read(run):
    t = run.trace
    if t is None or not run.jobs_traced:
        return None
    kernels = t.kernels_launched_within(ps.CHUNK)
    if not kernels:
        return None
    return sum(float(k["dur"]) for k in kernels) * 1e-3 / run.jobs_traced
