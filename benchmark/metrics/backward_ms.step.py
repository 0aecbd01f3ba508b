"""backward_ms.step: device time, per gradient step, of the kernels launched
inside the profiler's `autograd::engine::evaluate_function` ranges (the
backward pass of each step), in ms."""

PREFIX = "autograd::engine::evaluate_function"


def read(run):
    t = run.trace
    if t is None or not run.jobs_traced:
        return None
    kernels = t.kernels_launched_within(PREFIX)
    if not kernels:
        return None
    return sum(float(k["dur"]) for k in kernels) * 1e-3 / run.jobs_traced
