"""film_sum_ms.frame: device time, a frame, of the kernels launched inside
the program's `misaki.film_sum` spans on the thread that opened them (the
film's all-reduce over the ranks: NCCL's kernel on rank 0's card), in ms.
The kernel runs from rank 0's arrival at the sum until the last rank's film
is in, so a rank that arrives first also counts its wait for the others."""

FILM_SUM = "misaki.film_sum"


def read(run):
    t = run.trace
    if t is None or not run.jobs_traced:
        return None
    kernels = t.kernels_launched_within(FILM_SUM)
    if not kernels:
        return None
    return sum(float(k["dur"]) for k in kernels) * 1e-3 / run.jobs_traced
