"""step_p95_ms: the 95th percentile of the intervals between consecutive
step completions, over every step of the window."""

from benchmark import timing


def read(run):
    return timing.step_p95_ms(run.completions, run.t0, run.seconds)
