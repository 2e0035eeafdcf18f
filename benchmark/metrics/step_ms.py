"""step_ms: the window's length in ms over the steps completed in it."""

from benchmark import timing


def read(run):
    return timing.step_ms(run.completions, run.t0, run.seconds)
