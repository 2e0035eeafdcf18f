"""world_steps_per_s: worlds x steps completed in the window, over the window."""

from benchmark import timing


def read(run):
    return timing.world_steps_per_s(run.completions, run.t0, run.seconds, run.worlds)
