"""launches_per_step.tick: device ops (kernels, copies, memsets) a traced
step launched inside the program's `physics` spans (device trace)."""

from benchmark import spans


def read(run):
    return spans.launches_per_step(run, "physics")
