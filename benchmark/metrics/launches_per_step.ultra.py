"""launches_per_step.ultra: device ops (kernels, copies, memsets) a traced
step launched inside the program's `step` spans (device trace)."""

from benchmark import spans


def read(run):
    return spans.launches_per_step(run, "step")
