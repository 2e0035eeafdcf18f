"""launches_per_step.worlds: device ops (kernels, copies, memsets) a traced
step launched inside the program's `worlds.step` spans, over every card
(device trace)."""

from benchmark import spans


def read(run):
    return spans.launches_per_step(run, "worlds.step")
