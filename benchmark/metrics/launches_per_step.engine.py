"""launches_per_step.engine: device ops (kernels, copies, memsets) a traced
step launched inside the program's `step` spans (EngineFrame.__call__;
device trace)."""

from benchmark import spans


def read(run):
    return spans.launches_per_step(run, "step")
