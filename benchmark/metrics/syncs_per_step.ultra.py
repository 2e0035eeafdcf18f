"""syncs_per_step.ultra: host synchronizations a traced step, the `syncs`
counters of every span of the program's `step` root steps, with the count
of each span name."""

from benchmark import spans


def read(run):
    return spans.syncs_per_step(run, "step")
