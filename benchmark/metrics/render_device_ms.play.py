"""render_device_ms.play: device ms a traced step of the kernels and copies
launched inside the program's `render` span (CombinedStep.render)."""

from benchmark import trace


def read(run):
    return trace.stage_device_ms(run, ["render"])
