"""physics_device_ms.worlds: device ms a world-step of the kernels and copies
launched inside WorldBatch.step, summed over the cards."""

from benchmark import trace


def read(run):
    ms = trace.stage_device_ms(run, ["bench.step"])
    return ms / run.worlds if ms is not None else None
