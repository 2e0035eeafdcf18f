"""physics_device_ms.tick: device ms a step of the kernels and copies launched
inside the physics step (the harness's `bench.step` range around it)."""

from benchmark import trace


def read(run):
    return trace.stage_device_ms(run, ["bench.step"])
