"""tick_device_ms.engine: device ms a traced step of the kernels and copies
launched inside the program's `tick` span (EngineFrame.tick: the Engine's
Input, Update and Output)."""

from benchmark import trace


def read(run):
    return trace.stage_device_ms(run, ["tick"])
