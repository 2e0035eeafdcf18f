"""shadow_resolve_device_ms.ultra: device ms a traced step of the kernels
and copies launched inside the program's `csm_resolve` span: the cascade
lookup with the 5x5 PCF at every pixel."""

from benchmark import trace


def read(run):
    return trace.stage_device_ms(run, ["csm_resolve"])
