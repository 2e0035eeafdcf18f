"""render_device_ms.engine: device ms a traced step of the kernels and copies
launched inside the program's `render` span (EngineFrame.render: play's
deferred frame with the HUD composited after FXAA)."""

from benchmark import trace


def read(run):
    return trace.stage_device_ms(run, ["render"])
