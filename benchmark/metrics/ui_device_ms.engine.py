"""ui_device_ms.engine: device ms a traced step of the kernels and copies
launched inside the program's `ui` span (the HUD's sprites composited over
the frame, `render.sprites.composite_sprites`)."""

from benchmark import trace


def read(run):
    return trace.stage_device_ms(run, ["ui"])
