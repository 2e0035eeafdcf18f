"""character_device_ms.engine: device ms a traced step of the kernels and
copies launched inside the program's `CharacterSystem.update` span (the
characters' velocity control and their stair and floor sphere casts)."""

from benchmark import trace


def read(run):
    return trace.stage_device_ms(run, ["CharacterSystem.update"])
