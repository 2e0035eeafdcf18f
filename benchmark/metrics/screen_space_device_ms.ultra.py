"""screen_space_device_ms.ultra: device ms a traced step of the kernels and
copies launched inside the program's `ssr` span (the reflection march,
`render.ssr.trace`) and its `ssgi` span (the GI gather,
`render.ssgi.compute_ssgi`)."""

from benchmark import trace


def read(run):
    return trace.stage_device_ms(run, ["ssr", "ssgi"])
