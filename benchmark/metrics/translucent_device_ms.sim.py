"""translucent_device_ms.sim: device ms a traced step of the kernels and
copies launched inside the program's non-opaque passes: the `oit`,
`refraction`, `sorted` and `trans_depth` spans (their set-up, binning and
kernels K7, K5, K6 and K4)."""

from benchmark import trace


def read(run):
    return trace.stage_device_ms(run, ["oit", "refraction", "sorted", "trans_depth"])
