"""broadphase_device_ms.tick: device ms a traced step of the replayed
`broadphase` spans of the `physics` root steps, the ops each names in its
graph replay (`benchmark/replayed.py`). None where a replay does not fit
its layout, or the program records no replayed spans."""

from benchmark import replayed


def read(run):
    return replayed.device_ms(run, "physics", "broadphase")
