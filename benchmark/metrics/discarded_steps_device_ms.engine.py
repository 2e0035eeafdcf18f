"""discarded_steps_device_ms.engine: device ms a traced step of the
replayed `fixed_step` spans of the `step` root steps whose `k` is at least
the steps the tick keeps, the `sim_steps_kept` counter of the span around
the replay (`PhysicsSystem.update`): the fixed steps the engine tick runs
and throws away (`benchmark/replayed.py`). None where a replay does not
fit its layout, or the program records no replayed spans."""

from benchmark import replayed


def discarded(span, by_id):
    kept = replayed.counter_above(span, by_id, "sim_steps_kept")
    return kept is not None and span["attrs"]["k"] >= kept


def read(run):
    return replayed.device_ms(run, "step", "fixed_step", discarded)
