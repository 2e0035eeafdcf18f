"""tick_ms.engine: host ms of EngineFrame.tick (the Engine's Input, Update
and Output), the device synchronized before and after, the mean over the
traced run's stage-by-stage steps."""

import statistics


def read(run):
    ms = run.spans.get("tick")
    return statistics.fmean(ms) if ms else None
