"""render_ms.play: host ms of CombinedStep.render, the device synchronized
before and after, the mean over the traced run's stage-by-stage steps."""

import statistics


def read(run):
    ms = run.spans.get("render")
    return statistics.fmean(ms) if ms else None
