"""issue_ms.worlds: host ms from the call into WorldBatch.step to its return,
before any wait, the mean over the window's untraced steps."""

import statistics


def read(run):
    return statistics.fmean(run.issue_s) * 1e3 if run.issue_s else None
