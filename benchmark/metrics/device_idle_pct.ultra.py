"""device_idle_pct: 100 x (1 - the union of kernel and copy intervals over
the traced window), the mean over the cards the cell uses."""

from benchmark import trace


def read(run):
    return trace.idle_pct(run)
