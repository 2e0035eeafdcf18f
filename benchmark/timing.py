"""End-to-end metrics from the host-clock completion times of a window.

A step completes when the host finds its CUDA event complete. Every
metric counts every step that completes inside the window and the whole
window: no chunking, no median of parts. Where no step completed in the
window, there is no reading: None.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence


def in_window(completions: Sequence[float], t0: float, seconds: float) -> List[float]:
    """The completion times inside (t0, t0 + seconds]."""
    return [c for c in completions if t0 < c <= t0 + seconds]


def step_ms(completions: Sequence[float], t0: float, seconds: float) -> Optional[float]:
    """Window length in ms over the steps completed in it."""
    n = len(in_window(completions, t0, seconds))
    return seconds * 1e3 / n if n else None


def intervals_ms(completions: Sequence[float], t0: float, seconds: float) -> List[float]:
    """The interval before each step that completes in the window, since
    the completion before it (the first, since the window opened at t0,
    itself a completion)."""
    times = [t0] + in_window(completions, t0, seconds)
    return [(b - a) * 1e3 for a, b in zip(times, times[1:])]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between the two nearest ranks."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def step_p95_ms(completions: Sequence[float], t0: float, seconds: float
                ) -> Optional[float]:
    iv = intervals_ms(completions, t0, seconds)
    return percentile(iv, 95.0) if iv else None


def world_steps_per_s(completions: Sequence[float], t0: float, seconds: float,
                      worlds: int) -> Optional[float]:
    n = len(in_window(completions, t0, seconds))
    return worlds * n / seconds if n else None
