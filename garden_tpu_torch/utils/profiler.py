"""Frame profiling.

Port of `garden_tpu.utils.profiler`. `zone()` is a `torch.profiler`
`record_function` range (the mechanism of the physics stages' ranges), so
it shows in traces; `trace()` captures a `torch.profiler` trace of the host
and the card and writes it into a directory as a Chrome trace;
`FrameProfiler` keeps per-pass wall-clock times, synchronizing the pass's
result's device, and frame marks.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def zone(name: str) -> Iterator[None]:
    """A named range: appears in torch.profiler traces."""
    with record_function(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Capture a torch.profiler trace of the host and, where there is one,
    the card, and write it to `log_dir`/TRACE_FILE as a Chrome trace.
    Yields the profiler (its `key_averages()` and `events()` stay readable
    after the block)."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _synchronize(result) -> None:
    """Wait for the device of every tensor in `result` (a tensor or a
    nested dict, list or tuple of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)


class FrameProfiler:
    """Wall-clock pass timings with running averages."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self.averages: Dict[str, float] = defaultdict(float)
        self._frame_start: Optional[float] = None
        self.frame_ms = 0.0
        self.fps = 0.0

    @contextlib.contextmanager
    def pass_timer(self, name: str, result=None) -> Iterator[None]:
        """Time a pass; pass the output tensor(s) to wait on its device, so
        the time includes the device's work."""
        t0 = time.perf_counter()
        yield
        if result is not None:
            _synchronize(result)
        dt = (time.perf_counter() - t0) * 1000.0
        old = self.averages[name]
        self.averages[name] = old * self.smoothing + dt * (1 - self.smoothing) \
            if old else dt

    def frame_mark(self) -> None:
        """Call once per frame."""
        now = time.perf_counter()
        if self._frame_start is not None:
            dt = (now - self._frame_start) * 1000.0
            self.frame_ms = self.frame_ms * self.smoothing + dt * (1 - self.smoothing) \
                if self.frame_ms else dt
            self.fps = 1000.0 / max(self.frame_ms, 1e-6)
        self._frame_start = now

    def report(self) -> str:
        lines = [f"frame: {self.frame_ms:.2f} ms ({self.fps:.1f} fps)"]
        for name, ms in sorted(self.averages.items()):
            lines.append(f"  {name}: {ms:.2f} ms")
        return "\n".join(lines)
