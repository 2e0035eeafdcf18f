"""The port's tracer: spans and counters, recorded while a profiler records.

Port of `garden_tpu.utils.profiler`. Every range the port marks goes
through `span(name, **attrs)`:

- While no `torch.profiler` session is recording (judged from the
  profiler's own state), a span is one check and nothing else: no range, no
  clock read, no record.
- While one records, a span is a `record_function` range, so traces show it
  beside the device ops, and the recorder keeps its record: name, start and
  end ns, parent span, step id, device index, attributes and counters. The
  ns are `time.time_ns()`, the clock kineto stamps its host events with,
  read just outside the range, so a record encloses kineto's event of the
  same span by a few us and lays over the device trace. A span opened with
  no span open around it is a root and takes a new step id; every span
  inside it carries that id. The recorder keeps the last MAX_STEPS root
  steps.

Counters (`count`) are charged to the innermost open span, only while
recording; guard any work that computes one with `recording()`. A root
span on a card sets `torch.cuda.set_sync_debug_mode("warn")` for its
length and counts each warning as one of the open span's `syncs` (host
synchronizations); the previous mode and warning filters come back on its
exit. A counter given as a device tensor stays one: a traced step adds
reductions, never a read-back. `recorded()` reads every such counter to the
host once and returns the spans as plain numbers; `trace(log_dir)` captures
a profiler session and writes its Chrome trace and its spans.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
import warnings
from typing import Any, Deque, Dict, Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
MAX_STEPS = 64
SYNC_WARNING = "called a synchronizing CUDA operation"

_AUTOGRAD_PROFILER = torch.autograd.profiler


class _Off:
    """The span while nothing records."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _device_index(device) -> Optional[int]:
    if isinstance(device, int) or device is None:
        return device
    device = torch.device(device)
    return device.index if device.type == "cuda" else None


class Span:
    """One recorded span; a context manager that opens and closes it."""
    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "step", "device",
                 "attrs", "counters", "pending", "_range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.counters: Dict[str, int] = {"syncs": 0}
        self.pending: List = []              # (name, 0-d device tensor)
        self.end_ns: Optional[int] = None

    def __enter__(self) -> "Span":
        RECORDER.open(self)
        self.start_ns = time.time_ns()
        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        self._range = None
        RECORDER.close(self)
        return False

    def as_dict(self) -> Dict[str, Any]:
        return {"id": self.id, "name": self.name, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "parent": self.parent, "step": self.step,
                "device": self.device, "attrs": dict(self.attrs),
                "counters": dict(self.counters)}


class Recorder:
    """The spans of the last `max_steps` root steps, and the open spans."""

    def __init__(self, max_steps: int = MAX_STEPS):
        self.steps: Deque[List[Span]] = collections.deque(maxlen=max_steps)
        self.stack: List[Span] = []
        self.next_step = 0
        self.next_id = 0
        self._on_card: Optional[bool] = None
        self._sync_state = None

    def open(self, s: Span) -> None:
        parent = self.stack[-1] if self.stack else None
        if parent is None:
            s.step = self.next_step
            self.next_step += 1
            self.steps.append([])
            default = (torch.cuda.current_device() if torch.cuda.is_initialized()
                       else None)
        else:
            s.step = parent.step
            default = parent.device
        s.parent = parent.id if parent else None
        s.device = _device_index(s.attrs.pop("device")) if "device" in s.attrs else default
        s.id = self.next_id
        self.next_id += 1
        self.steps[-1].append(s)
        self.stack.append(s)
        if parent is None:
            self._count_syncs()

    def close(self, s: Span) -> None:
        self.stack.pop()
        if not self.stack:
            self._stop_counting_syncs()

    def _count_syncs(self) -> None:
        if self._on_card is None:
            self._on_card = torch.cuda.is_available()
        if not self._on_card:
            return
        filters = warnings.catch_warnings()
        filters.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        show = warnings.showwarning

        def on_warning(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING) and self.stack:
                self.stack[-1].counters["syncs"] += 1
            else:
                show(message, category, filename, lineno, file, line)
        warnings.showwarning = on_warning
        self._sync_state = (torch.cuda.get_sync_debug_mode(), filters)
        torch.cuda.set_sync_debug_mode("warn")

    def _stop_counting_syncs(self) -> None:
        if self._sync_state is None:
            return
        mode, filters = self._sync_state
        self._sync_state = None
        torch.cuda.set_sync_debug_mode(mode)
        filters.__exit__(None, None, None)

    def spans(self) -> List[Span]:
        """Every kept span, each device-side counter read to the host once:
        one read a device for all of them."""
        spans = [s for step in self.steps for s in step]
        by_device: Dict[torch.device, List] = collections.defaultdict(list)
        for s in spans:
            for name, value in s.pending:
                by_device[value.device].append((s, name, value))
            s.pending = []
        for parts in by_device.values():
            values = torch.stack([v.reshape(()).to(torch.int64) for _, _, v in parts])
            for (s, name, _), v in zip(parts, values.tolist()):
                s.counters[name] = s.counters.get(name, 0) + v
        return spans


RECORDER = Recorder()


def span(name: str, **attrs):
    """A named span of the program (see the module's docstring): `with
    span("render"):`. `device=` (a device or a card's index) sets the
    span's device; other attributes are kept in its record."""
    if not _AUTOGRAD_PROFILER._is_profiler_enabled:
        return _OFF
    return Span(name, attrs)


def recording() -> bool:
    """Whether a recorded span is open, so a counter would be kept."""
    return bool(RECORDER.stack)


def count(name: str, value) -> None:
    """Add `value` (an int, or a 0-d integer tensor kept on its device) to
    counter `name` of the innermost open span; nothing while not
    recording, or for a tensor inside a vmap (a world of a batch)."""
    if not RECORDER.stack:
        return
    s = RECORDER.stack[-1]
    if isinstance(value, torch.Tensor):
        if torch._C._functorch.is_batchedtensor(value):
            return
        s.pending.append((name, value.detach()))
        s.counters.setdefault(name, 0)
    else:
        s.counters[name] = s.counters.get(name, 0) + int(value)


def recorded() -> List[Dict[str, Any]]:
    """The recorder's spans, oldest first, as dicts of plain numbers: id,
    name, start_ns, end_ns, parent (an id or None), step, device (a card's
    index or None), attrs and counters."""
    return [s.as_dict() for s in RECORDER.spans()]


def host_ms(spans: List[Dict[str, Any]]) -> Dict[str, float]:
    """{span name: mean host ms of its closed spans}."""
    total: Dict[str, List[float]] = collections.defaultdict(list)
    for s in spans:
        if s["end_ns"] is not None:
            total[s["name"]].append((s["end_ns"] - s["start_ns"]) / 1e6)
    return {name: sum(ms) / len(ms) for name, ms in total.items()}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Capture a torch.profiler trace of the host and, where there is one,
    the card, and write it to `log_dir`/TRACE_FILE as a Chrome trace and the
    spans recorded meanwhile to `log_dir`/SPANS_FILE (`recorded()`'s
    dicts). Yields the profiler (its `key_averages()` and `events()` stay
    readable after the block)."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = RECORDER.next_step
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    with open(os.path.join(log_dir, SPANS_FILE), "w", encoding="utf-8") as f:
        json.dump([s for s in recorded() if s["step"] >= first], f)
