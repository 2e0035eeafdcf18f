"""The port's tracer: spans and counters, recorded while a profiler records.

Port of `garden_tpu.utils.profiler`. Every range the port marks goes
through `span(name, **attrs)`:

- While no `torch.profiler` session is recording (judged from the
  profiler's own state) and no CUDA graph captures, a span is one check
  and nothing else: no range, no clock read, no record.
- While one records, a span is a `record_function` range, so traces show it
  beside the device ops, and the recorder keeps its record: name, start and
  end ns, parent span, step id, device index, attributes and counters. The
  ns are `time.time_ns()`, the clock kineto stamps its host events with,
  read just before the range opens and just after it closes, so a record
  encloses kineto's event of the same span by a few us and lays over the
  device trace. The range opens and closes without dispatching an
  operator of its own, as `record_function` does: recording that
  operator put 25-65 us between the clock read and kineto's stamp of the
  start on the H100 hosts. Only a session's first event on a thread
  still starts later, by the set-up of that thread's event queue (about
  0.1-0.2 ms there). A span opened with no span open around it is a root
  and takes a new step id; every span inside it carries that id. The
  recorder keeps the last MAX_STEPS root steps.

Counters (`count`) are charged to the innermost open span, only while
recording; guard any work that computes one with `recording()`. A root
span on a card sets `torch.cuda.set_sync_debug_mode("warn")` for its
length and counts each warning as one of the open span's `syncs` (host
synchronizations); the previous mode and warning filters come back on its
exit. A counter given as a device tensor stays one: a traced step adds
reductions, never a read-back. `recorded()` reads every such counter to the
host once and returns the spans as plain numbers; `trace(log_dir)` captures
a profiler session and writes its Chrome trace and its spans.

A CUDA graph replay opens none of the spans of the function it replays, so
the graph keeps their layout from its capture (`utils.cuda_graph`):

- While `capture(mark)` is open around the captured function, every span
  also records a `Layout` entry, recording profiler or not: its name and
  attributes, its parent entry, and `mark()` read as it opens and as it
  closes. After the capture, `Layout.resolve(position)` turns each mark
  into the count of device-op nodes (kernels, memsets, memcpys) captured
  before it, so an entry holds `ops = (lo, hi)`, the nodes captured while
  it was open, in capture order.
- While a profiler records, `replay(layout)` is the span `graph_replay`
  around the replay's launch, with `graph_ops` [0, n) and the indices of
  its `memcpy` and `memset` nodes. On entering it emits one record an
  entry, nested as the layout is, the replay span their root parent, in
  its step and on its device: `attrs` the entry's plus `replayed` True and
  `graph_ops` [lo, hi); zero host length (start and end the replay span's
  start); `syncs` 0 and no other counter. Off, `replay` is `span`'s no-op.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
import warnings
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
MAX_STEPS = 64
SYNC_WARNING = "called a synchronizing CUDA operation"

_AUTOGRAD_PROFILER = torch.autograd.profiler
# a range of the trace as `record_function` opens one (a user annotation),
# opened and closed without dispatching an operator of its own
_open_range = torch._C._autograd._record_function_with_args_enter
_close_range = torch._C._autograd._record_function_with_args_exit
_LAYOUT: Optional["Layout"] = None         # the layout a graph capture records


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
        self._range = _open_range(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        _close_range(self._range)
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

    def emit(self, root: Span, entries: List[Dict[str, Any]]) -> None:
        """A record a layout entry under the open span `root`, in its
        step and on its device, with zero host length at its start."""
        ids: List[int] = []
        for e in entries:
            s = Span(e["name"], dict(e["attrs"], replayed=True, graph_ops=list(e["ops"])))
            s.start_ns = s.end_ns = root.start_ns
            s.parent = root.id if e["parent"] is None else ids[e["parent"]]
            s.step, s.device, s.id = root.step, root.device, self.next_id
            self.next_id += 1
            ids.append(s.id)
            self.steps[-1].append(s)

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


class Layout:
    """The spans a function opens while a CUDA graph captures it (the
    module's docstring). `entries` holds, in opening order, dicts of
    `name`, `attrs` (without `device`) and `parent` (an entry's index or
    None), and after `resolve` `ops` (lo, hi); `ops` is the graph's count
    of device-op nodes, `memcpy` and `memset` the indices of those kinds
    among them."""

    def __init__(self, mark: Callable[[], Any]):
        self.mark = mark
        self.entries: List[Dict[str, Any]] = []
        self.stack: List[int] = []
        self.ops = 0
        self.memcpy: List[int] = []
        self.memset: List[int] = []

    def open(self, name: str, attrs: Dict[str, Any]) -> int:
        self.entries.append({"name": name,
                             "attrs": {k: v for k, v in attrs.items() if k != "device"},
                             "parent": self.stack[-1] if self.stack else None,
                             "marks": (self.mark(),)})
        self.stack.append(len(self.entries) - 1)
        return self.stack[-1]

    def close(self, i: int) -> None:
        self.stack.pop()
        self.entries[i]["marks"] += (self.mark(),)

    def resolve(self, position: Callable[[Any], int], kinds: List[str]) -> "Layout":
        """Each entry's marks as device-op node counts (`position`), and
        the graph's device-op nodes by kind ("kernel", "memcpy",
        "memset"), in capture order."""
        for e in self.entries:
            e["ops"] = tuple(position(m) for m in e.pop("marks"))
        self.ops = len(kinds)
        self.memcpy = [i for i, k in enumerate(kinds) if k == "memcpy"]
        self.memset = [i for i, k in enumerate(kinds) if k == "memset"]
        return self


class _Captured:
    """A span opened while a graph captures: a layout entry, and the
    recorded span too where a profiler records."""
    __slots__ = ("layout", "name", "attrs", "inner", "index")

    def __init__(self, layout: Layout, name: str, attrs: Dict[str, Any],
                 inner: Optional[Span]):
        self.layout, self.name, self.attrs, self.inner = layout, name, attrs, inner

    def __enter__(self) -> Optional[Span]:
        if self.inner is not None:
            self.inner.__enter__()
        self.index = self.layout.open(self.name, self.attrs)
        return self.inner

    def __exit__(self, *exc) -> bool:
        self.layout.close(self.index)
        if self.inner is not None:
            self.inner.__exit__(*exc)
        return False


class _Replay(Span):
    """The span `graph_replay` of one replay, emitting its layout's
    records as it opens."""
    __slots__ = ("layout",)

    def __init__(self, layout: Optional[Layout]):
        attrs = {} if layout is None else {"graph_ops": [0, layout.ops],
                                           "memcpy": list(layout.memcpy),
                                           "memset": list(layout.memset)}
        super().__init__("graph_replay", attrs)
        self.layout = layout

    def __enter__(self) -> "_Replay":
        super().__enter__()
        if self.layout is not None:
            RECORDER.emit(self, self.layout.entries)
        return self


def span(name: str, **attrs):
    """A named span of the program (see the module's docstring): `with
    span("render"):`. `device=` (a device or a card's index) sets the
    span's device; other attributes are kept in its record."""
    if not _AUTOGRAD_PROFILER._is_profiler_enabled:
        return _OFF if _LAYOUT is None else _Captured(_LAYOUT, name, attrs, None)
    if _LAYOUT is None:
        return Span(name, attrs)
    return _Captured(_LAYOUT, name, attrs, Span(name, dict(attrs)))


@contextlib.contextmanager
def capture(mark: Callable[[], Any]) -> Iterator[Layout]:
    """Record the layout of the spans opened inside the block, reading
    `mark()` at each span's edges (the module's docstring)."""
    global _LAYOUT
    outer, _LAYOUT = _LAYOUT, Layout(mark)
    try:
        yield _LAYOUT
    finally:
        _LAYOUT = outer


def replay(layout: Optional[Layout]):
    """The span `graph_replay` around one replay of a graph whose capture
    recorded `layout` (None: no records under it); off, `span`'s no-op."""
    if not _AUTOGRAD_PROFILER._is_profiler_enabled:
        return _OFF
    return _Replay(layout)


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
    """{span name: mean host ms of its closed spans}; a replayed record,
    which has no host time, is left out."""
    total: Dict[str, List[float]] = collections.defaultdict(list)
    for s in spans:
        if s["end_ns"] is not None and not s["attrs"].get("replayed"):
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
