"""What a traced run reads from the profiler, reduced in memory.

`stage_times` is a frozen copy of `tools/profile_torch_step.stage_times`:
a range's device time is that of the kernels and copies whose launch
starts inside it, matched by CUPTI's correlation id, so the hand kernels,
which launch through ctypes outside any PyTorch operator, count. The rest
works on plain tuples, so the tests can feed it a synthetic trace:

    device op: (device index, start ns, end ns, name, correlation id)
    launch:    (start ns, correlation id)          a `cu*` runtime call
    range:     (start ns, end ns, name)            a record_function range
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DeviceOp = Tuple[int, int, int, str, int]
Launch = Tuple[int, int]
Range = Tuple[int, int, str]


def from_profiler(prof) -> Tuple[List[DeviceOp], List[Launch], List[Range]]:
    """The device ops, launches and ranges of a finished torch.profiler run."""
    from torch.autograd import DeviceType
    ops, launches, ranges = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            start = e.start_ns()
            ops.append((e.device_index(), start, start + e.duration_ns(), e.name(),
                        e.correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            if e.is_user_annotation():
                ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.name().startswith("cu"):
                launches.append((e.start_ns(), e.correlation_id()))
    return ops, launches, ranges


def stage_times(ops: Sequence[DeviceOp], launches: Sequence[Launch],
                ranges: Sequence[Range], names: Iterable[str]) -> Dict[str, Tuple[int, int]]:
    """{name: (host ns, device ns)} summed over every occurrence of each
    named range; a range's device time is that of the ops whose launch
    starts inside it."""
    names = set(names)
    dev_ns = collections.Counter()
    for _, start, end, _, corr in ops:
        dev_ns[corr] += end - start
    matched = sorted((t, dev_ns[c]) for t, c in launches if c in dev_ns)
    starts = [t for t, _ in matched]
    prefix = [0]
    for _, ns in matched:
        prefix.append(prefix[-1] + ns)
    out: Dict[str, Tuple[int, int]] = {}
    for start, end, name in ranges:
        if name not in names:
            continue
        lo = bisect.bisect_left(starts, start)
        hi = bisect.bisect_right(starts, end)
        host, dev = out.get(name, (0, 0))
        out[name] = (host + end - start, dev + prefix[hi] - prefix[lo])
    return out


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Overlapping or touching intervals merged, in order."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_ns(ops: Sequence[DeviceOp], device: int, lo: int, hi: int) -> int:
    """ns of [lo, hi] in which some op ran on `device`."""
    spans = union((max(s, lo), min(e, hi)) for d, s, e, _, _ in ops
                  if d == device and e > lo and s < hi)
    return sum(e - s for s, e in spans)


def idle_gaps(ops: Sequence[DeviceOp], ranges: Sequence[Range], device: int,
              lo: int, hi: int, top: int = 10) -> List[List]:
    """The `top` longest spans of [lo, hi] in which `device` ran nothing,
    each named by the innermost range open on the host at its middle:
    [[name, seconds], ...], longest first."""
    spans = union((max(s, lo), min(e, hi)) for d, s, e, _, _ in ops
                  if d == device and e > lo and s < hi)
    edges = [lo] + [t for span in spans for t in span] + [hi]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                  reverse=True)[:top]
    out = []
    for ns, a, b in gaps:
        mid = (a + b) // 2
        open_ = [r for r in ranges if r[0] <= mid <= r[1]]
        name = max(open_)[2] if open_ else "host outside any range"
        out.append([name, ns / 1e9])
    return out


def device_ops(ops: Sequence[DeviceOp], top: int = 10, width: int = 160) -> List[List]:
    """The `top` device ops by total time: [[name, seconds], ...], each
    name cut to `width` characters."""
    total = collections.Counter()
    for _, s, e, name, _ in ops:
        total[name] += e - s
    return [[name[:width], ns / 1e9] for name, ns in total.most_common(top)]


def traced_bounds(ranges: Sequence[Range], ops: Sequence[DeviceOp]) -> Tuple[int, int]:
    """The traced window: from the start of the first `bench.step` range to
    the end of the last step range or device op, whichever is later."""
    steps = [r for r in ranges if r[2] == "bench.step"]
    lo = min(r[0] for r in steps)
    hi = max([r[1] for r in steps] + [e for _, _, e, _, _ in ops])
    return lo, hi


def stage_device_ms(run, names: Sequence[str]) -> Optional[float]:
    """Device ms per traced step of the ops launched inside the named
    ranges, summed over every card; None without a trace or a launch."""
    if not run.prof:
        return None
    ops, launches, ranges = run.prof
    got = stage_times(ops, launches, ranges, names)
    ns = sum(dev for _, dev in got.values())
    return ns / 1e6 / run.traffic["trace_steps"] if ns else None


def cards(devices) -> List[int]:
    """The device indices of a run's cards, each once."""
    return sorted({d.index or 0 for d in devices})


def busy_and_window(prof, devices) -> Tuple[float, int, int]:
    """(busy ns averaged over the cards, window start, window end)."""
    ops, _, ranges = prof
    lo, hi = traced_bounds(ranges, ops)
    busy = [busy_ns(ops, i, lo, hi) for i in cards(devices)]
    return sum(busy) / len(busy), lo, hi


def idle_pct(run) -> Optional[float]:
    """100 x (1 - device busy / traced window), the mean over the cards."""
    if not run.prof:
        return None
    busy, lo, hi = busy_and_window(run.prof, run.devices)
    return 100.0 * (1.0 - busy / (hi - lo))
