"""What a traced run reads from the program's own spans and counters.

The program's tracer (`garden_tpu_torch.utils.profiler`) records a span
at each layer boundary while a profiler records: a `record_function` range
in the trace, and a record in memory with its step id, parent, device and
counters, timed on the clock kineto stamps its host events with. A root
step counts here when its root span's middle lies inside the traced window
(`trace.traced_bounds`, from the trace). Every value is per traced step:
a sum over those steps divided by `traffic["trace_steps"]`. A program
without the tracer, or a trace without the named spans, gives None.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional

from benchmark import trace

Span = Dict


def recorded() -> Optional[List[Span]]:
    """The program's recorded spans, or None where it records none."""
    try:
        from garden_tpu_torch.utils import profiler
    except ImportError:
        return None
    read = getattr(profiler, "recorded", None)
    return read() if read is not None else None


def traced_steps(run, root: str, spans: Optional[List[Span]] = None
                 ) -> Optional[List[List[Span]]]:
    """The spans of each root step whose root span is named `root` and lies
    inside the traced window, oldest first; None where there is none."""
    if not run.prof:
        return None
    spans = recorded() if spans is None else spans
    if not spans:
        return None
    ops, _, ranges = run.prof
    lo, hi = trace.traced_bounds(ranges, ops)
    roots = {s["step"] for s in spans
             if s["parent"] is None and s["name"] == root and s["end_ns"] is not None
             and lo <= (s["start_ns"] + s["end_ns"]) // 2 <= hi}
    if not roots:
        return None
    steps: Dict[int, List[Span]] = collections.defaultdict(list)
    for s in spans:
        if s["step"] in roots:
            steps[s["step"]].append(s)
    return [steps[k] for k in sorted(steps)]


def _per_step(run) -> int:
    return run.traffic["trace_steps"]


def syncs_per_step(run, root: str) -> Optional[Dict]:
    """Host synchronizations a traced step: the `syncs` of every span of
    its root steps, with the count of each span name (they add up to the
    value)."""
    steps = traced_steps(run, root)
    if steps is None:
        return None
    n = _per_step(run)
    by_span: Dict[str, int] = collections.Counter()
    for s in (s for step in steps for s in step):
        by_span[s["name"]] += s["counters"].get("syncs", 0)
    return {"value": sum(by_span.values()) / n,
            "by_span": {k: v / n for k, v in sorted(by_span.items()) if v}}


def host_ms(run, root: str, name: str) -> Optional[Dict]:
    """Host ms a traced step of the spans named `name` in the root steps,
    with the ms of each device the spans name."""
    steps = traced_steps(run, root)
    if steps is None:
        return None
    n = _per_step(run)
    found = [s for step in steps for s in step if s["name"] == name and s["end_ns"]]
    if not found:
        return None
    by_device: Dict[str, float] = collections.defaultdict(float)
    for s in found:
        by_device[str(s["device"])] += (s["end_ns"] - s["start_ns"]) / 1e6 / n
    return {"value": sum(by_device.values()), "by_device": dict(by_device)}


def ratio_pct(run, root: str, name: Optional[str], part: str, whole: str
              ) -> Optional[Dict]:
    """100 x counter `part` over counter `whole`, each summed over the
    spans named `name` (every span where None) of the root steps, with
    both sums a traced step, and both of each span name that counts
    `whole`."""
    steps = traced_steps(run, root)
    if steps is None:
        return None
    n = _per_step(run)
    by_span: Dict[str, List[float]] = {}
    for s in (s for step in steps for s in step if name is None or s["name"] == name):
        if whole in s["counters"]:
            got = by_span.setdefault(s["name"], [0.0, 0.0])
            got[0] += s["counters"].get(part, 0) / n
            got[1] += s["counters"][whole] / n
    num = sum(p for p, _ in by_span.values())
    den = sum(w for _, w in by_span.values())
    if not den:
        return None
    return {"value": 100.0 * num / den, part: num, whole: den,
            "by_span": {k: {part: p, whole: w} for k, (p, w) in sorted(by_span.items())}}


def launches_per_step(run, name: str) -> Optional[Dict]:
    """Device ops (kernels, copies, memsets) a traced step whose launch
    starts inside a range named `name`, matched to the launch by CUPTI's
    correlation id as `trace.stage_times` matches them; with the copies
    and memsets among them."""
    if not run.prof:
        return None
    ops, launches, ranges = run.prof
    kinds: Dict[int, List[str]] = collections.defaultdict(list)
    for _, _, _, op, corr in ops:
        kinds[corr].append(op)
    matched = sorted((t, kinds[c]) for t, c in launches if c in kinds)
    starts = [t for t, _ in matched]
    counts = collections.Counter()
    found = False
    for start, end, rname in ranges:
        if rname != name:
            continue
        found = True
        for _, names in matched[bisect.bisect_left(starts, start):
                                bisect.bisect_right(starts, end)]:
            for op in names:
                counts["value"] += 1
                if op.startswith("Memcpy"):
                    counts["memcpy"] += 1
                elif op.startswith("Memset"):
                    counts["memset"] += 1
    if not found:
        return None
    n = _per_step(run)
    return {k: counts[k] / n for k in ("value", "memcpy", "memset")}
