"""Device time of the spans that a CUDA graph replay re-emits.

A replayed graph opens none of the spans of the function it replays. While
a profiler records, the program's tracer (`garden_tpu_torch.utils.profiler`)
wraps the launch in a `graph_replay` span whose `graph_ops` [0, n) counts
the graph's device ops and whose `memcpy` and `memset` list where those
kinds sit among them; under it, a zero-length record of each span of the
capture, `replayed` True, names its ops as `graph_ops` [lo, hi) in the
replay's order.

Here the program's `graph_replay` spans of the traced root steps are paired
in order, not by clock, with kineto's `graph_replay` ranges. A range's ops
are the device ops whose launch starts inside it, matched by correlation id
as `trace.stage_times` matches them, sorted by device start. A replay is
sliced only where their count is its `graph_ops` and its memcpy and memset
ops fall where its layout puts them; any other replay makes the reading
None. Nothing is guessed. A program without the replayed records reads None.

A graph instantiated while no profiler records may run its memcpy and
memset nodes as the driver's own kernels (`memcpy32_post`, `memcpy128`,
`memset32` on the H100), one op a node all the same: `op_kind` reads
either form as the node's kind.
"""

from __future__ import annotations

import bisect
import collections
from typing import Callable, Dict, List, Optional, Tuple

from benchmark import spans as program_spans

Span = Dict
Slice = Tuple[Span, List[Span], List[tuple]]    # replay, its records, its ops


def _range_ops(run) -> List[List[tuple]]:
    """The device ops launched inside each kineto `graph_replay` range, in
    the ranges' order, each list sorted by device start."""
    ops, launches, ranges = run.prof
    by_corr: Dict[int, List[tuple]] = collections.defaultdict(list)
    for op in ops:
        by_corr[op[4]].append(op)
    matched = sorted((t, c) for t, c in launches if c in by_corr)
    starts = [t for t, _ in matched]
    out = []
    for start, end, _ in sorted(r for r in ranges if r[2] == "graph_replay"):
        got = [op for _, c in matched[bisect.bisect_left(starts, start):
                                      bisect.bisect_right(starts, end)]
               for op in by_corr[c]]
        out.append(sorted(got, key=lambda op: (op[1], op[2])))
    return out


def op_kind(name: str) -> str:
    """"memcpy", "memset" or "kernel": the graph node a device op of
    this name ran."""
    for kind in ("memcpy", "memset"):
        if name.lower().startswith(kind):
            return kind
    return "kernel"


def _fits(replay: Span, ops: List[tuple]) -> bool:
    """The replay's ops are its layout's: their count, and the places of
    its memcpy and memset ops."""
    attrs = replay["attrs"]
    if "graph_ops" not in attrs or len(ops) != attrs["graph_ops"][1]:
        return False
    kinds = [op_kind(op[3]) for op in ops]
    return all([i for i, k in enumerate(kinds) if k == kind] == attrs[kind]
               for kind in ("memcpy", "memset"))


def slices(run, root: str) -> Optional[List[Slice]]:
    """(the `graph_replay` span, its replayed records, its device ops in
    device order) for each replay of the root steps named `root`; None
    without a trace, a replay, a one-to-one pairing or a replay that
    fits its layout."""
    steps = program_spans.traced_steps(run, root)
    if steps is None:
        return None
    recs = [s for step in steps for s in step]
    replays = sorted((s for s in recs if s["name"] == "graph_replay"),
                     key=lambda s: s["start_ns"])
    per_range = _range_ops(run)
    if not replays or len(replays) != len(per_range):
        return None
    children: Dict[int, List[Span]] = collections.defaultdict(list)
    for s in recs:
        if s["attrs"].get("replayed"):
            children[s["parent"]].append(s)
    out = []
    for replay, ops in zip(replays, per_range):
        if not _fits(replay, ops):
            return None
        mine, todo = [], [replay["id"]]
        while todo:
            kids = children.get(todo.pop(), [])
            mine += kids
            todo += [s["id"] for s in kids]
        out.append((replay, mine, ops))
    return out


def device_ms(run, root: str, name: str,
              keep: Optional[Callable[[Span, Dict[int, Span]], bool]] = None
              ) -> Optional[Dict]:
    """Device ms a traced step of the replayed records named `name` that
    `keep(record, spans by id)` selects (all where None), with the count
    of replays sliced; None where `slices` is None or no replay holds a
    record of that name."""
    got = slices(run, root)
    if got is None:
        return None
    by_id = {s["id"]: s for step in program_spans.traced_steps(run, root) for s in step}
    ns, found = 0, False
    for _, recs, ops in got:
        for s in recs:
            if s["name"] != name:
                continue
            found = True
            if keep is None or keep(s, by_id):
                lo, hi = s["attrs"]["graph_ops"]
                ns += sum(op[2] - op[1] for op in ops[lo:hi])
    if not found:
        return None
    return {"value": ns / 1e6 / run.traffic["trace_steps"], "replays": len(got)}


def counter_above(span: Span, by_id: Dict[int, Span], name: str) -> Optional[int]:
    """Counter `name` of the nearest span above `span` that has it."""
    parent = span["parent"]
    while parent is not None:
        s = by_id[parent]
        if name in s["counters"]:
            return s["counters"][name]
        parent = s["parent"]
    return None
