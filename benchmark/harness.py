"""One run of one cell: build, warm up, measure, check, report.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration file, its traffic file `traffic/<traffic>.json`, whose
`entry` names the module `entries/<entry>.py` that drives the program, its limits
`limits/<workload>.json`, and each metric's reader `metrics/<metric>.py`.

The loop is closed and the same for every cell: step n + 1 is issued only
once step n + 1 - `in_flight` has completed, and a step completes when the
host finds the CUDA event recorded after its last output complete, on
every device it ran on. The window opens at the completion of the last
warm-up step and lasts `seconds`; every step that completes inside it
counts.
"""

from __future__ import annotations

import collections
import importlib
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from benchmark import check, trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "garden_tpu")


def load_cell(name: str, spec: Optional[Dict] = None) -> Dict[str, Any]:
    """The cell `name` with its configuration, traffic and limits."""
    spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    limits = BENCH / "limits" / f"{name}.json"
    return {"spec": spec, "cell": cell,
            "config": json.loads((ROOT / conf["file"]).read_text()),
            "traffic": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads(limits.read_text()) if limits.exists() else {}}


def entry(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")


def reader(metric: str):
    """The `read(run)` function of metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: Dict, cell: str, kind: str) -> List[Dict]:
    """The metrics of `kind` (end_to_end or per_layer) this cell reports: a
    metric with `workloads` in those cells, an end-to-end one without in
    every cell, a per-layer one without wherever its `moves` is reported."""
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            cells = m["workloads"]
        elif kind == "per_layer":
            cells = e2e[m["moves"]].get("workloads", [cell])
        else:
            cells = [cell]
        if cell in cells:
            out.append(m)
    return out


def sample_steps(seed: int, traffic: Dict) -> List[int]:
    """The window steps whose outputs the check compares, drawn from the
    seed among the first `check_within`; the window's last step is added
    once it is known."""
    gen = torch.Generator().manual_seed(seed % 2 ** 62)
    picks = torch.randperm(traffic["check_within"], generator=gen)[:traffic["check_steps"]]
    return sorted(int(p) for p in picks)


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(name: str, seed: int, seconds: float, traced: bool, devices: List,
             start: float, loaded: Optional[Dict] = None,
             controls=()) -> Dict[str, Any]:
    """One run of cell `name` on `devices` -> the result line's dict, with
    the compared numbers under "checks". `start` is the host clock at the
    process's start. Each mode in `controls` also puts the reference in
    that precision in the program's place over the same kept steps, its
    widest numbers under "controls" (calibrate.py)."""
    c = loaded or load_cell(name)
    traffic, cfg = c["traffic"], c["config"]
    devices = [torch.device(d) for d in devices]
    on_card = devices[0].type == "cuda"
    drv = entry(traffic["entry"]).build(cfg, traffic, seed, devices)
    in_flight, warmup = traffic["in_flight"], traffic["warmup_steps"]
    sample = set(sample_steps(seed, traffic))

    def record():
        if not on_card:
            return []
        evs = []
        for d in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            evs.append(ev)
        return evs

    pending: collections.deque = collections.deque()
    completions: List[float] = []
    issue_s: List[float] = []
    kept: Dict[int, Any] = {}
    recent: collections.deque = collections.deque(maxlen=in_flight + 2)
    issued = 0

    def issue(tag: Optional[str] = None):
        nonlocal issued
        t = time.perf_counter()
        if tag:
            with torch.profiler.record_function(tag):
                drv.step()
        else:
            drv.step()
        issue_s.append(time.perf_counter() - t)
        pending.append(record())
        w = issued - warmup
        if w in sample:
            kept[w] = drv.snapshot()
        recent.append((w, drv.snapshot()))
        issued += 1

    def complete_oldest() -> float:
        for ev in pending.popleft():
            ev.synchronize()
        t = time.perf_counter()
        completions.append(t)
        return t

    def drain():
        while pending:
            complete_oldest()

    while len(completions) < warmup:
        issue()
        if len(pending) >= in_flight:
            complete_oldest()
    t0 = completions[-1]
    setup_s = t0 - start
    del issue_s[:]
    prof_data, spans, traced_window = None, {}, None
    trace_start = traffic["trace_start"] if traced else -1
    while True:
        if issued - warmup == trace_start:
            drain()
            n_before = len(issue_s)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            for _ in range(traffic["trace_steps"]):
                issue("bench.step")
                if len(pending) >= in_flight:
                    complete_oldest()
            drain()
            prof.stop()
            traced_window = (n_before, len(issue_s))
            prof_data = trace.from_profiler(prof)
            del prof
            spans = drv.spans(traffic["span_steps"])
            if time.perf_counter() > t0 + seconds:
                break
        issue()
        if len(pending) >= in_flight and complete_oldest() > t0 + seconds:
            break
    drain()
    last = len([t for t in completions if t0 < t <= t0 + seconds]) - 1
    for w, snap in recent:
        if w == last:
            kept[w] = snap
    kept = {w: s for w, s in kept.items() if w <= last}
    peak = (max(torch.cuda.max_memory_allocated(d) for d in devices) if on_card else 0)
    window_issue = issue_s
    if traced_window:
        window_issue = issue_s[:traced_window[0]] + issue_s[traced_window[1]:]
    run = Run(name=name, cell=c["cell"], config=cfg, traffic=traffic, devices=devices,
              worlds=drv.worlds, seconds=seconds, t0=t0, completions=completions,
              setup_s=setup_s, issue_s=window_issue, spans=spans, prof=prof_data,
              power_limit_w=power_limit_w() if on_card else None,
              peaks=json.loads((BENCH / "peaks.json").read_text()),
              kind=torch.cuda.get_device_name(devices[0]) if on_card else "cpu")

    # the check: every kept step against the reference, the program's
    # live state freed first
    initial = drv.initial
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    numbers: Dict[str, float] = {}
    failed = 0
    ctl: Dict[str, Dict[str, float]] = {}
    try:
        per_step = drv.check(initial, [kept[w] for w in sorted(kept)])
        for nums in per_step:
            ok, _ = check.judge(nums, c["limits"])
            failed += not ok
            check.widest(numbers, nums)
        correct, checks = check.judge(numbers, c["limits"])
        if controls:
            steps = [kept[w] for w in sorted(kept)]
            for mode in controls:
                ctl[mode] = {}
                for nums in drv.check(initial, steps, mode):
                    check.widest(ctl[mode], nums)
    except Exception:                      # a check that cannot run is a failure
        print(f"the check failed to run:\n{traceback.format_exc()}", file=sys.stderr)
        correct, checks, failed = False, {}, max(failed, 1)

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_of(c["spec"], name, kind):
        value = reader(m["name"])(run)
        if value is None:
            continue
        extra = value if isinstance(value, dict) else {"value": value}
        metrics[m["name"]] = dict(extra, unit=m["unit"])
    device = {"platform": "gpu" if on_card else "cpu", "kind": run.kind,
              "count": len(set(devices)), "memory_peak_bytes": peak,
              "power_limit_w": run.power_limit_w}
    result = {"correct": correct, "attempted": drv.worlds * (last + 1), "failed": failed,
              "metrics": metrics, "device": device}
    if traced and prof_data:
        busy, lo, hi = trace.busy_and_window(prof_data, devices)
        device["busy_s"] = busy / 1e9
        device["window_s"] = (hi - lo) / 1e9
        ops, _, ranges = prof_data
        first = trace.cards(devices)[0]
        result["breakdown"] = {"device_ops": trace.device_ops(ops),
                               "idle_gaps": trace.idle_gaps(ops, ranges, first, lo, hi)}
    if controls:
        result["controls"] = ctl
    result["checks"] = checks
    return result


def power_limit_w() -> Optional[float]:
    """The card's power limit in W, from nvidia-smi; None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one no run may import."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)
