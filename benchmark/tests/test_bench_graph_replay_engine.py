"""The reader of `graph_replay_pct.engine`: the share of the engine tick's
fixed-step loop calls that replayed a CUDA graph, from the `graph_calls`
and `graph_replays` counters of the `PhysicsSystem.update` spans inside
the `step` roots. It reads 100 where every call replayed, 0 where none
did (the CPU, the warm-up), and None where the spans carry no such
counter (the parent's program) or nothing was traced.
"""

import json

import pytest
import torch

from benchmark import harness, spans

CELL = "engine_frame_1080p.engine"
METRIC = "graph_replay_pct.engine"

# one traced step: a "bench.step" range around the program's "step", the
# physics system's update inside the tick
RANGES = [(0, 1000, "bench.step"), (10, 990, "step"), (20, 500, "tick"),
          (300, 490, "PhysicsSystem.update"), (520, 980, "render")]
OPS = [(0, 310, 400, "elementwise_kernel", 1), (0, 600, 700, "elementwise_kernel", 2)]
LAUNCHES = [(310, 1), (600, 2)]


def _span(i, name, parent, **counters):
    start, end = next((r[0], r[1]) for r in RANGES if r[2] == name)
    return {"id": i, "name": name, "start_ns": start - 1, "end_ns": end + 1,
            "parent": parent, "step": 5, "device": 0, "attrs": {},
            "counters": dict({"syncs": 0}, **counters)}


def _run():
    return harness.Run(prof=(OPS, LAUNCHES, RANGES), devices=[torch.device("cuda", 0)],
                       traffic={"trace_steps": 1}, worlds=1,
                       config=harness.load_cell(CELL)["config"],
                       peaks=json.loads((harness.BENCH / "peaks.json").read_text()),
                       kind="NVIDIA H100 80GB HBM3", power_limit_w=700.0)


def _read(monkeypatch, update):
    recorded = [_span(0, "step", None), _span(1, "tick", 0),
                _span(2, "PhysicsSystem.update", 1, sim_steps_run=4, sim_steps_kept=1,
                      **update),
                _span(3, "render", 0)]
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    return harness.reader(METRIC)(_run())


@pytest.mark.parametrize("replays,want", [(1, 100.0), (0, 0.0)])
def test_reads_the_share_of_replayed_calls(monkeypatch, replays, want):
    got = _read(monkeypatch, {"graph_calls": 1, "graph_replays": replays})
    assert got["value"] == pytest.approx(want)
    assert (got["graph_replays"], got["graph_calls"]) == (float(replays), 1.0)
    assert got["by_span"] == {"PhysicsSystem.update": {"graph_replays": float(replays),
                                                       "graph_calls": 1.0}}


@pytest.mark.parametrize("recorded", ["bare", "none", "untraced"])
def test_reads_none_without_the_counters(monkeypatch, recorded):
    if recorded == "bare":   # the parent's program: the spans, not the counters
        assert _read(monkeypatch, {}) is None
    elif recorded == "none":
        monkeypatch.setattr(spans, "recorded", lambda: None)
        assert harness.reader(METRIC)(_run()) is None
    else:
        monkeypatch.setattr(spans, "recorded", lambda: [
            _span(0, "step", None), _span(1, "PhysicsSystem.update", 0, graph_calls=1,
                                          graph_replays=1)])
        run = _run()
        run.prof = None
        assert harness.reader(METRIC)(run) is None


def test_metric_reports_in_the_engine_cell():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (got,) = [m for m in spec["per_layer"] if m["name"] == METRIC]
    assert got == {"name": METRIC, "unit": "%", "better": "higher",
                   "source": "program_counter", "layer": "physics",
                   "moves": "step_p95_ms", "workloads": [CELL]}
    assert METRIC in {m["name"] for m in harness.metrics_of(spec, CELL, "per_layer")}
