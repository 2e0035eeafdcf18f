"""The reader of `cloud_kernel_pct.sim`: 100 x the `cloud_kernel_calls`
over the `cloud_calls` of the spans of the traced `step` root steps, each
span name's pair beside it, and None for a program without the counters
(the parent's) or without a trace."""

import json

import pytest
import torch

from benchmark import harness, spans

CELL = "world_sim_1080p.sim"
RANGES = [(0, 1000, "bench.step"), (10, 990, "step"), (300, 400, "cloud_shadow"),
          (400, 600, "clouds")]
OPS = [(0, 310, 350, "cloud_shadow_kernel", 1), (0, 410, 500, "cloud_march_kernel", 2)]
LAUNCHES = [(310, 1), (410, 2)]


def _span(i, name, parent, **counters):
    start, end = next((r[0], r[1]) for r in RANGES if r[2] == name)
    return {"id": i, "name": name, "start_ns": start - 1, "end_ns": end + 1,
            "parent": parent, "step": 3, "device": 0, "attrs": {},
            "counters": dict({"syncs": 0}, **counters)}


def _run():
    return harness.Run(prof=(OPS, LAUNCHES, RANGES), devices=[torch.device("cuda", 0)],
                       traffic={"trace_steps": 1}, worlds=1,
                       config=harness.load_cell(CELL)["config"],
                       peaks=json.loads((harness.BENCH / "peaks.json").read_text()),
                       kind="NVIDIA H100 80GB HBM3", power_limit_w=700.0)


def _read(monkeypatch, shadow, march):
    recorded = [_span(0, "step", None), _span(1, "cloud_shadow", 0, **shadow),
                _span(2, "clouds", 0, **march)]
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    return harness.reader("cloud_kernel_pct.sim")(_run())


def test_every_call_on_the_kernels_reads_100(monkeypatch):
    got = _read(monkeypatch, {"cloud_calls": 1, "cloud_kernel_calls": 1},
                {"cloud_calls": 1, "cloud_kernel_calls": 1, "cloud_rays": 10})
    assert got["value"] == pytest.approx(100.0)
    assert (got["cloud_kernel_calls"], got["cloud_calls"]) == (2.0, 2.0)
    assert got["by_span"] == {"cloud_shadow": {"cloud_kernel_calls": 1.0, "cloud_calls": 1.0},
                              "clouds": {"cloud_kernel_calls": 1.0, "cloud_calls": 1.0}}


def test_plain_calls_count_against_it(monkeypatch):
    got = _read(monkeypatch, {"cloud_calls": 1, "cloud_kernel_calls": 0},
                {"cloud_calls": 1, "cloud_kernel_calls": 1})
    assert got["value"] == pytest.approx(50.0)
    assert _read(monkeypatch, {"cloud_calls": 1, "cloud_kernel_calls": 0},
                 {"cloud_calls": 1, "cloud_kernel_calls": 0})["value"] == 0.0


@pytest.mark.parametrize("recorded", ["bare", "none"])
def test_a_program_without_the_counters_reads_none(monkeypatch, recorded):
    if recorded == "bare":   # the parent's program: the spans, not the counters
        assert _read(monkeypatch, {}, {"cloud_rays": 10, "cloud_rays_up": 5}) is None
    else:
        monkeypatch.setattr(spans, "recorded", lambda: None)
        assert harness.reader("cloud_kernel_pct.sim")(_run()) is None


def test_an_untraced_run_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: [_span(0, "step", None, cloud_calls=1)])
    run = _run()
    run.prof = None
    assert harness.reader("cloud_kernel_pct.sim")(run) is None
