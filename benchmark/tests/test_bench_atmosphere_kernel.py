"""The readers of `atmosphere_kernel_pct.play` and `atmosphere_kernel_pct.sim`:
100 x the `atmosphere_kernel_calls` over the `atmosphere_calls` of the
spans of the traced `step` root steps, each span name's pair beside it,
and None for a program without the counters (the parent's) or without a
trace."""

import json

import pytest
import torch

from benchmark import harness, spans

CELLS = {"atmosphere_kernel_pct.play": "flagship_1080p.play",
         "atmosphere_kernel_pct.sim": "world_sim_1080p.sim"}
RANGES = [(0, 1000, "bench.step"), (10, 990, "step"), (100, 800, "render"),
          (300, 700, "sky_lighting")]
OPS = [(0, 310, 350, "sky_radiance_kernel", 1), (0, 410, 500, "aerial_perspective_kernel", 2)]
LAUNCHES = [(310, 1), (410, 2)]


def _span(i, name, parent, **counters):
    start, end = next((r[0], r[1]) for r in RANGES if r[2] == name)
    return {"id": i, "name": name, "start_ns": start - 1, "end_ns": end + 1,
            "parent": parent, "step": 3, "device": 0, "attrs": {},
            "counters": dict({"syncs": 0}, **counters)}


def _run(metric):
    return harness.Run(prof=(OPS, LAUNCHES, RANGES), devices=[torch.device("cuda", 0)],
                       traffic={"trace_steps": 1}, worlds=1,
                       config=harness.load_cell(CELLS[metric])["config"],
                       peaks=json.loads((harness.BENCH / "peaks.json").read_text()),
                       kind="NVIDIA H100 80GB HBM3", power_limit_w=700.0)


def _read(monkeypatch, metric, sky_lighting, render=None):
    recorded = [_span(0, "step", None), _span(1, "render", 0, **(render or {})),
                _span(2, "sky_lighting", 1, **sky_lighting)]
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    return harness.reader(metric)(_run(metric))


@pytest.mark.parametrize("metric", list(CELLS))
def test_every_call_on_the_kernels_reads_100(monkeypatch, metric):
    got = _read(monkeypatch, metric, {"atmosphere_calls": 4, "atmosphere_kernel_calls": 4})
    assert got["value"] == pytest.approx(100.0)
    assert (got["atmosphere_kernel_calls"], got["atmosphere_calls"]) == (4.0, 4.0)
    assert got["by_span"] == {"sky_lighting": {"atmosphere_kernel_calls": 4.0,
                                               "atmosphere_calls": 4.0}}


@pytest.mark.parametrize("metric", list(CELLS))
def test_plain_calls_count_against_it(monkeypatch, metric):
    got = _read(monkeypatch, metric, {"atmosphere_calls": 3, "atmosphere_kernel_calls": 3},
                render={"atmosphere_calls": 1, "atmosphere_kernel_calls": 0})
    assert got["value"] == pytest.approx(75.0)
    assert set(got["by_span"]) == {"render", "sky_lighting"}
    assert _read(monkeypatch, metric, {"atmosphere_calls": 4,
                                       "atmosphere_kernel_calls": 0})["value"] == 0.0


@pytest.mark.parametrize("metric", list(CELLS))
@pytest.mark.parametrize("recorded", ["bare", "none"])
def test_a_program_without_the_counters_reads_none(monkeypatch, metric, recorded):
    if recorded == "bare":   # the parent's program: the spans, not the counters
        assert _read(monkeypatch, metric, {"cloud_calls": 1, "cloud_kernel_calls": 1}) is None
    else:
        monkeypatch.setattr(spans, "recorded", lambda: None)
        assert harness.reader(metric)(_run(metric)) is None


@pytest.mark.parametrize("metric", list(CELLS))
def test_an_untraced_run_reads_none(monkeypatch, metric):
    monkeypatch.setattr(spans, "recorded",
                        lambda: [_span(0, "step", None, atmosphere_calls=4)])
    run = _run(metric)
    run.prof = None
    assert harness.reader(metric)(run) is None


def test_each_metric_reports_in_its_one_cell():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for metric, cell in CELLS.items():
        got = [m for m in spec["per_layer"] if m["name"] == metric]
        assert len(got) == 1 and got[0]["workloads"] == [cell]
        assert got[0]["moves"] == "step_p95_ms" and got[0]["layer"] == "render"
        assert metric in {m["name"] for m in harness.metrics_of(spec, cell, "per_layer")}
