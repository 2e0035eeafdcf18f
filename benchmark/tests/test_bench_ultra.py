"""The Ultra cell, `ultra_1080p.play`: it loads by name with play's limits
and the frame state's, its entry runs correct at a small size on the CPU,
and runs with a fault planted come out not correct on some checked step: a
reference without SSR, without SSGI or with the 3x3 PCF, and a program that
hands its next step a black HDR. Its readers give the numbers a synthetic
trace and recorder imply, and None where the program has no such span or
counter (the parent's program has the spans but not the counters). Its
entry imports no JAX. On a card (`-m gpu`): the program passes at the
cell's own sizes and both controls fail.
"""

import copy
import json
import subprocess
import sys

import pytest
import torch

from benchmark import check, harness, spans
from benchmark.reference import scenes as ref_scenes
from benchmark.tests.conftest import tiny

CELL = "ultra_1080p.play"
FRAME_STATE = ("lit_hdr", "avg_luminance", "view_proj_leaves")


def run(n_bodies=64):
    loaded = tiny(harness.load_cell(CELL), n_bodies=n_bodies)
    return harness.run_cell(CELL, 2 ** 31 + 77, 3.0, False, ["cpu"], 0.0, loaded)


def test_cell_loads_by_name():
    c = harness.load_cell(CELL)
    assert c["traffic"]["entry"] == "ultra"
    render = c["config"]["render"]
    assert render["use_clouds"] and render["use_ssr"] and render["use_ssgi"]
    assert render["shadow"] == {"cascade_count": 3, "map_size": 2048, "resolve_step": 1,
                                "pcf_radius": 2}
    play = harness.load_cell("flagship_1080p.play")
    assert {k: v for k, v in c["limits"].items() if k not in FRAME_STATE} == play["limits"]
    assert set(FRAME_STATE) <= set(c["limits"])
    assert c["traffic"]["check_steps"] == 3
    assert {k: v for k, v in c["traffic"].items() if k not in ("entry", "check_steps",
                                                                "check_within")} == {
        k: v for k, v in play["traffic"].items() if k not in ("entry", "check_steps",
                                                              "check_within")}


def test_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert set(FRAME_STATE) <= set(res["checks"])


def _reference_with(monkeypatch, edit):
    made = ref_scenes.Flagship

    def flagship(cfg, *args):
        cfg = copy.deepcopy(cfg)
        edit(cfg["render"])
        return made(cfg, *args)
    monkeypatch.setattr(ref_scenes, "Flagship", flagship)


def _ssr_off(monkeypatch):
    _reference_with(monkeypatch, lambda r: r.update(use_ssr=False))


def _ssgi_off(monkeypatch):
    _reference_with(monkeypatch, lambda r: r.update(use_ssgi=False))


def _pcf_3x3(monkeypatch):
    _reference_with(monkeypatch, lambda r: r["shadow"].update(pcf_radius=1))


def _black_hdr_handed_on(monkeypatch):
    from garden_tpu_torch.render import deferred
    render = deferred.DeferredRenderer.render

    def zeroed(self, *args, **kw):
        out = render(self, *args, **kw)
        state = dict(out["frame_state"])
        state["prev_hdr"] = torch.zeros_like(state["prev_hdr"])
        return dict(out, frame_state=state)
    monkeypatch.setattr(deferred.DeferredRenderer, "render", zeroed)


@pytest.mark.parametrize("fault", [_ssr_off, _ssgi_off, _pcf_3x3, _black_hdr_handed_on],
                         ids=lambda f: f.__name__.strip("_"))
def test_planted_fault_is_not_correct(monkeypatch, fault):
    """Each fault moves the lit HDR handed on past its limit; the black HDR
    moves nothing else a step draws."""
    fault(monkeypatch)
    res = run()
    assert not res["correct"]
    assert res["failed"] >= 1
    checks = res["checks"]
    assert checks["lit_hdr"]["value"] > checks["lit_hdr"]["limit"], checks
    if fault is _black_hdr_handed_on:
        assert checks["image_levels"]["value"] == 0.0, checks


# one traced step: a "bench.step" range around the program's "step", with
# the render's passes inside
RANGES = [(0, 1000, "bench.step"), (10, 990, "step"), (100, 200, "csm_resolve"),
          (300, 400, "ssr"), (400, 600, "ssgi"), (600, 700, "post")]
LAUNCHES = [(110, 1), (120, 2), (310, 3), (320, 4), (410, 5), (420, 6), (610, 7),
            (900, 8)]
OPS = [(0, 110, 150, "elementwise_kernel", 1), (0, 150, 170, "reduce_kernel", 2),
       (0, 310, 350, "elementwise_kernel", 3), (0, 350, 360, "Memcpy DtoD", 4),
       (0, 410, 500, "elementwise_kernel", 5), (0, 500, 560, "reduce_kernel", 6),
       (0, 610, 630, "elementwise_kernel", 7), (0, 900, 950, "Memset", 8)]


def _span(i, name, parent, **counters):
    start = next(r[0] for r in RANGES if r[2] == name) - 1
    end = next(r[1] for r in RANGES if r[2] == name) + 1
    return {"id": i, "name": name, "start_ns": start, "end_ns": end, "parent": parent,
            "step": 3, "device": 0, "attrs": {}, "counters": dict({"syncs": 0}, **counters)}


SPANS = [_span(0, "step", None, syncs=2), _span(1, "csm_resolve", 0, syncs=3),
         _span(2, "ssr", 0, ssr_rays=129600, ssr_rays_hit=32400),
         _span(3, "ssgi", 0, ssgi_pixels=518400, ssgi_pixels_lit=1036),
         _span(4, "post", 0, syncs=1)]


def _run(ranges=RANGES):
    return harness.Run(prof=(OPS, LAUNCHES, ranges), devices=[torch.device("cuda", 0)],
                       traffic={"trace_steps": 1}, worlds=1,
                       config=harness.load_cell(CELL)["config"],
                       peaks=json.loads((harness.BENCH / "peaks.json").read_text()),
                       kind="NVIDIA H100 80GB HBM3", power_limit_w=700.0)


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: [dict(s) for s in SPANS])


def test_device_ms_of_the_screen_space_passes_and_the_shadow_resolve(program):
    assert harness.reader("screen_space_device_ms.ultra")(_run()) == pytest.approx(
        (40 + 10 + 90 + 60) / 1e6)
    assert harness.reader("shadow_resolve_device_ms.ultra")(_run()) == pytest.approx(
        (40 + 20) / 1e6)


def test_roofline_of_the_screen_space_passes(program):
    got = harness.reader("screen_space_roofline_pct.ultra")(_run())
    assert got["bytes"] == 134265600 and got["ops"] == 1134129600
    assert got["bound"] == "bytes"
    assert got["least_ms"] == pytest.approx(134265600 / 3.35e12 * 1e3)
    assert got["device_ms"] == pytest.approx(200 / 1e6)
    assert got["value"] == pytest.approx(100 * got["least_ms"] / got["device_ms"])


def test_roofline_counts_follow_the_files_shapes():
    counts = harness.reader("screen_space_roofline_pct.ultra").__globals__["counts"]
    cfg = copy.deepcopy(harness.load_cell(CELL)["config"])
    nbytes, ops = counts(cfg)
    cfg["ssr"]["steps"] = 32
    assert counts(cfg)[1] - ops == 129600 * 16 * 88
    cfg["ssr"]["steps"] = 16
    cfg["ssgi"]["radii_px"] = [2, 5, 10, 15]
    assert counts(cfg)[1] - ops == 518400 * 8 * 41
    assert counts(cfg)[0] == nbytes


def test_ratios_of_the_new_counters(program):
    hit = harness.reader("ssr_hit_pct.ultra")(_run())
    assert hit["value"] == pytest.approx(25.0)
    assert hit["by_span"] == {"ssr": {"ssr_rays_hit": 32400.0, "ssr_rays": 129600.0}}
    lit = harness.reader("ssgi_lit_pct.ultra")(_run())
    assert lit["value"] == pytest.approx(100 * 1036 / 518400)
    assert harness.reader("syncs_per_step.ultra")(_run())["value"] == 6.0
    launches = harness.reader("launches_per_step.ultra")(_run())
    assert launches == {"value": 8.0, "memcpy": 1.0, "memset": 1.0}
    idle = harness.reader("device_idle_pct.ultra")(_run())
    assert idle == pytest.approx(100 * (1 - 330 / 1000))


NEW = ["screen_space_device_ms.ultra", "screen_space_roofline_pct.ultra",
       "ssr_hit_pct.ultra", "ssgi_lit_pct.ultra", "shadow_resolve_device_ms.ultra",
       "launches_per_step.ultra", "syncs_per_step.ultra"]


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_spans_reads_none(monkeypatch, metric):
    monkeypatch.setattr(spans, "recorded", lambda: None)
    bare = [r for r in RANGES if r[2] == "bench.step"]
    run = _run(bare)
    assert harness.reader(metric)(run) is None


@pytest.mark.parametrize("metric", ["ssr_hit_pct.ultra", "ssgi_lit_pct.ultra"])
def test_spans_without_the_counters_read_none(monkeypatch, metric):
    bare = [dict(s, counters={"syncs": s["counters"]["syncs"]}) for s in SPANS]
    monkeypatch.setattr(spans, "recorded", lambda: bare)
    assert harness.reader(metric)(_run()) is None


def test_entry_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import harness;"
            "import benchmark.entries.ultra, benchmark.reference.scenes;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.gpu
def test_control_fails_where_the_program_passes(card):
    loaded = harness.load_cell(CELL)
    res = harness.run_cell(CELL, 2 ** 31 + 99, 2.0, False, [card], 0.0, loaded,
                           controls=("tf32", "bf16"))
    assert res["correct"], res["checks"]
    for mode in ("tf32", "bf16"):
        ok, got = check.judge(res["controls"][mode], loaded["limits"])
        assert not ok, (mode, got)
