"""The world-sim cell, `world_sim_1080p.sim`: it loads by name, its entry
runs correct at a small size on the CPU, and runs with a fault planted in
the program come out not correct: a non-opaque material turned opaque, the
cloud march skipped, the camera moved. Its readers give the numbers a
synthetic trace and recorder imply, and None where the program has no such
span (the parent's program). Its entry and reference import no JAX. On a
card (`-m gpu`): the program passes at the cell's own sizes and both
controls fail, and it passes at a small size.
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import check, harness, spans
from benchmark.tests.conftest import tiny

CELL = "world_sim_1080p.sim"


def run(n_bodies=64):
    loaded = tiny(harness.load_cell(CELL), n_bodies=n_bodies)
    return harness.run_cell(CELL, 2 ** 31 + 77, 3.0, False, ["cpu"], 0.0, loaded)


def test_cell_loads_by_name():
    c = harness.load_cell(CELL)
    assert c["traffic"]["entry"] == "world_sim"
    assert c["config"]["render"]["use_clouds"] and c["config"]["render"]["use_trans_depth"]
    assert [m.get("blend_mode", "opaque") for m in c["config"]["materials"]] == [
        "opaque", "oit", "opaque", "sorted", "opaque", "refract", "opaque", "opaque"]
    assert c["limits"] == json.loads(
        (harness.BENCH / "limits" / "flagship_1080p.play.json").read_text())


def test_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


def _opaque_oit(monkeypatch):
    from garden_tpu_torch import entry
    build = entry.build

    def opaque(*a, box_materials=None, **k):
        mats = tuple(entry.BOX_MATERIAL if m.blend_mode == "oit" else m
                     for m in box_materials)
        return build(*a, box_materials=mats, **k)
    monkeypatch.setattr(entry, "build", opaque)
    return "image_levels"


def _no_clouds(monkeypatch):
    from garden_tpu_torch.render import clouds
    monkeypatch.setattr(clouds, "composite_clouds", lambda sky, rgb, alpha: sky)
    return "image_levels"


def _camera_moved(monkeypatch):
    from garden_tpu_torch import entry
    camera = entry._flagship_camera

    def moved(side, width, height, device, cam=None):
        eye, target = cam
        return camera(side, width, height, device, ((eye[0], eye[1] + 0.5, eye[2]), target))
    monkeypatch.setattr(entry, "_flagship_camera", moved)
    return "start_leaves"


@pytest.mark.parametrize("fault", [_opaque_oit, _no_clouds, _camera_moved],
                         ids=lambda f: f.__name__.strip("_"))
def test_planted_fault_is_not_correct(monkeypatch, fault):
    number = fault(monkeypatch)
    res = run()
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]


# one traced step: a "bench.step" range around the program's "step", with
# the render's passes inside; the hand kernels launch inside their passes
RANGES = [(0, 1000, "bench.step"), (10, 990, "step"), (100, 200, "csm_render"),
          (300, 400, "cloud_shadow"), (400, 600, "clouds"), (600, 650, "oit"),
          (650, 700, "refraction"), (700, 750, "sorted"), (750, 800, "trans_depth")]
LAUNCHES = [(110, 1), (120, 2), (310, 3), (410, 4), (420, 5), (610, 6), (660, 7),
            (710, 8), (760, 9), (900, 10)]
OPS = [(0, 110, 150, "void depth_super_kernel<8>(float const*)", 1),
       (0, 150, 170, "sorted_blend_kernel(float const*, int)", 2),
       (0, 310, 350, "elementwise_kernel", 3),
       (0, 410, 500, "elementwise_kernel", 4), (0, 500, 560, "reduce_kernel", 5),
       (0, 610, 630, "oit_kernel(float const*)", 6),
       (0, 660, 670, "void raster_shade_kernel<false>(float const*)", 7),
       (0, 710, 740, "sorted_blend_kernel(float const*, int)", 8),
       (0, 760, 790, "void depth_dense_kernel<8>(float const*)", 9),
       (0, 900, 950, "void raster_shade_kernel<true>(float const*)", 10)]


def _span(i, name, parent, **counters):
    start = next(r[0] for r in RANGES if r[2] == name) - 1
    end = next(r[1] for r in RANGES if r[2] == name) + 1
    return {"id": i, "name": name, "start_ns": start, "end_ns": end, "parent": parent,
            "step": 3, "device": 0, "attrs": {}, "counters": dict({"syncs": 0}, **counters)}


SPANS = [_span(0, "step", None, syncs=2), _span(1, "csm_render", 0, syncs=3,
                                                blend_slots=100, blend_slots_kept=5),
         _span(2, "cloud_shadow", 0), _span(3, "clouds", 0, cloud_rays=1000,
                                            cloud_rays_up=540),
         _span(4, "oit", 0, blend_slots=60, blend_slots_kept=30),
         _span(5, "refraction", 0, blend_slots=30, blend_slots_kept=10),
         _span(6, "sorted", 0, blend_slots=10, blend_slots_kept=5),
         _span(7, "trans_depth", 0)]


def _run(ranges=RANGES):
    return harness.Run(prof=(OPS, LAUNCHES, ranges), devices=[torch.device("cuda", 0)],
                       traffic={"trace_steps": 1}, worlds=1,
                       config=harness.load_cell(CELL)["config"],
                       peaks=json.loads((harness.BENCH / "peaks.json").read_text()),
                       kind="NVIDIA H100 80GB HBM3", power_limit_w=700.0)


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: [dict(s) for s in SPANS])


def test_device_ms_of_the_clouds_and_the_translucent_passes(program):
    assert harness.reader("clouds_device_ms.sim")(_run()) == pytest.approx(
        (40 + 90 + 60) / 1e6)
    assert harness.reader("translucent_device_ms.sim")(_run()) == pytest.approx(
        (20 + 10 + 30 + 30) / 1e6)


def test_rooflines_over_their_device_time(program):
    blend = harness.reader("blend_roofline_pct.sim")(_run())
    # K5, K6 (both launches) and K7 by name; not K1, K2 or K4
    assert blend["device_ms"] == pytest.approx((20 + 10 + 20 + 30) / 1e6)
    assert blend["bound"] == "bytes"
    assert blend["least_ms"] == pytest.approx(323.063808e6 / 3.35e12 * 1e3)
    assert blend["value"] == pytest.approx(100 * blend["least_ms"] / blend["device_ms"])
    clouds = harness.reader("clouds_roofline_pct.sim")(_run())
    assert clouds["rays_up"] == 279996
    assert clouds["bound"] == "fp32_ops"
    assert clouds["least_ms"] == pytest.approx(37.868077044e9 / 67e12 * 1e3)
    assert clouds["device_ms"] == pytest.approx(190 / 1e6)
    raster = harness.reader("raster_roofline_pct.sim")(_run())
    assert raster == harness.reader("raster_roofline_pct.play")(_run())
    assert raster["device_ms"] == pytest.approx((40 + 20) / 1e6)


def test_ratios_of_the_new_counters(program):
    rays = harness.reader("cloud_ray_use_pct.sim")(_run())
    assert rays["value"] == pytest.approx(54.0)
    kept = harness.reader("blend_kept_pct.sim")(_run())
    assert kept["value"] == pytest.approx(100 * 50 / 200)
    assert kept["by_span"]["csm_render"] == {"blend_slots_kept": 5.0, "blend_slots": 100.0}
    assert harness.reader("syncs_per_step.sim")(_run())["value"] == 5.0
    assert harness.reader("launches_per_step.sim")(_run())["value"] == 10.0


NEW = ["clouds_device_ms.sim", "translucent_device_ms.sim", "blend_roofline_pct.sim",
       "clouds_roofline_pct.sim", "raster_roofline_pct.sim", "cloud_ray_use_pct.sim",
       "blend_kept_pct.sim", "launches_per_step.sim", "syncs_per_step.sim"]


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_spans_reads_none(monkeypatch, metric):
    monkeypatch.setattr(spans, "recorded", lambda: None)
    bare = [r for r in RANGES if r[2] == "bench.step"]
    ops = [o for o in OPS if "_kernel<" not in o[3] and "_kernel(" not in o[3]]
    run = _run(bare)
    run.prof = (ops, LAUNCHES, bare)
    assert harness.reader(metric)(run) is None


def test_entry_and_reference_load_no_jax_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import harness;"
            "import benchmark.entries.world_sim, benchmark.reference.world_sim;"
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


@pytest.mark.gpu
def test_program_is_correct_at_a_small_size(card):
    loaded = tiny(harness.load_cell(CELL), n_bodies=1000)
    res = harness.run_cell(CELL, 2 ** 31 + 98, 2.0, False, [card], 0.0, loaded)
    assert res["correct"], res["checks"]
