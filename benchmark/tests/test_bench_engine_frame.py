"""The engine-frame cell, `engine_frame_1080p.engine`: it loads by name, its
entry runs correct at a small size on the CPU, and runs with a fault planted
in the program or the entry come out not correct: the accumulator keeping
all four steps, the HUD dropped, the characters not steered, casts that
find nothing (the first character never climbs its step), the seeded
positions kept from the transform rows. Its readers give the numbers a
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
from benchmark.entries import engine_frame
from benchmark.tests.conftest import tiny

CELL = "engine_frame_1080p.engine"


def small(loaded, n_bodies=64):
    """`tiny`'s cut, with 2 characters and their step, 4 animated entities
    and grid_dim 8; the cell's own 4 warm-up steps, so that the checked
    steps start where the first character climbs its step."""
    warmup = loaded["traffic"]["warmup_steps"]
    loaded = tiny(loaded, n_bodies=n_bodies)
    loaded["traffic"]["warmup_steps"] = warmup
    cfg = loaded["config"]
    cfg["characters"]["count"] = 2
    cfg["steps"]["count"] = 1
    cfg["animated"]["count"] = 4
    cfg["physics"].update(max_bodies=n_bodies + 2, grid_dim=8)
    return loaded


def run(n_bodies=64):
    loaded = small(harness.load_cell(CELL), n_bodies=n_bodies)
    return harness.run_cell(CELL, 2 ** 31 + 77, 3.0, False, ["cpu"], 0.0, loaded)


def test_cell_loads_by_name():
    c = harness.load_cell(CELL)
    assert c["traffic"]["entry"] == "engine_frame"
    play = json.loads((harness.BENCH / "limits" / "flagship_1080p.play.json").read_text())
    assert c["limits"] == dict(play, transform_m=1e-3, character_flags=0)
    cfg = c["config"]
    assert cfg["physics"]["max_bodies"] == cfg["n_bodies"] + cfg["characters"]["count"]
    flagship = harness.load_cell("flagship_1080p.play")["config"]
    assert cfg["render"] == flagship["render"]
    assert cfg["bodies"] == flagship["bodies"]
    assert {k: v for k, v in cfg["physics"].items() if k != "max_bodies"} == \
        flagship["physics"]


def test_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert set(res["checks"]) == set(harness.load_cell(CELL)["limits"])


def _keep_all_steps(monkeypatch):
    from garden_tpu_torch.physics import world
    monkeypatch.setattr(world, "_select_tree", lambda did, new, old: new)
    return "pos_m"


def _no_hud(monkeypatch):
    from garden_tpu_torch.render import sprites
    monkeypatch.setattr(sprites, "composite_sprites", lambda image, atlas, batch: image)
    return "image_levels"


def _not_steered(monkeypatch):
    from garden_tpu_torch.systems.character import CharacterSystem
    monkeypatch.setattr(CharacterSystem, "update", lambda self, state, ctx: state)
    return "linvel_mps"


def _casts_find_nothing(monkeypatch):
    from garden_tpu_torch.physics import queries
    cast = queries.cast_sphere

    def no_hit(*a, **k):
        hit = cast(*a, **k)
        return hit._replace(hit=torch.zeros_like(hit.hit))
    monkeypatch.setattr(queries, "cast_sphere", no_hit)
    return "pos_m"


def _transforms_unseeded(monkeypatch):
    moved = engine_frame.with_positions

    def bodies_only(state, pos):
        return dict(moved(state, pos), components=state["components"])
    monkeypatch.setattr(engine_frame, "with_positions", bodies_only)
    return "start_leaves"


@pytest.mark.parametrize("fault", [_keep_all_steps, _no_hud, _not_steered,
                                   _casts_find_nothing, _transforms_unseeded],
                         ids=lambda f: f.__name__.strip("_"))
def test_planted_fault_is_not_correct(monkeypatch, fault):
    number = fault(monkeypatch)
    res = run()
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]


# one traced step: a "bench.step" range around the program's "step", the
# tick's systems inside "tick", the HUD's composite inside "render"
RANGES = [(0, 1000, "bench.step"), (10, 990, "step"), (20, 500, "tick"),
          (30, 100, "AnimationSystem.update"), (100, 300, "CharacterSystem.update"),
          (300, 490, "PhysicsSystem.update"), (500, 520, "instance_matrices"),
          (520, 980, "render"), (900, 970, "ui")]
LAUNCHES = [(40, 1), (110, 2), (120, 3), (310, 4), (510, 5), (600, 6), (910, 7), (920, 8)]
OPS = [(0, 40, 60, "elementwise_kernel", 1), (0, 110, 150, "reduce_kernel", 2),
       (0, 150, 200, "Memcpy DtoH (Device -> Pageable)", 3),
       (0, 310, 400, "elementwise_kernel", 4), (0, 510, 515, "elementwise_kernel", 5),
       (0, 600, 700, "void raster_shade_kernel<true>(float const*)", 6),
       (0, 910, 930, "index_elementwise_kernel", 7), (0, 930, 960, "elementwise_kernel", 8)]


def _span(i, name, parent, **counters):
    start = next(r[0] for r in RANGES if r[2] == name) - 1
    end = next(r[1] for r in RANGES if r[2] == name) + 1
    return {"id": i, "name": name, "start_ns": start, "end_ns": end, "parent": parent,
            "step": 5, "device": 0, "attrs": {}, "counters": dict({"syncs": 0}, **counters)}


SPANS = [_span(0, "step", None), _span(1, "tick", 0),
         _span(2, "AnimationSystem.update", 1),
         _span(3, "CharacterSystem.update", 1, syncs=1),
         _span(4, "PhysicsSystem.update", 1, sim_steps_run=4, sim_steps_kept=1),
         _span(5, "instance_matrices", 0), _span(6, "render", 0, syncs=2),
         _span(7, "ui", 6, ui_sprites=80, ui_pixels=80 * 2073600, ui_pixels_covered=3000)]


def _run(ranges=RANGES, stage_ms=None):
    return harness.Run(prof=(OPS, LAUNCHES, ranges), devices=[torch.device("cuda", 0)],
                       traffic={"trace_steps": 1}, worlds=1,
                       spans=stage_ms or {},
                       config=harness.load_cell(CELL)["config"],
                       peaks=json.loads((harness.BENCH / "peaks.json").read_text()),
                       kind="NVIDIA H100 80GB HBM3", power_limit_w=700.0)


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: [dict(s) for s in SPANS])


def test_device_ms_of_the_tick_the_characters_and_the_hud(program):
    assert harness.reader("tick_device_ms.engine")(_run()) == pytest.approx(
        (20 + 40 + 50 + 90) / 1e6)
    assert harness.reader("character_device_ms.engine")(_run()) == pytest.approx(
        (40 + 50) / 1e6)
    assert harness.reader("ui_device_ms.engine")(_run()) == pytest.approx((20 + 30) / 1e6)


def test_device_ms_of_the_render_with_its_hud(program):
    assert harness.reader("render_device_ms.engine")(_run()) == pytest.approx(
        (100 + 20 + 30) / 1e6)


def test_tick_ms_is_the_synchronized_tick(program):
    ms = harness.reader("tick_ms.engine")(_run(stage_ms={"tick": [500.0, 700.0],
                                                          "render": [60.0, 70.0]}))
    assert ms == pytest.approx(600.0)


def test_ratios_launches_and_syncs_of_the_step(program):
    sim = harness.reader("sim_step_use_pct.engine")(_run())
    assert sim["value"] == pytest.approx(25.0)
    assert sim["by_span"] == {"PhysicsSystem.update": {"sim_steps_kept": 1.0,
                                                       "sim_steps_run": 4.0}}
    ui = harness.reader("ui_pixel_use_pct.engine")(_run())
    assert ui["value"] == pytest.approx(100 * 3000 / (80 * 2073600))
    launches = harness.reader("launches_per_step.engine")(_run())
    assert launches == {"value": 8.0, "memcpy": 1.0, "memset": 0.0}
    syncs = harness.reader("syncs_per_step.engine")(_run())
    assert syncs["value"] == 3.0
    assert syncs["by_span"] == {"CharacterSystem.update": 1.0, "render": 2.0}
    idle = harness.reader("device_idle_pct.engine")(_run())
    assert idle == pytest.approx(100 * (1 - (20 + 90 + 90 + 5 + 100 + 50) / 1000))


NEW = ["tick_ms.engine", "tick_device_ms.engine", "character_device_ms.engine",
       "ui_device_ms.engine", "sim_step_use_pct.engine", "ui_pixel_use_pct.engine",
       "launches_per_step.engine", "syncs_per_step.engine", "render_device_ms.engine"]


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_spans_reads_none(monkeypatch, metric):
    monkeypatch.setattr(spans, "recorded", lambda: None)
    bare = [r for r in RANGES if r[2] == "bench.step"]
    assert harness.reader(metric)(_run(bare)) is None


def test_the_parents_frame_reads_only_its_system_spans(monkeypatch):
    """The parent's EngineFrame opens no `step`, `tick` or `render` span and
    counts nothing; its systems' and the composite's spans are there."""
    parent = [r for r in RANGES if r[2] not in ("step", "tick", "render",
                                                "instance_matrices")]
    monkeypatch.setattr(spans, "recorded", lambda: [
        dict(s, parent=None, counters={"syncs": 0}) for s in SPANS
        if s["name"] not in ("step", "tick", "render", "instance_matrices")])
    run = _run(parent)
    for metric in ("tick_device_ms.engine", "sim_step_use_pct.engine",
                   "ui_pixel_use_pct.engine", "launches_per_step.engine",
                   "syncs_per_step.engine", "render_device_ms.engine"):
        assert harness.reader(metric)(run) is None, metric
    assert harness.reader("character_device_ms.engine")(run) == pytest.approx(90 / 1e6)


def test_entry_and_reference_load_no_jax_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import harness;"
            "import benchmark.entries.engine_frame, benchmark.reference.engine_frame;"
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
    loaded = small(harness.load_cell(CELL), n_bodies=1000)
    res = harness.run_cell(CELL, 2 ** 31 + 98, 2.0, False, [card], 0.0, loaded)
    assert res["correct"], res["checks"]
