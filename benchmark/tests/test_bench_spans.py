"""The readers of the program's spans and counters on a synthetic trace and
recorder: only root steps inside the traced window count, values are per
traced step, per-span counts add up to their total, launches are matched
by correlation id, and a program without the tracer (or a trace without
its ranges) reads None."""

import pytest
import torch

from benchmark import harness, spans

# two traced steps, each a "bench.step" range around the program's "step"
# with a "render" inside; a step before the window (its spans only in the
# recorder)
RANGES = [(0, 400, "bench.step"), (10, 390, "step"), (200, 380, "render"),
          (400, 800, "bench.step"), (410, 790, "step"), (600, 780, "render")]
LAUNCHES = [(20, 1), (250, 2), (260, 3), (395, 4), (420, 5), (610, 6), (-50, 7)]
OPS = [(0, 30, 40, "k_solve", 1), (0, 260, 300, "k_raster", 2),
       (0, 300, 310, "Memcpy HtoD (Pageable -> Device)", 3),
       (0, 400, 405, "k_between_steps", 4), (0, 430, 440, "k_solve", 5),
       (0, 620, 700, "k_raster", 6), (0, 620, 621, "Memset (Device)", 6),
       (0, -40, -30, "k_before", 7)]


def _span(i, name, start, end, parent, step, device=0, **counters):
    return {"id": i, "name": name, "start_ns": start, "end_ns": end, "parent": parent,
            "step": step, "device": device, "attrs": {},
            "counters": dict({"syncs": 0}, **counters)}


SPANS = [
    _span(0, "step", -600, -100, None, 6, syncs=50),                 # before the window
    _span(1, "physics", -590, -400, 0, 6, syncs=9, touching_pairs=1, pair_slots=1),
    _span(2, "step", 8, 392, None, 7, syncs=3),
    _span(3, "physics", 15, 150, 2, 7, syncs=0, touching_pairs=30, pair_slots=100),
    _span(4, "render", 198, 382, 2, 7, syncs=5, tile_pairs=40, tile_pairs_dropped=4),
    _span(5, "raster", 210, 300, 4, 7, syncs=2, tile_pairs=60, tile_pairs_dropped=6),
    _span(6, "step", 408, 792, None, 8, syncs=1),
    _span(7, "physics", 415, 550, 6, 8, touching_pairs=50, pair_slots=100),
    _span(8, "render", 598, 782, 6, 8, syncs=4, tile_pairs=100, tile_pairs_dropped=0),
]


def _run(ranges=RANGES):
    return harness.Run(prof=(OPS, LAUNCHES, ranges), devices=[torch.device("cuda", 0)],
                       traffic={"trace_steps": 2}, worlds=1)


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: [dict(s) for s in SPANS])


def test_only_root_steps_inside_the_window_count(program):
    steps = spans.traced_steps(_run(), "step")
    assert [[s["id"] for s in step] for step in steps] == [[2, 3, 4, 5], [6, 7, 8]]
    assert spans.traced_steps(_run(), "physics") is None      # no such root


def test_syncs_per_step_add_up_by_span(program):
    got = harness.reader("syncs_per_step.play")(_run())
    assert got["value"] == (3 + 5 + 2 + 1 + 4) / 2
    assert got["by_span"] == {"step": 2.0, "render": 4.5, "raster": 1.0}
    assert sum(got["by_span"].values()) == got["value"]


def test_launches_inside_the_step_ranges(program):
    got = harness.reader("launches_per_step.play")(_run())
    # launches 1, 2, 3 in the first step, 5 and 6 (a kernel and a memset)
    # in the second; 4 lies between the steps, 7 before the window
    assert got == {"value": 6 / 2, "memcpy": 1 / 2, "memset": 1 / 2}


def test_host_and_device_ms_of_render(program):
    assert harness.reader("render_host_ms.play")(_run()) == pytest.approx(
        (184 + 184) / 1e6 / 2)
    # device ms of the ops launched inside "render": 2, 3 and both of 6
    assert harness.reader("render_device_ms.play")(_run()) == pytest.approx(
        (40 + 10 + 80 + 1) / 1e6 / 2)


def test_ratios_of_counters(program):
    drop = harness.reader("tile_pairs_dropped_pct.play")(_run())
    assert drop == {"value": pytest.approx(100 * 10 / 200), "tile_pairs_dropped": 5.0,
                    "tile_pairs": 100.0,
                    "by_span": {"raster": {"tile_pairs_dropped": 3.0, "tile_pairs": 30.0},
                                "render": {"tile_pairs_dropped": 2.0, "tile_pairs": 70.0}}}
    use = spans.ratio_pct(_run(), "step", "physics", "touching_pairs", "pair_slots")
    assert use == {"value": pytest.approx(40.0), "touching_pairs": 40.0,
                   "pair_slots": 100.0,
                   "by_span": {"physics": {"touching_pairs": 40.0, "pair_slots": 100.0}}}
    assert spans.ratio_pct(_run(), "step", "render", "touching_pairs", "pair_slots") is None


def test_shard_ms_by_device(monkeypatch):
    recs = [_span(0, "worlds.step", 5, 395, None, 1),
            _span(1, "shard", 10, 110, 0, 1, device=0, touching_pairs=5, pair_slots=10),
            _span(2, "shard", 110, 310, 0, 1, device=1, touching_pairs=1, pair_slots=10),
            _span(3, "worlds.step", 405, 795, None, 2),
            _span(4, "shard", 410, 510, 3, 2, device=0, touching_pairs=6, pair_slots=10),
            _span(5, "shard", 510, 610, 3, 2, device=1, touching_pairs=0, pair_slots=10)]
    monkeypatch.setattr(spans, "recorded", lambda: recs)
    got = harness.reader("shard_host_ms.worlds")(_run())
    assert got["value"] == pytest.approx(500 / 1e6 / 2)
    assert got["by_device"] == {"0": pytest.approx(200 / 1e6 / 2),
                                "1": pytest.approx(300 / 1e6 / 2)}
    use = harness.reader("contact_slot_use_pct.worlds")(_run())
    assert use["value"] == pytest.approx(100 * 12 / 40)


NEW = ["syncs_per_step.play", "launches_per_step.play", "render_host_ms.play",
       "render_device_ms.play", "tile_pairs_dropped_pct.play", "syncs_per_step.tick",
       "launches_per_step.tick", "physics_host_ms.tick", "contact_slot_use_pct.tick",
       "syncs_per_step.worlds", "launches_per_step.worlds", "shard_host_ms.worlds",
       "contact_slot_use_pct.worlds"]


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_tracer_reads_none(monkeypatch, metric):
    """The parent's program: no recorder, and no program ranges in its
    trace (only the harness's bench.step)."""
    monkeypatch.setattr(spans, "recorded", lambda: None)
    bare = [r for r in RANGES if r[2] == "bench.step"]
    assert harness.reader(metric)(_run(bare)) is None
