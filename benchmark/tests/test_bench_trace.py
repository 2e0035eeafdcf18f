"""The frozen stage_times, the busy and idle shares and the breakdown on a
synthetic trace."""

import pytest

from benchmark import harness, trace

# two traced steps on device 0, each in a "bench.step" range with a "raster"
# range inside; launches matched to device ops by correlation id
RANGES = [(0, 400, "bench.step"), (50, 150, "raster"), (400, 800, "bench.step"),
          (420, 600, "raster")]
LAUNCHES = [(60, 1), (100, 2), (300, 3), (450, 4), (700, 5)]
OPS = [(0, 100, 160, "k_raster", 1), (0, 150, 200, "k_raster", 2),
       (0, 310, 330, "memcpy", 3), (0, 460, 560, "k_raster", 4),
       (0, 720, 900, "k_solve", 5), (1, 0, 10, "other_card", 99)]


def test_stage_times_match_launches_inside_each_range():
    got = trace.stage_times(OPS, LAUNCHES, RANGES, ["raster", "bench.step"])
    assert got["raster"] == (100 + 180, 60 + 50 + 100)
    assert got["bench.step"] == (800, 60 + 50 + 20 + 100 + 180)


def test_busy_union_and_idle_share():
    assert trace.union([(0, 5), (3, 8), (10, 12), (12, 13)]) == [(0, 8), (10, 13)]
    lo, hi = trace.traced_bounds(RANGES, OPS)
    assert (lo, hi) == (0, 900)
    # 100-200 (two overlapping-free kernels), 310-330, 460-560, 720-900
    assert trace.busy_ns(OPS, 0, lo, hi) == 100 + 20 + 100 + 180
    run = harness.Run(prof=(OPS, LAUNCHES, RANGES), devices=[__import__("torch").device("cuda", 0)],
                      traffic={"trace_steps": 2}, worlds=1)
    assert trace.idle_pct(run) == pytest.approx(100 * (1 - 400 / 900))
    assert trace.stage_device_ms(run, ["raster"]) == pytest.approx(210 / 1e6 / 2)


def test_breakdown_names_ops_and_gaps():
    ops = trace.device_ops(OPS, top=2)
    assert ops[0] == ["k_raster", pytest.approx(210e-9)]
    assert ops[1] == ["k_solve", pytest.approx(180e-9)]
    gaps = trace.idle_gaps(OPS, RANGES, 0, 0, 900, top=4)
    # idle: 560-720, 330-460, 200-310 (only bench.step open at their middles)
    # and 0-100 (raster open at 50)
    assert [round(s * 1e9) for _, s in gaps] == [160, 130, 110, 100]
    assert [name for name, _ in gaps] == ["bench.step"] * 3 + ["raster"]
