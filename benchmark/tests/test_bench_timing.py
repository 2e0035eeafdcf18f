"""The end-to-end metrics on synthetic completion times."""

import pytest

from benchmark import timing


def test_steady_steps():
    t0 = 100.0
    done = [99.9, t0] + [t0 + 0.1 * k for k in range(1, 101)] + [t0 + 10.05]
    assert timing.step_ms(done, t0, 10.0) == pytest.approx(100.0)
    assert timing.step_p95_ms(done, t0, 10.0) == pytest.approx(100.0)
    assert timing.world_steps_per_s(done, t0, 10.0, 8) == pytest.approx(80.0)


def test_one_stall_moves_the_tail_and_the_rate_but_not_a_median():
    t0 = 0.0
    gaps = [0.1] * 60 + [1.0] + [0.1] * 29        # one step stalls for 1 s
    done, t = [t0], t0
    for g in gaps:
        t += g
        done.append(t)
    seconds = 10.0
    assert len(timing.in_window(done, t0, seconds)) == 90
    assert timing.step_ms(done, t0, seconds) == pytest.approx(seconds * 1e3 / 90)
    iv = timing.intervals_ms(done, t0, seconds)
    assert len(iv) == 90 and max(iv) == pytest.approx(1000.0)
    # 90 intervals: rank 84.55 of 0..89 lies among the 100 ms ones
    assert timing.step_p95_ms(done, t0, seconds) == pytest.approx(100.0)
    gaps = [0.1] * 40 + [1.0] * 5 + [0.1] * 45   # five stalls reach the tail
    done, t = [t0], t0
    for g in gaps:
        t += g
        done.append(t)
    assert timing.step_p95_ms(done, t0, 10.0) == pytest.approx(1000.0)
    assert timing.world_steps_per_s(done, t0, 10.0, 1) == pytest.approx(
        len(timing.in_window(done, t0, 10.0)) / 10.0)


def test_steps_outside_the_window_do_not_count():
    done = [0.0, 0.5, 1.0, 1.5, 2.0, 2.5]
    assert timing.in_window(done, 0.5, 1.5) == [1.0, 1.5, 2.0]
    assert timing.intervals_ms(done, 0.5, 1.5) == pytest.approx([500.0] * 3)


def test_percentile_interpolates_between_ranks():
    assert timing.percentile([1, 2, 3, 4], 50) == pytest.approx(2.5)
    assert timing.percentile([5.0], 95) == 5.0


def test_no_step_in_the_window_gives_no_reading():
    assert timing.step_ms([0.0, 5.0], 0.0, 1.0) is None
    assert timing.step_p95_ms([0.0, 5.0], 0.0, 1.0) is None
    assert timing.world_steps_per_s([0.0], 0.0, 1.0, 8) is None
