"""The replayed spans' device time (`benchmark/replayed.py`) on a synthetic
trace and recorder: each program `graph_replay` span is paired in order
with kineto's range of that name, its ops matched by correlation id and
sorted by device start, sliced by each replayed record's `graph_ops`; a
replay whose ops miss one, or whose copies or memsets sit elsewhere than
its layout says, makes the reading None, as does a program that replays
nothing."""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import pytest
import torch

from benchmark import harness, replayed, spans

# the graph's 6 ops in capture order: a memcpy, 4 kernels, a memset;
# (start, end) on the device, ns after the replay's launch
GRAPH = [("Memcpy DtoD (Device -> Device)", 0, 3), ("k_cells", 5, 15),
         ("k_pairs", 16, 40), ("k_manifold", 41, 81), ("k_solve", 82, 182),
         ("Memset (Device)", 183, 184)]
STAGES = {"collide": (1, 4), "broadphase": (1, 2), "narrowphase": (2, 4),
          "solve_velocity": (4, 5)}


def _span(i, name, start, end, parent, step, attrs=None, **counters):
    return {"id": i, "name": name, "start_ns": start, "end_ns": end, "parent": parent,
            "step": step, "device": 0, "attrs": attrs or {},
            "counters": dict({"syncs": 0}, **counters)}


def _headless(n_steps=2):
    """`n_steps` traced physics steps, each one replay: (recorder, ops,
    launches, ranges)."""
    recs, ops, launches, ranges = [], [], [], []
    for k in range(n_steps):
        t0, base, corr = 1000 * k, 10 * k, 100 + k
        ranges += [(t0, t0 + 900, "bench.step"), (t0 + 10, t0 + 890, "physics"),
                   (t0 + 100, t0 + 300, "graph_replay")]
        launches += [(t0 + 50, corr + 50), (t0 + 150, corr)]     # the copy in, the replay
        ops.append((0, t0 + 60, t0 + 61, "k_copy_in", corr + 50))
        dev = t0 + 400
        # device order kept, listed out of order
        ops += [(0, dev + s, dev + e, name, corr) for name, s, e in reversed(GRAPH)]
        recs += [_span(base, "physics", t0 + 5, t0 + 895, None, k, pair_slots=1),
                 _span(base + 1, "graph_replay", t0 + 99, t0 + 301, base, k,
                       {"graph_ops": [0, 6], "memcpy": [0], "memset": [5]})]
        ids = {"collide": base + 2}
        for j, (name, (lo, hi)) in enumerate(STAGES.items()):
            parent = base + 1 if name in ("collide", "solve_velocity") else ids["collide"]
            recs.append(_span(base + 2 + j, name, t0 + 99, t0 + 99, parent, k,
                              {"replayed": True, "graph_ops": [lo, hi]}))
    return recs, ops, launches, ranges


def _run(monkeypatch, recs, ops, launches, ranges, steps=2):
    monkeypatch.setattr(spans, "recorded", lambda: recs)
    return harness.Run(prof=(ops, launches, ranges), devices=[torch.device("cuda", 0)],
                       traffic={"trace_steps": steps}, worlds=1)


def _ms(*names):
    return sum(e - s for n, s, e in GRAPH if n in names) / 1e6


def test_a_full_replay_is_sliced_by_its_records(monkeypatch):
    run = _run(monkeypatch, *_headless())
    got = replayed.slices(run, "physics")
    assert [len(ops) for _, _, ops in got] == [6, 6]
    assert [op[3] for op in got[0][2]] == [name for name, _, _ in GRAPH]
    assert [s["name"] for s in got[1][1]] == ["collide", "solve_velocity", "broadphase",
                                              "narrowphase"]
    for metric, names in (("broadphase_device_ms.tick", ["k_cells"]),
                          ("narrowphase_device_ms.tick", ["k_pairs", "k_manifold"]),
                          ("solve_velocity_device_ms.tick", ["k_solve"])):
        value = harness.reader(metric)(run)
        assert value == {"value": pytest.approx(_ms(*names)), "replays": 2}, metric


def test_copies_run_as_the_drivers_kernels_are_sliced_the_same(monkeypatch):
    """A graph instantiated outside a profiler session runs its memcpy and
    memset nodes as the driver's kernels: still one op a node, of the
    node's kind."""
    recs, ops, launches, ranges = _headless()
    lowered = {"Memcpy DtoD (Device -> Device)": "memcpy32_post",
               "Memset (Device)": "memset32"}
    ops = [op[:3] + (lowered.get(op[3], op[3]),) + op[4:] for op in ops]
    run = _run(monkeypatch, recs, ops, launches, ranges)
    assert harness.reader("narrowphase_device_ms.tick")(run) == {
        "value": pytest.approx(_ms("k_pairs", "k_manifold")), "replays": 2}
    assert [replayed.op_kind(n) for n in ("memcpy128", "Memset (Unknown)", "k_cells")] == \
        ["memcpy", "memset", "kernel"]


def test_a_replay_missing_an_op_reads_none(monkeypatch):
    recs, ops, launches, ranges = _headless()
    ops = [op for op in ops if op[3] != "k_pairs" or op[1] < 1000]   # one of step 1
    run = _run(monkeypatch, recs, ops, launches, ranges)
    assert replayed.slices(run, "physics") is None
    assert harness.reader("broadphase_device_ms.tick")(run) is None


def test_copies_out_of_place_read_none(monkeypatch):
    recs, ops, launches, ranges = _headless()
    copy = "Memcpy DtoD (Device -> Device)"
    swap = {copy: "k_cells", "k_cells": copy}
    ops = [op[:3] + (swap.get(op[3], op[3]),) + op[4:] for op in ops]
    run = _run(monkeypatch, recs, ops, launches, ranges)
    assert harness.reader("narrowphase_device_ms.tick")(run) is None
    recs, ops, launches, ranges = _headless()
    recs = [dict(s, attrs=dict(s["attrs"], memset=[4])) if s["name"] == "graph_replay" else s
            for s in recs]
    assert replayed.slices(_run(monkeypatch, recs, ops, launches, ranges), "physics") is None


def test_replays_pair_one_to_one_or_read_none(monkeypatch):
    recs, ops, launches, ranges = _headless()
    extra = ranges + [(5000, 5100, "graph_replay")]
    assert replayed.slices(_run(monkeypatch, recs, ops, launches, extra), "physics") is None


def _engine(kept):
    """One traced engine tick: a replay of 4 fixed steps of 2 ops each
    under `PhysicsSystem.update`, which keeps `kept` of them."""
    recs = [_span(0, "step", 5, 895, None, 0),
            _span(1, "tick", 6, 800, 0, 0),
            _span(2, "PhysicsSystem.update", 10, 700, 1, 0, sim_steps_run=4,
                  sim_steps_kept=kept),
            _span(3, "graph_replay", 100, 300, 2, 0,
                  {"graph_ops": [0, 9], "memcpy": [], "memset": []})]
    for k in range(4):
        recs.append(_span(4 + k, "fixed_step", 100, 100, 3, 0,
                          {"k": k, "replayed": True, "graph_ops": [1 + 2 * k, 3 + 2 * k]}))
    ops = [(0, 1000 + 100 * i, 1000 + 100 * i + 10 * (i + 1), f"k{i}", 7) for i in range(9)]
    ranges = [(0, 900, "bench.step"), (5, 895, "step"), (100, 300, "graph_replay")]
    return recs, ops, [(150, 7)], ranges


@pytest.mark.parametrize("kept", [0, 1, 2, 4])
def test_discarded_steps_read_the_steps_past_those_kept(monkeypatch, kept):
    run = _run(monkeypatch, *_engine(kept), steps=1)
    got = harness.reader("discarded_steps_device_ms.engine")(run)
    # step k holds ops 1 + 2k and 2 + 2k, op i lasting 10 (i + 1) ns
    want = sum(10 * (i + 1) for k in range(kept, 4) for i in (1 + 2 * k, 2 + 2 * k))
    assert got == {"value": pytest.approx(want / 1e6), "replays": 1}


@pytest.mark.parametrize("metric", ["broadphase_device_ms.tick", "narrowphase_device_ms.tick",
                                    "solve_velocity_device_ms.tick",
                                    "discarded_steps_device_ms.engine"])
def test_a_program_that_emits_no_replayed_spans_reads_none(monkeypatch, metric):
    """The parent's program: its replays open no `graph_replay` span and
    emit nothing, so neither side of the pairing has a replay."""
    recs, ops, launches, ranges = _headless()
    recs = [s for s in recs if s["name"] == "physics"]
    ranges = [r for r in ranges if r[2] != "graph_replay"]
    assert harness.reader(metric)(_run(monkeypatch, recs, ops, launches, ranges)) is None
    recs, ops, launches, ranges = _engine(1)
    recs = recs[:3]
    ranges = [r for r in ranges if r[2] != "graph_replay"]
    assert harness.reader(metric)(_run(monkeypatch, recs, ops, launches, ranges, 1)) is None
