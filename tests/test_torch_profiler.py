"""The port's tracer (`garden_tpu_torch.utils.profiler`) on the CPU.

Off (no torch.profiler session recording), a span is a shared no-op: it
enters no `record_function` and records nothing. On, every span is a
range of the trace and a record: parents, one step id a root step, the
recorder's start and end within a few us of kineto's event of the same
span (RANGE_SLACK_NS, the median over the spans), counters charged to the
innermost open span, at most MAX_STEPS root steps kept. The batched
physics step through `WorldBatch.step` records its `shard` spans with
their devices and contact rows, and returns the same bits traced or not;
the binning counts its pairs and drops; neither reads a counter back to
the host inside a traced step. `syncs` reads 0 on the CPU.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import contextlib
import json
import statistics
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from garden_tpu_torch import entry
from garden_tpu_torch.parallel.worlds import WorldBatch
from garden_tpu_torch.physics import world as pw
from garden_tpu_torch.render import raster
from garden_tpu_torch.utils import profiler

RANGE_SLACK_NS = 20_000          # median |recorder - kineto| edge, both edges


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder for the test, the module's own put back after."""
    rec = profiler.Recorder()
    monkeypatch.setattr(profiler, "RECORDER", rec)
    return rec


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _annotations(prof):
    return [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def test_off_span_is_a_shared_no_op(recorder, monkeypatch):
    def no_range(name):
        raise AssertionError(f"range {name!r} entered while off")
    monkeypatch.setattr(profiler, "_open_range", no_range)
    first = profiler.span("a")
    assert first is profiler.span("b", device=0)
    with first:
        assert not profiler.recording()
        profiler.count("tile_pairs", torch.tensor(3))
        with profiler.span("inner"):
            pass
    assert profiler.recorded() == [] and not recorder.stack and recorder.next_step == 0
    # no record a span: a thousand off spans leave no memory behind (a
    # record is ~100 B)
    span = profiler.span
    tracemalloc.start()
    try:
        for _ in range(1000):
            with span("x"):
                pass
            with span("shard", device=0, shard=1):
                pass
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 4096, (current, peak)


def test_on_spans_link_parents_and_steps_and_lay_over_kineto(recorder):
    with _cpu_profile() as prof:
        for _ in range(3):
            with profiler.span("root"):
                with profiler.span("child", role="x"):
                    with profiler.span("leaf"):
                        torch.ones(8).sum()
                with profiler.span("sibling"):
                    pass
        with profiler.span("lone"):
            pass
    spans = profiler.recorded()
    assert [s["name"] for s in spans] == ["root", "child", "leaf", "sibling"] * 3 + ["lone"]
    by_id = {s["id"]: s for s in spans}
    for step in range(3):
        root, child, leaf, sib = spans[4 * step: 4 * step + 4]
        assert {s["step"] for s in (root, child, leaf, sib)} == {step}
        assert root["parent"] is None and child["parent"] == root["id"]
        assert leaf["parent"] == child["id"] and sib["parent"] == root["id"]
        assert child["attrs"] == {"role": "x"} and root["device"] is None
        assert root["start_ns"] <= child["start_ns"] <= leaf["start_ns"]
        assert leaf["end_ns"] <= child["end_ns"] <= sib["start_ns"] <= root["end_ns"]
        assert all(s["counters"] == {"syncs": 0} for s in (root, child, leaf, sib))
    assert spans[-1]["step"] == 3 and spans[-1]["parent"] is None
    assert len(by_id) == len(spans)
    # the recorder's times against kineto's events of the same spans, in order
    kin = sorted(_annotations(prof), key=lambda e: e.start_ns())
    assert [e.name() for e in kin] == [s["name"] for s in
                                       sorted(spans, key=lambda s: s["start_ns"])]
    rec = sorted(spans, key=lambda s: s["start_ns"])
    starts = [abs(e.start_ns() - s["start_ns"]) for e, s in zip(kin, rec)]
    ends = [abs(e.start_ns() + e.duration_ns() - s["end_ns"]) for e, s in zip(kin, rec)]
    assert statistics.median(starts) <= RANGE_SLACK_NS, starts
    assert statistics.median(ends) <= RANGE_SLACK_NS, ends


def test_counters_go_to_the_innermost_open_span(recorder):
    with _cpu_profile():
        with profiler.span("outer"):
            profiler.count("n", 2)
            with profiler.span("inner"):
                assert profiler.recording()
                profiler.count("n", 5)
                profiler.count("dev", torch.tensor(7))
                profiler.count("dev", torch.tensor(4))
            profiler.count("dev", torch.tensor(1))
        assert not profiler.recording()
        profiler.count("n", 100)                     # no span open: dropped
    outer, inner = profiler.recorded()
    assert outer["counters"] == {"syncs": 0, "n": 2, "dev": 1}
    assert inner["counters"] == {"syncs": 0, "n": 5, "dev": 11}
    # read once: a second call gives the same numbers
    assert profiler.recorded()[1]["counters"] == inner["counters"]


def test_recorder_keeps_the_last_max_steps_roots(recorder):
    with _cpu_profile():
        for _ in range(profiler.MAX_STEPS + 10):
            with profiler.span("root"):
                with profiler.span("child"):
                    pass
    spans = profiler.recorded()
    steps = sorted({s["step"] for s in spans})
    assert len(steps) == profiler.MAX_STEPS == len(recorder.steps)
    assert steps == list(range(10, profiler.MAX_STEPS + 10))
    assert len(spans) == 2 * profiler.MAX_STEPS


def test_syncs_read_zero_on_the_cpu(recorder):
    with _cpu_profile():
        with profiler.span("root"):
            x = torch.arange(6.0)
            assert float(x.sum().item()) == 15.0
            with profiler.span("inner"):
                x.tolist()
    assert [s["counters"]["syncs"] for s in profiler.recorded()] == [0, 0]


def test_trace_writes_the_chrome_trace_and_the_sessions_spans(recorder, tmp_path):
    with _cpu_profile():
        with profiler.span("before"):
            pass
    x = torch.arange(64.0)
    with profiler.trace(str(tmp_path / "trace")) as prof:
        with profiler.span("garden_span"):
            (x * 2).sum()
    assert "garden_span" in {e.name for e in prof.events()}
    with open(tmp_path / "trace" / profiler.TRACE_FILE, encoding="utf-8") as f:
        assert "garden_span" in json.dumps(json.load(f))
    with open(tmp_path / "trace" / profiler.SPANS_FILE, encoding="utf-8") as f:
        spans = json.load(f)
    assert [(s["name"], s["step"]) for s in spans] == [("garden_span", 1)]
    ms = profiler.host_ms(spans)
    assert set(ms) == {"garden_span"} and ms["garden_span"] > 0


@contextlib.contextmanager
def no_read_back():
    """Inside, any read of a tensor to the host raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was read back to the host")
    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "__bool__", "__int__", "__float__", "numpy"):
            mp.setattr(torch.Tensor, name, refuse)
        yield


def _box_pile(n_bodies=28):
    world, pcfg, _ = entry.flagship_world(n_bodies, grid_dim=8)
    types = world.shapes.present_types()
    return world.device_state("cpu"), (lambda s: pw.step(s, pcfg, 1.0 / 60.0, types))


def test_world_batch_records_shards_and_contacts_same_bits(recorder):
    base, step = _box_pile()
    states = []
    for w in range(4):
        b = base["bodies"]
        lift = torch.zeros_like(b["pos"])
        lift[1:, 1] = 0.01 * w
        states.append(dict(base, bodies=dict(b, pos=b["pos"] + lift)))
    wb = WorldBatch(step, 4, devices=["cpu", "cpu"])
    plain = traced = wb.stack(states)
    for _ in range(8):
        plain = wb.step(plain)
    with _cpu_profile():
        with torch.no_grad():
            for _ in range(8):
                traced = wb.step(traced)
            with no_read_back():
                traced = wb.step(traced)
    plain = wb.step(plain)
    for a, b in zip(plain, traced):
        for x, y in zip(torch.utils._pytree.tree_leaves(a),
                        torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(x, y)
    spans = profiler.recorded()
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["worlds.step"] * 9
    last = [s for s in spans if s["step"] == roots[-1]["step"]]
    shards = [s for s in last if s["name"] == "shard"]
    assert [(s["attrs"]["shard"], s["device"], s["parent"]) for s in shards] == \
        [(0, None, roots[-1]["id"]), (1, None, roots[-1]["id"])]
    stages = {s["name"] for s in last if s["parent"] in {x["id"] for x in shards}}
    assert {"collide", "warm_match", "solve_velocity", "integrate"} <= stages
    keys = [p["warm"]["key"] for p in traced]
    for s, key in zip(shards, keys):
        assert s["counters"]["pair_slots"] == key.numel() == 2 * 28 * key.shape[-1]
        assert s["counters"]["touching_pairs"] == int((key >= 0).sum()) > 0
    # the stages inside the vmap count no contacts of their own
    assert all("touching_pairs" not in s["counters"] for s in last
               if s["name"] != "shard")


def test_combined_physics_counts_its_contacts(recorder):
    world, pcfg, _ = entry.flagship_world(28, grid_dim=8)
    step = entry.CombinedStep(pcfg, world.shapes.present_types(), None, None, None, 28)
    state = world.device_state("cpu")
    for _ in range(8):
        state = step.physics(state)
    with _cpu_profile(), no_read_back():
        out = step.physics(state)
    (phys,) = [s for s in profiler.recorded() if s["parent"] is None]
    assert phys["name"] == "physics"
    key = out["warm"]["key"]
    assert phys["counters"]["touching_pairs"] == int((key >= 0).sum()) > 0
    assert phys["counters"]["pair_slots"] == key.numel()


def _setup(w=256, h=128, n=400, seed=3):
    g = torch.Generator().manual_seed(seed)
    base = torch.rand(n, 2, generator=g) * 1.8 - 0.9
    size = torch.rand(n, 1, generator=g) * 0.3 + 0.02
    size[: n // 10] *= 8.0                              # some big triangles
    cx = torch.stack([base[:, 0], base[:, 0] + size[:, 0], base[:, 0]])
    cy = torch.stack([base[:, 1], base[:, 1], base[:, 1] + size[:, 0]])
    cz = torch.full((3, n), 0.5)
    cw = torch.ones(3, n)
    return raster.setup_triangles_planes(cx, cy, cz, cw, torch.ones(n, dtype=torch.bool),
                                         w, h)


def _pairs_by_hand(setup, tile, th, w, h):
    """Every small triangle's tiles (a footprint within 2 x 2), and one
    entry a big triangle."""
    tiles_x, tiles_y, _ = raster._grid(w, h, tile, th)
    _, nx, _, ny = raster._tile_spans(setup, tile, th, tiles_x, tiles_y)
    small = setup["valid"] & (nx <= 2) & (ny <= 2)
    big = setup["valid"] & ~small
    return int((nx * ny)[small].sum()) + int(big.sum())


@pytest.mark.parametrize("kind", ["slot", "slot_active", "corner", "corner_active"])
def test_binning_counts_pairs_and_drops(recorder, kind):
    w, h, tile, th = 256, 128, 32, 16
    setup = _setup(w, h)
    active = dict(max_active=12) if kind.endswith("active") else {}
    corner = kind.startswith("corner")
    cap, max_big = 24, 8
    with _cpu_profile():
        with profiler.span("bin"), no_read_back():
            if corner:
                out = raster.bin_triangles_corner(setup, w, h, tile, cap, max_big=max_big,
                                                  tile_h=th, **active)
            else:
                out = raster.bin_triangles(setup, w, h, tile, cap, max_big=max_big, foot=2,
                                           tile_h=th, foot_y=2, **active)
    c = profiler.recorded()[0]["counters"]
    counts, big = out[1], out[2]
    pairs = _pairs_by_hand(setup, tile, th, w, h)
    kept = int(counts.sum()) + int((big >= 0).sum())
    assert c["tile_pairs"] == pairs
    assert c["tile_pairs_dropped"] == pairs - kept > 0


def test_supertile_binning_counts_its_cap(recorder):
    w, h = 512, 256
    setup = _setup(w, h, n=300)
    big = torch.nonzero(setup["valid"]).flatten()[:64].int()
    with _cpu_profile():
        with profiler.span("bin"):
            sup, counts, _ = raster.bin_big_supertiles(setup, big, w, h, 128, 32, 2, 2, cap=4)
    full = raster.supertile_counts(setup, big, w, h, 128, 32, 2, 2)
    c = profiler.recorded()[0]["counters"]
    assert c["tile_pairs"] == int(full.sum())
    assert c["tile_pairs_dropped"] == int((full - 4).clamp(min=0).sum()) > 0
    assert int(counts.sum()) == c["tile_pairs"] - c["tile_pairs_dropped"]


# -- the layout of a graph capture, and its records on a replay ---------------

def test_capture_records_the_layout_with_a_fake_node_counter(recorder):
    """Inside `capture`, spans record layout entries whether or not a
    profiler records, each with its parent and the marks read at its edges,
    which `resolve` turns into op ranges; outside, a span records none."""
    nodes = [0]

    def ops(k):
        nodes[0] += k

    with profiler.capture(lambda: nodes[0]) as layout:
        ops(2)                                              # before any span
        with profiler.span("fixed_step", k=0, device=0):
            ops(3)
            with profiler.span("collide"):
                ops(1)
                with profiler.span("broadphase"):
                    ops(4)
            with profiler.span("empty"):
                pass
            ops(1)
        with profiler.span("fixed_step", k=1):
            ops(5)
    assert profiler.span("outside") is profiler._OFF
    with _cpu_profile():
        with profiler.span("recorded"):
            pass
    assert [s["name"] for s in profiler.recorded()] == ["recorded"]
    kinds = ["kernel"] * 16
    kinds[0], kinds[9] = "memcpy", "memset"
    layout.resolve(lambda mark: mark, kinds)
    got = [(e["name"], e["attrs"], e["parent"], e["ops"]) for e in layout.entries]
    assert got == [("fixed_step", {"k": 0}, None, (2, 11)),
                   ("collide", {}, 0, (5, 10)),
                   ("broadphase", {}, 1, (6, 10)),
                   ("empty", {}, 0, (10, 10)),
                   ("fixed_step", {"k": 1}, None, (11, 16))]
    assert (layout.ops, layout.memcpy, layout.memset) == (16, [0], [9])
    assert profiler._LAYOUT is None and recorder.stack == []


def test_capture_under_a_recording_profiler_also_records_the_spans(recorder):
    with _cpu_profile():
        with profiler.capture(lambda: 7) as layout:
            with profiler.span("outer"):
                with profiler.span("inner", role="x"):
                    profiler.count("n", 3)
    outer, inner = profiler.recorded()
    assert (outer["name"], inner["name"], inner["parent"]) == ("outer", "inner", outer["id"])
    assert inner["counters"] == {"syncs": 0, "n": 3} and inner["attrs"] == {"role": "x"}
    assert [(e["name"], e["parent"], e["marks"]) for e in layout.entries] == \
        [("outer", None, (7, 7)), ("inner", 0, (7, 7))]


def _hand_layout():
    """Two fixed steps of a replayed tick, the first with nested stages."""
    layout = profiler.Layout(lambda: None)
    layout.entries = [
        {"name": "fixed_step", "attrs": {"k": 0}, "parent": None, "ops": (1, 6)},
        {"name": "collide", "attrs": {}, "parent": 0, "ops": (1, 4)},
        {"name": "broadphase", "attrs": {}, "parent": 1, "ops": (1, 2)},
        {"name": "solve_velocity", "attrs": {}, "parent": 0, "ops": (4, 6)},
        {"name": "fixed_step", "attrs": {"k": 1}, "parent": None, "ops": (6, 9)}]
    layout.ops, layout.memcpy, layout.memset = 10, [0], [9]
    return layout


def test_replay_emits_the_layout_under_its_span(recorder, monkeypatch):
    """A recording replay: the span `graph_replay` with the graph's op
    count and copy places, and a zero-length record an entry under it, in
    its step, `replayed` with the entry's op range and `syncs` 0 alone;
    the readers of `benchmark/spans.py` read the same without them. Off,
    `replay` is the shared no-op."""
    from benchmark import harness, spans as bench_spans
    assert profiler.replay(_hand_layout()) is profiler._OFF
    with _cpu_profile():
        for kept in (1, 2):
            with profiler.span("step"):
                with profiler.span("PhysicsSystem.update"):
                    with profiler.replay(_hand_layout()):
                        torch.ones(4).sum()
                    profiler.count("sim_steps_run", 2)
                    profiler.count("sim_steps_kept", kept)
                with profiler.span("render"):
                    profiler.count("tile_pairs", 10)
                    profiler.count("tile_pairs_dropped", kept)
    recs = profiler.recorded()
    for step in (0, 1):
        got = [s for s in recs if s["step"] == step]
        root, update, rep = got[:3]
        assert (rep["name"], rep["parent"]) == ("graph_replay", update["id"])
        assert rep["attrs"] == {"graph_ops": [0, 10], "memcpy": [0], "memset": [9]}
        assert rep["end_ns"] > rep["start_ns"]
        emitted = got[3:8]
        assert [(s["name"], s["attrs"]) for s in emitted] == [
            ("fixed_step", {"k": 0, "replayed": True, "graph_ops": [1, 6]}),
            ("collide", {"replayed": True, "graph_ops": [1, 4]}),
            ("broadphase", {"replayed": True, "graph_ops": [1, 2]}),
            ("solve_velocity", {"replayed": True, "graph_ops": [4, 6]}),
            ("fixed_step", {"k": 1, "replayed": True, "graph_ops": [6, 9]})]
        ids = [s["id"] for s in emitted]
        assert [s["parent"] for s in emitted] == [rep["id"], ids[0], ids[1], ids[0], rep["id"]]
        for s in emitted:
            assert s["start_ns"] == s["end_ns"] == rep["start_ns"]
            assert (s["step"], s["device"], s["counters"]) == (step, rep["device"],
                                                               {"syncs": 0})
        assert [s["name"] for s in got[8:]] == ["render"]
    assert profiler.host_ms(recs).keys() == {"step", "PhysicsSystem.update",
                                             "graph_replay", "render"}
    window = (recs[0]["start_ns"] - 1, recs[-1]["end_ns"] + 1, "bench.step")
    run = harness.Run(prof=([], [], [window]), devices=[torch.device("cpu")],
                      traffic={"trace_steps": 2}, worlds=1)

    def readings():
        return (bench_spans.syncs_per_step(run, "step"),
                bench_spans.host_ms(run, "step", "PhysicsSystem.update"),
                bench_spans.host_ms(run, "step", "graph_replay"),
                bench_spans.ratio_pct(run, "step", None, "sim_steps_kept", "sim_steps_run"),
                bench_spans.ratio_pct(run, "step", "render", "tile_pairs_dropped",
                                      "tile_pairs"))
    with_records = readings()
    monkeypatch.setattr(bench_spans, "recorded", lambda: [
        s for s in recs if not s["attrs"].get("replayed")])
    assert readings() == with_records
    assert with_records[3]["value"] == pytest.approx(100 * 3 / 4)
