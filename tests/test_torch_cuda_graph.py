"""The combined step's physics replayed as CUDA graphs
(`garden_tpu_torch.utils.cuda_graph.GraphedStep`, `CombinedStep.physics`),
and the engine tick's fixed-step loop (`PhysicsSystem.fixed_steps` over
`physics.world.fixed_steps`).

On the CPU the wrapper calls `physics.world.step` eagerly every time: the
same bits, the stage spans as before, `graph_calls` 1 and `graph_replays`
0 charged to the `physics` span. The rest needs a card (marked `gpu`; this
file imports no JAX, so on a machine without it run
`python -m pytest --noconftest -m gpu tests/test_torch_cuda_graph.py -q`):
graphed steps of the flagship world at 28 and 10,240 bodies equal eager
`world.step` in every bit of every leaf; a step's outputs stay as they were
after two later steps are issued behind it, and so does its input; two
states of one layout in turn each get their own result (the copy in); a
second layout captures a second graph; `CombinedStep.to` a second card
replays there; a traced replay counts 1 / 1 and opens no stage span.

The engine tick: on the CPU `PhysicsSystem.update` runs the loop eagerly,
charges its span `graph_calls` 1, `graph_replays` 0, `sim_steps_run` 4 and
the steps kept, and leaves the physics state of the benchmark's frozen
`simulate` (`benchmark/reference/physics/world.py`) in every bit, over ticks
that keep 0, 1, 2 and 4 steps and the cascade clamp; the loop's config, h,
step count and present types are leaves of its tree, so each keys a graph
by value. On a card, 12 ticks of the benchmark's engine cell at its full
size with such deltas: every leaf of the graphed update's physics state
equal to eager `simulate`'s, outputs that outlive two later replays, and a
new shape type captures a graph of its own.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import collections
import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_flatten, tree_map

from benchmark import harness, replayed, trace
from benchmark.entries import engine_frame
from benchmark.reference.core import config as ref_config
from benchmark.reference.physics import world as ref_world
from garden_tpu_torch import entry
from garden_tpu_torch.core.config import EngineConfig, PhysicsConfig
from garden_tpu_torch.engine import Engine
from garden_tpu_torch.physics import shapes as sh
from garden_tpu_torch.physics import world as pw
from garden_tpu_torch.systems.physics import PhysicsSystem
from garden_tpu_torch.utils import cuda_graph, profiler
from garden_tpu_torch.utils.cuda_graph import GraphedStep, _Graph

H = 1.0 / 60.0
STAGES = {"collide", "broadphase", "narrowphase", "warm_match",
          "solve_velocity", "integrate", "sleep_misc"}


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder for the test, the module's own put back after."""
    rec = profiler.Recorder()
    monkeypatch.setattr(profiler, "RECORDER", rec)
    return rec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _pile(n_bodies, device):
    """The flagship world at n_bodies: its combined step (physics only),
    state on `device`, and the eager step it replays."""
    world, pcfg, _ = entry.flagship_world(n_bodies, grid_dim=64 if n_bodies > 1000 else 8)
    types = world.shapes.present_types()
    step = entry.CombinedStep(pcfg, types, None, None, None, n_bodies)
    return step, world.device_state(device), lambda s: pw.step(s, pcfg, H, types)


def _leaves(tree):
    return tree_flatten(tree)[0]


def _passed_through(out, state):
    """The leaves the step passes through unchanged are the caller's own."""
    return all(x is y for key in ("shapes", "layer_table", "prev_pos", "prev_quat")
               for x, y in zip(_leaves(out[key]), _leaves(state[key])))


def _bits(x):
    return x.reshape(-1).view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(a, b):
    assert tree_flatten(a)[1] == tree_flatten(b)[1]
    for i, (x, y) in enumerate(zip(_leaves(a), _leaves(b))):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(_bits(x), _bits(y)), i


def test_cpu_physics_is_the_eager_step_with_its_stage_spans(recorder):
    step, state, eager = _pile(28, "cpu")
    for _ in range(3):
        state = step.physics(state)
    with profile(activities=[ProfilerActivity.CPU]):
        out = step.physics(state)
    _same_bits(out, eager(state))
    assert _passed_through(out, state)
    assert step.physics_step.graphs == {}
    spans = profiler.recorded()
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "physics"
    assert (root["counters"]["graph_calls"], root["counters"]["graph_replays"]) == (1, 0)
    assert STAGES <= {s["name"] for s in spans if s["parent"] is not None}


@pytest.mark.gpu
@pytest.mark.parametrize("n_bodies", [28, 10240])
def test_graphed_physics_equals_eager_bit_for_bit(cuda, n_bodies):
    """24 graphed steps of the falling pile, each against the eager step
    from the same input; the leaves the step passes through stay the
    caller's own."""
    step, state, eager = _pile(n_bodies, cuda)
    for k in range(24):
        out = step.physics(state)
        _same_bits(out, eager(state))
        assert _passed_through(out, state), k
        state = out
    (graph,) = step.physics_step.graphs.values()
    assert graph.graph is not None
    assert int((state["warm"]["key"] >= 0).sum()) > 0       # the pile has landed


@pytest.mark.gpu
def test_outputs_and_inputs_outlive_later_replays(cuda):
    """Step k's input and outputs, held by the caller, read the same after
    steps k + 1 and k + 2 have been issued behind it with no wait."""
    step, state, eager = _pile(28, cuda)
    for _ in range(6):
        state = step.physics(state)
    want = eager(state)
    before = tree_map(torch.clone, state)
    out_k = step.physics(state)
    held = tree_map(torch.clone, out_k)                     # read before, on the stream
    nxt = step.physics(out_k)
    step.physics(nxt)
    torch.cuda.synchronize()
    _same_bits(out_k, want)
    _same_bits(out_k, held)
    _same_bits(state, before)


@pytest.mark.gpu
def test_states_in_turn_each_get_their_own_result(cuda):
    """Two states of one layout, graphed in turn, each equal their own
    eager step: the replay reads the values it was given."""
    step, a, eager = _pile(28, cuda)
    for _ in range(8):
        a = eager(a)
    b = dict(a, bodies=dict(a["bodies"], pos=a["bodies"]["pos"] + torch.tensor(
        [0.0, 0.3, 0.0], device=cuda) * (torch.arange(28, device=cuda) > 0)[:, None]))
    for _ in range(3):
        for s in (a, b):
            _same_bits(step.physics(s), eager(s))
    assert not torch.equal(step.physics(a)["bodies"]["pos"], step.physics(b)["bodies"]["pos"])
    assert len(step.physics_step.graphs) == 1


@pytest.mark.gpu
def test_second_layout_captures_a_second_graph(cuda):
    step, small, eager = _pile(28, cuda)
    world, _, _ = entry.flagship_world(40, grid_dim=8)
    big = world.device_state(cuda)
    for _ in range(3):
        for s in (small, big):
            _same_bits(step.physics(s), eager(s))
    graphs = list(step.physics_step.graphs.values())
    assert len(graphs) == 2 and all(g.graph is not None for g in graphs)


@pytest.mark.gpu
def test_step_moved_to_a_second_card_replays_there():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    cards = [torch.device("cuda", i) for i in range(2)]
    torch.cuda.set_device(cards[0])
    step, state = entry.build(**entry.DRYRUN_SIZE, cfg_overrides=entry.DRYRUN_OVERRIDES,
                              device=cards[0])
    there = step.to(cards[1])
    phys = tree_map(lambda x: x.to(cards[1]), state["physics"])
    eager = lambda s: pw.step(s, step.pcfg, H, step.present_types)
    for _ in range(4):
        out = there.physics(phys)
        assert out["bodies"]["pos"].device == cards[1]
        _same_bits(out, eager(phys))
        phys = out
    (graph,) = there.physics_step.graphs.values()
    assert graph.device == cards[1] and step.physics_step.graphs == {}


@pytest.mark.gpu
def test_traced_replay_counts_one_call_and_one_replay(cuda, recorder):
    """A traced replay counts 1 / 1; its only child is the `graph_replay`
    span, under which the capture's stage spans come back as zero-length
    `replayed` records, nested as captured."""
    step, state, _ = _pile(28, cuda)
    for _ in range(3):
        state = step.physics(state)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        step.physics(state)
        torch.cuda.synchronize()
    spans = profiler.recorded()
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "physics"
    assert (root["counters"]["graph_calls"], root["counters"]["graph_replays"]) == (1, 1)
    assert root["counters"]["syncs"] == 0 and root["counters"]["pair_slots"] > 0
    (rep,) = [s for s in spans if s["parent"] == root["id"]]
    assert rep["name"] == "graph_replay" and rep["counters"] == {"syncs": 0}
    lo, n = rep["attrs"]["graph_ops"]
    assert lo == 0 and n > 0
    replayed = [s for s in spans if s["attrs"].get("replayed")]
    assert len(replayed) == len(spans) - 2
    assert STAGES <= {s["name"] for s in replayed}
    by_id = {s["id"]: s for s in spans}
    for s in replayed:
        assert s["start_ns"] == s["end_ns"] == rep["start_ns"]
        assert s["counters"] == {"syncs": 0} and s["step"] == root["step"]
        a, b = s["attrs"]["graph_ops"]
        pa, pb = by_id[s["parent"]]["attrs"]["graph_ops"]
        assert pa <= a <= b <= pb
    assert {by_id[s["parent"]]["name"] for s in replayed if s["name"] == "broadphase"} == \
        {"collide"}


def test_graphed_step_counts_eager_calls_on_the_cpu(recorder):
    """GraphedStep alone: a function over a tree on the CPU is called every
    time, its result returned as it is."""
    calls = []

    def fn(tree):
        calls.append(tree)
        return {"y": tree["x"] * 2, "same": tree["same"]}

    graphed = GraphedStep(fn)
    tree = {"x": torch.arange(4.0), "same": torch.ones(2)}
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("root"):
            for _ in range(3):
                out = graphed(tree)
    assert len(calls) == 3 and out["same"] is tree["same"]
    assert torch.equal(out["y"], torch.arange(4.0) * 2)
    (root,) = profiler.recorded()
    assert (root["counters"]["graph_calls"], root["counters"]["graph_replays"]) == (3, 0)


# -- the engine tick's fixed-step loop ----------------------------------------

# deltas from a zero accumulator that keep 0, 1, 2, 4 steps, then the
# cascade clamp's 1 (the lag passes 0.5 s while more than one step is due)
DELTAS = (0.005, 0.015, 0.035, 0.07, 0.45)
KEPT = (0, 1, 2, 4, 1)


def _small_engine(device="cpu"):
    """An Engine with the physics system alone, on `device`: a plane,
    boxes, spheres and a capsule, stepped through `PhysicsSystem.update`."""
    pcfg = PhysicsConfig(max_bodies=16, grid_dim=8, cell_size=2.0)
    eng = Engine(EngineConfig(capacity=16, physics=pcfg), device=device)
    phys = eng.create_system(PhysicsSystem(pcfg))
    eng.initialize()
    shapes = phys.physics.shapes
    phys.add_rigidbody(eng.world.create_entity(), shapes.plane((0, 1, 0), 0.0),
                       motion=pw.STATIC)
    box, ball = shapes.box((0.4, 0.4, 0.4)), shapes.sphere(0.3)
    for k in range(8):
        phys.add_rigidbody(eng.world.create_entity(), box if k % 2 else ball,
                           position=(k * 0.9 - 3.0, 0.5 + 0.3 * k, 0.0))
    phys.add_rigidbody(eng.world.create_entity(), shapes.capsule(0.3, 0.6),
                       position=(0.0, 2.0, 1.5))
    eng.build_step()
    return eng, phys


def test_cpu_tick_runs_the_eager_loop_of_the_frozen_simulate(recorder):
    eng, phys = _small_engine()
    types = phys.physics.shapes.present_types()
    ref_cfg = ref_config.PhysicsConfig(**dataclasses.asdict(phys.config))
    state = eng.device_state()
    for dt, kept in zip(DELTAS, KEPT):
        want = ref_world.simulate(state["physics"], ref_cfg, dt, present_types=types)
        first = profiler.RECORDER.next_step
        with profile(activities=[ProfilerActivity.CPU]):
            state = eng._step(state, dt)
        _same_bits(state["physics"], want)
        spans = [s for s in profiler.recorded() if s["step"] >= first]
        (update,) = [s for s in spans if s["name"] == "PhysicsSystem.update"]
        counters = update["counters"]
        assert (counters["graph_calls"], counters["graph_replays"]) == (1, 0)
        assert (counters["sim_steps_run"], counters["sim_steps_kept"]) == (4, kept), dt
        assert sum(s["name"] == "collide" for s in spans) == 4
    assert phys.fixed_steps.graphs == {}
    assert float(state["physics"]["lag_time"]) > phys.config.cascade_lag_threshold


def test_cpu_tick_opens_a_fixed_step_span_a_step(recorder):
    """Each of the loop's 4 steps, kept or not, in a `fixed_step` span
    with its index `k`, under `PhysicsSystem.update`, each holding one
    step's stages."""
    eng, _ = _small_engine()
    state = eng.device_state()
    for dt in (0.015, 0.07):
        first = profiler.RECORDER.next_step
        with profile(activities=[ProfilerActivity.CPU]):
            state = eng._step(state, dt)
        spans = [s for s in profiler.recorded() if s["step"] >= first]
        (update,) = [s for s in spans if s["name"] == "PhysicsSystem.update"]
        steps = [s for s in spans if s["name"] == "fixed_step"]
        assert [s["attrs"] for s in steps] == [{"k": k} for k in range(4)]
        assert all(s["parent"] == update["id"] for s in steps)
        assert [s["start_ns"] < s["end_ns"] for s in steps] == [True] * 4
        for s in steps:
            (collide,) = [c for c in spans if c["parent"] == s["id"] and c["name"] == "collide"]
            assert collide["start_ns"] >= s["start_ns"] and collide["end_ns"] <= s["end_ns"]


def test_loop_is_keyed_by_its_config_step_and_shape_types(monkeypatch):
    """The tree the physics system hands its graphed loop: the state,
    nsteps, and the config, h, step count and present types as leaves
    that key a graph by value, so another shape type, config or step
    count never replays a stale capture."""
    eng, phys = _small_engine()
    trees = []
    graphed = phys.fixed_steps
    monkeypatch.setattr(phys, "fixed_steps", lambda args: trees.append(args) or graphed(args))
    eng._step(eng.device_state(), 0.02)
    (tree,) = trees
    assert tree[2:] == (phys.config, 1.0 / 60, 4, phys.physics.shapes.present_types())

    def key(changes):
        """GraphedStep's key of the tree with {index: leaf} put in."""
        leaves, spec = tree_flatten(tuple(changes.get(i, x) for i, x in enumerate(tree)))
        return spec, tuple(cuda_graph._leaf_key(x) for x in leaves)
    assert key({}) == key({2: dataclasses.replace(phys.config)})
    assert key({}) != key({2: dataclasses.replace(phys.config, solver_iterations=9)})
    assert key({}) != key({3: 1.0 / 30}) and key({}) != key({4: 3})
    assert key({}) != key({5: tree[5] | {sh.HULL}})


def _kept(before, after, dt, config):
    """The steps the accumulator kept in a tick, from its accumulator."""
    if float(after["lag_time"]) > config.cascade_lag_threshold:
        return 1
    return round((float(before["accum"]) + dt - float(after["accum"]))
                 * config.simulation_rate)


@pytest.mark.gpu
def test_graphed_tick_equals_eager_simulate_at_the_engine_cell(cuda):
    """12 ticks of the engine cell: each tick's graphed update against eager
    `simulate` from the same input, every leaf of the physics state; then
    the whole tick steps on through the same graph."""
    cell = harness.load_cell("engine_frame_1080p.engine")
    run = engine_frame.build(cell["config"], cell["traffic"], 2 ** 31 + 5, [cuda])
    phys = run.fn.engine.world.systems["PhysicsSystem"]
    types = phys.physics.shapes.present_types()
    assert len(types) >= 3                                   # plane, box, capsule
    # from a zero accumulator: 1, 0 (four times), 2, 4, 4 (of 12 due), the
    # cascade clamp's 1, then 1, 0, 1
    deltas = (1 / 60, 0.004, 0.004, 0.004, 0.004, 0.02, 4 / 60 + 0.002, 0.2, 0.3,
              1 / 60, 0.0, 1 / 60)
    state, kept, clamped = run.state, [], 0
    for dt in deltas:
        got = phys.update(state, {"delta_time": dt})["physics"]
        want = pw.simulate(state["physics"], phys.config, dt, present_types=types)
        _same_bits(got, want)
        kept.append(_kept(state["physics"], want, dt, phys.config))
        clamped += float(want["lag_time"]) > phys.config.cascade_lag_threshold
        state = run.fn.tick(state, dt)
    assert {0, 1, 2, 4} <= set(kept) and clamped, kept
    (graph,) = phys.fixed_steps.graphs.values()
    assert isinstance(graph, _Graph)
    # a tick's output and input, held by the caller, outlive two replays
    before = tree_map(torch.clone, state["physics"])
    out = phys.update(state, {"delta_time": 2 / 60})["physics"]
    held = tree_map(torch.clone, out)
    nxt = phys.update(dict(state, physics=out), {"delta_time": 2 / 60})
    phys.update(nxt, {"delta_time": 2 / 60})
    torch.cuda.synchronize()
    _same_bits(out, held)
    _same_bits(state["physics"], before)
    _same_bits(out, pw.simulate(before, phys.config, 2 / 60, present_types=types))
    # a new shape type is a new key: eager, captured, then replayed
    phys.physics.shapes.sphere(0.25)
    more = phys.physics.shapes.present_types()
    assert more != types
    for _ in range(3):
        _same_bits(phys.update(state, {"delta_time": 1 / 60})["physics"],
                   pw.simulate(state["physics"], phys.config, 1 / 60, present_types=more))
    assert len(phys.fixed_steps.graphs) == 2
    assert all(isinstance(g, _Graph) for g in phys.fixed_steps.graphs.values())


# -- the capture's span layout, replayed ---------------------------------------

def _traced(device, fn, steps=1):
    """fn() `steps` times under the profiler, each in a `bench.step` range:
    the harness's view of the trace."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with torch.profiler.record_function("bench.step"):
                fn()
        torch.cuda.synchronize()
    return harness.Run(prof=trace.from_profiler(prof), devices=[device],
                       traffic={"trace_steps": steps}, worlds=1)


def _kind(name):
    """An op's name, a memset's or copy's only its kind: the trace names
    them by memory kind ("Memset (Device)", "Memset (Unknown)"), or, where
    the driver runs the graph's nodes as its own kernels, "memset32",
    "memcpy32_post"."""
    kind = replayed.op_kind(name)
    return name if kind == "kernel" else kind


def _ops_in(name, ops, launches, ranges):
    """The names of the device ops launched inside each range `name`, in
    device order."""
    out = []
    for start, end, rname in sorted(ranges):
        if rname == name:
            corr = {c for t, c in launches if start <= t <= end}
            out += [_kind(op[3]) for op in sorted(ops, key=lambda op: op[1])
                    if op[4] in corr]
    return out


@pytest.fixture(scope="module")
def headless_replay():
    """The full-size flagship world: one traced replay of its physics step,
    sliced (`benchmark/replayed.py`), and the trace of one eager
    `world.step` from the same state (its launches and ranges only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda", torch.cuda.current_device())
    step, state, eager = _pile(10240, cuda)
    for _ in range(3):
        state = step.physics(state)
    run = _traced(cuda, lambda: step.physics(state))
    (sliced,) = replayed.slices(run, "physics")
    # the second of two eager steps, in a warm profiler session
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            with torch.profiler.record_function("eager"):
                eager(state)
        torch.cuda.synchronize()
    ops, launches, ranges = trace.from_profiler(prof)
    lo, hi = max(r[:2] for r in ranges if r[2] == "eager")
    return sliced, (ops, [x for x in launches if lo <= x[0] <= hi],
                    [r for r in ranges if lo <= r[0] <= hi])


@pytest.mark.gpu
def test_replayed_stages_run_the_eager_steps_kernels_in_order(headless_replay):
    """Each replayed stage runs the kernels of the same stage of an eager
    step from the same state, in the same order; the three the benchmark
    reads take within 10% of the eager stage's device time."""
    (rep, recs, ops), (eops, elaunches, eranges) = headless_replay
    assert len(ops) == rep["attrs"]["graph_ops"][1] > 1000
    assert STAGES <= {s["name"] for s in recs}
    for s in recs:
        lo, hi = s["attrs"]["graph_ops"]
        assert [_kind(op[3]) for op in ops[lo:hi]] == _ops_in(s["name"], eops, elaunches,
                                                               eranges), s["name"]
    eager_ns = trace.stage_times(eops, elaunches, eranges, STAGES)
    for s in recs:
        if s["name"] in ("broadphase", "narrowphase", "solve_velocity"):
            lo, hi = s["attrs"]["graph_ops"]
            ns = sum(op[2] - op[1] for op in ops[lo:hi])
            assert ns == pytest.approx(eager_ns[s["name"]][1], rel=0.1), s["name"]


@pytest.mark.gpu
def test_replayed_spans_and_the_ops_outside_them_partition_the_replay(headless_replay):
    """Sibling records name disjoint op ranges inside their parent's; the
    ops outside the top-level records are those the eager step launches
    outside its top-level stage ranges, in the same order."""
    (rep, recs, ops), (eops, elaunches, eranges) = headless_replay
    by_id = {s["id"]: tuple(s["attrs"]["graph_ops"]) for s in recs}
    by_id[rep["id"]] = (0, len(ops))
    kids = collections.defaultdict(list)
    for s in recs:
        kids[s["parent"]].append(by_id[s["id"]])
    for parent, ranges in kids.items():
        ranges.sort()
        lo, hi = by_id[parent]
        assert lo <= ranges[0][0] and ranges[-1][1] <= hi, parent
        assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:])), parent
    inside = {i for lo, hi in kids[rep["id"]] for i in range(lo, hi)}
    outside = [_kind(op[3]) for i, op in enumerate(ops) if i not in inside]
    top = {s["name"] for s in recs if s["parent"] == rep["id"]}
    stage = set()
    for start, end, name in eranges:
        if name in top:
            stage |= {c for t, c in elaunches if start <= t <= end}
    step = {c for _, c in elaunches}
    eager_outside = [_kind(op[3]) for op in sorted(eops, key=lambda op: op[1])
                     if op[4] in step and op[4] not in stage]
    assert 0 < len(outside) < 0.05 * len(ops)
    assert outside == eager_outside


@pytest.mark.gpu
def test_layout_recording_adds_no_node_and_changes_no_bit(cuda):
    """With no profiler recording, the graph captured while recording its
    layout has the nodes, in the same kinds and order, of the graph
    captured without, and its replays give the same bits."""
    _, state, eager = _pile(10240, cuda)
    reads, layouts, outs = [], [], []

    def counted(tree):
        out = eager(tree)
        got = cuda_graph.chain(torch.cuda.current_stream().cuda_stream)
        if got is not None:
            reads.append((len(got[0]), got[1]))
        return out
    for recording in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not recording:
                mp.setattr(profiler, "capture", lambda mark: contextlib.nullcontext())
            graphed, s = GraphedStep(counted), state
            for _ in range(4):
                s = graphed(s)
            outs.append(s)
            (graph,) = graphed.graphs.values()
            layouts.append(graph.layout)
    assert len(reads) == 2 and reads[0] == reads[1]
    assert layouts[1] is None and layouts[0].ops == len(reads[0][1]) > 1000
    _same_bits(outs[0], outs[1])


@pytest.mark.gpu
def test_discarded_steps_read_zero_on_a_tick_that_keeps_all_four(cuda, recorder):
    """The engine tick's graphed loop on a card: a traced tick that keeps
    4 steps reads 0 discarded device ms, one that keeps 1 reads the 3
    others'."""
    eng, phys = _small_engine(cuda)
    state = eng.device_state()
    for _ in range(3):
        state = eng._step(state, H)
    (graph,) = phys.fixed_steps.graphs.values()
    assert isinstance(graph, _Graph) and graph.layout is not None

    def tick(dt):
        with profiler.span("step"):
            eng._step(state, dt)
    got = {}
    for dt in (4 * H + 1e-3, H + 1e-4):
        first = profiler.RECORDER.next_step
        run = _traced(cuda, lambda: tick(dt))
        (update,) = [s for s in profiler.recorded() if s["step"] >= first
                     and s["name"] == "PhysicsSystem.update"]
        kept = update["counters"]["sim_steps_kept"]
        got[kept] = harness.reader("discarded_steps_device_ms.engine")(run)
    assert set(got) == {4, 1}
    assert got[4] == {"value": 0.0, "replays": 1}
    assert got[1]["value"] > 0
