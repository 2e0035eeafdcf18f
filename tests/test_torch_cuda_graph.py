"""The combined step's physics replayed as CUDA graphs
(`garden_tpu_torch.utils.cuda_graph.GraphedStep`, `CombinedStep.physics`).

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
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_flatten, tree_map

from garden_tpu_torch import entry
from garden_tpu_torch.physics import world as pw
from garden_tpu_torch.utils import profiler
from garden_tpu_torch.utils.cuda_graph import GraphedStep

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
    assert [s for s in spans if s["parent"] is not None] == []


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
