"""The engine frame (`entry.build_engine_frame`; the benchmark's
configuration `engine_frame_1080p`) on the CPU at a small size, against the
benchmark's plain reference (`benchmark/reference/engine_frame.py`).

The configuration file cut to 64 bodies (a lattice 4 wide), 2 characters
and their one step, and 4 animated entities at 256x128, `grid_dim` 8, its
shadow map to 512; the spawner, the HUD and the tick stay. The program is
built, stepped and checked as the benchmark's `engine_frame` entry does:
two seeded steps, each held to one reference engine frame from the
program's own input within the cell's limits
(`benchmark/limits/engine_frame_1080p.engine.json`). The same steps come
out of the limits against a reference that keeps all four of the
accumulator's steps, or drops the HUD. The file's layout puts the pile's
last box down as a static step between the characters; walk-stairs lifts
the first character onto it within the steps the cell checks, and that
step comes out of the limits against a reference whose casts find
nothing. Stick-to-floor is shown from a state in which it acts: a
character that left the ground last tick standing just over the pile's
top box. A traced step counts the steps the accumulator keeps as the
reference keeps them, and the HUD's covered pixels as the host's own sum
over the clipped rects. ~30 s serial.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import copy

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.entries import engine_frame
from benchmark.reference import engine_frame as ref_engine
from benchmark.reference.physics import queries as ref_queries
from benchmark.reference.physics import world as ref_world
from garden_tpu_torch.utils import profiler

CELL = "engine_frame_1080p.engine"
SEED = 2 ** 31 + 1234
# the steps stepped: the first character, 0.03 m short of the step, climbs
# in the fifth
CLIMB_BY = 5


def small_config():
    cfg = copy.deepcopy(harness.load_cell(CELL)["config"])
    cfg["n_bodies"] = 64
    cfg["bodies"]["lattice"].update(side=4, dims={"x": 4, "y": 4, "z": 4})
    cfg.update(width=256, height=128)
    cfg["render"]["shadow"]["map_size"] = 512
    cfg["characters"]["count"] = 2
    cfg["steps"]["count"] = 1
    cfg["animated"]["count"] = 4
    cfg["physics"].update(max_bodies=66, grid_dim=8)
    return cfg


@pytest.fixture(scope="module")
def stepped():
    """(the entry's runner, its initial state, the snapshots of its first
    CLIMB_BY steps, the cell's limits)."""
    drv = engine_frame.build(small_config(), {}, SEED, [torch.device("cpu")])
    initial = drv.initial
    snaps = []
    for _ in range(CLIMB_BY):
        drv.step()
        snaps.append(drv.snapshot())
    return drv, initial, snaps, harness.load_cell(CELL)["limits"]


@pytest.fixture(scope="module")
def frame(stepped):
    """(the entry's runner, its initial state, two kept steps, the cell's
    limits)."""
    drv, initial, snaps, limits = stepped
    return drv, initial, snaps[:2], limits


def _judge(drv, initial, kept, limits):
    nums = {}
    for n in drv.check(initial, kept):
        check.widest(nums, n)
    return check.judge(nums, limits)


def test_the_program_holds_the_files_counts(frame):
    drv = frame[0]
    cfg = small_config()
    stores = drv.fn.engine.world._stores
    assert int(stores["character"]["has"].sum()) == 2
    assert int(stores["animation"]["has"].sum()) == 4
    assert drv.fn.engine.world.capacity == ref_engine.capacity(cfg) == 64 + 2 + 4 + 2 + 6
    bad = dict(cfg, characters=dict(cfg["characters"], count=3))
    with pytest.raises(ValueError, match="characters"):
        engine_frame.require_engine(drv.fn, bad)


def test_seeded_positions_reach_bodies_and_transforms(frame):
    """The seeded pile, then the file's layout: the last box a static step,
    the characters at their start positions."""
    drv, initial = frame[0], frame[1]
    cfg = small_config()
    pos = drv.positions
    b = initial["physics"]["bodies"]
    step = torch.as_tensor(ref_engine.step_positions(cfg))
    walkers = torch.as_tensor(ref_engine.character_positions(cfg))
    want = torch.cat([pos[:63], step, walkers])
    assert torch.equal(b["pos"][:66], want)
    assert torch.equal(initial["physics"]["prev_pos"][:66], want)
    tf = initial["components"]["transform"]["position"]
    chars = torch.nonzero(initial["components"]["character"]["has"]).squeeze(-1)
    assert torch.equal(tf[:64], want[:64])
    assert torch.equal(tf[chars], walkers)
    assert b["motion"][63] == ref_world.STATIC and b["inv_mass"][63] == 0
    assert bool((b["motion"][1:63] == ref_world.DYNAMIC).all())
    assert float(step[0, 1]) + 0.45 == pytest.approx(0.3)


def test_steps_match_the_reference_within_the_cells_limits(frame):
    drv, initial, kept, limits = frame
    ok, got = _judge(drv, initial, kept, limits)
    assert ok, got
    assert set(got) == set(limits)


def _keep_all_steps(mp):
    mp.setattr(ref_world, "_select_tree", lambda did, new, old: new)
    return "pos_m"


def _no_hud(mp):
    build = ref_engine.EngineFrame.__init__

    def bare(self, *a, **k):
        build(self, *a, **k)
        self.ui_sprites = None
    mp.setattr(ref_engine.EngineFrame, "__init__", bare)
    return "image_levels"


@pytest.mark.parametrize("fault", [_keep_all_steps, _no_hud],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_faulty_reference_fails_the_limits(frame, monkeypatch, fault):
    drv, initial, kept, limits = frame
    number = fault(monkeypatch)
    ok, got = _judge(drv, initial, kept, limits)
    assert not ok
    assert got[number]["value"] > got[number]["limit"], got


def _stepped_off(drv, state):
    """`state` with the first character standing 0.1 m over the pile's top
    box at rest, grounded last tick and not now: stick-to-floor's case."""
    ch = state["components"]["character"]
    row = torch.nonzero(ch["has"]).squeeze(-1)[:1]
    body = ch["body"][row].long()
    phys = state["physics"]
    b = phys["bodies"]
    top = int(torch.argmax(b["pos"][1:64, 1])) + 1
    pos = b["pos"].clone()
    pos[body] = b["pos"][top] + torch.tensor([0.0, 0.45 + 0.9 + 0.1, 0.0])
    vel = b["linvel"].clone()
    vel[body] = 0.0
    phys = dict(phys, bodies=dict(b, pos=pos, linvel=vel),
                grounded=phys["grounded"].clone().index_fill_(0, body, False))
    ch = dict(ch, grounded=ch["grounded"].clone().index_fill_(0, row, True))
    return dict(state, physics=phys, components=dict(state["components"], character=ch))


def test_the_comparison_sees_the_character_casts(frame, monkeypatch):
    drv, initial, kept, limits = frame
    state = _stepped_off(drv, kept[-1][1])
    nxt, image = drv.fn(state)
    step = [(state, nxt, image)]
    ok, got = _judge(drv, initial, step, limits)
    assert ok, got
    cast = ref_queries.cast_sphere

    def no_hit(*a, **k):
        hit = cast(*a, **k)
        return hit._replace(hit=torch.zeros_like(hit.hit))
    monkeypatch.setattr(ref_queries, "cast_sphere", no_hit)
    ok, got = _judge(drv, initial, step, limits)
    assert not ok
    assert got["linvel_mps"]["value"] > got["linvel_mps"]["limit"], got


def _rise(prev, nxt):
    """The characters' rise over one step, in m."""
    ch = prev["components"]["character"]
    body = ch["body"][torch.nonzero(ch["has"]).squeeze(-1)].long()
    return nxt["physics"]["bodies"]["pos"][body, 1] - prev["physics"]["bodies"]["pos"][body, 1]


def test_walk_stairs_lifts_a_character_within_the_checked_steps(stepped, monkeypatch):
    """The cell's own scene: the first character climbs its step at a
    window step the check can draw (after 4 warm-up steps, within the first
    16), and a reference whose casts find nothing fails that step."""
    drv, initial, snaps, limits = stepped
    climbs = [t for t, (prev, nxt, _) in enumerate(snaps)
              if float(torch.max(_rise(prev, nxt))) > 0.3]
    assert climbs == [4]
    traffic = harness.load_cell(CELL)["traffic"]
    assert 0 <= climbs[0] - traffic["warmup_steps"] < traffic["check_within"]
    step = [snaps[climbs[0]]]
    ok, got = _judge(drv, initial, step, limits)
    assert ok, got
    cast = ref_queries.cast_sphere

    def no_hit(*a, **k):
        hit = cast(*a, **k)
        return hit._replace(hit=torch.zeros_like(hit.hit))
    monkeypatch.setattr(ref_queries, "cast_sphere", no_hit)
    ok, got = _judge(drv, initial, step, limits)
    assert not ok
    assert got["pos_m"]["value"] > 0.3, got


@pytest.fixture(scope="module")
def traced(frame):
    """The spans of one traced step of the program from the second kept
    step's state, and the steps the reference's accumulator keeps there."""
    drv, _, kept, _ = frame
    state = kept[-1][1]
    first = profiler.RECORDER.next_step
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        drv.fn(state)
    spans = [s for s in profiler.recorded() if s["step"] >= first]
    ref = ref_engine.EngineFrame(small_config(), drv.positions.numpy(), "cpu")
    did = []
    select = ref_world._select_tree

    def counted(d, new, old):
        if isinstance(new, dict) and "accum" in new:
            did.append(bool(d))
        return select(d, new, old)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_world, "_select_tree", counted)
        ref.tick(state)
    return spans, sum(did), len(did)


def test_the_frame_runs_in_a_step_root_with_its_stages(traced):
    spans = traced[0]
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "step"
    kids = [s["name"] for s in spans if s["parent"] == root["id"]]
    assert kids == ["tick", "instance_matrices", "render"]
    names = {s["name"] for s in spans}
    assert {"CharacterSystem.update", "PhysicsSystem.update", "AnimationSystem.update",
            "ui"} <= names


def test_sim_steps_kept_are_the_references_nsteps(traced):
    spans, kept, run = traced
    (sim,) = [s for s in spans if "sim_steps_run" in s["counters"]]
    assert sim["name"] == "PhysicsSystem.update"
    assert run == sim["counters"]["sim_steps_run"] == 4
    assert sim["counters"]["sim_steps_kept"] == kept


def test_ui_pixels_covered_is_the_host_sum_of_the_clipped_rects(frame, traced):
    drv = frame[0]
    (ui,) = [s for s in traced[0] if s["name"] == "ui"]
    batch = drv.fn.hud_batch
    n, (h, w) = batch.count, (128, 256)
    xs, ys = np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)
    covered = 0
    for x, y, rw, rh in batch._rects[:n]:
        cols = (xs >= x) & (xs < np.float32(x + rw))
        rows = (ys >= y) & (ys < np.float32(y + rh))
        covered += int(cols.sum()) * int(rows.sum())
    assert "ui_sprites" not in ui["counters"] and n > 20
    assert ui["counters"]["ui_pixels"] == n * h * w
    assert ui["counters"]["ui_pixels_covered"] == covered
    assert 0 < covered < 0.01 * n * h * w
