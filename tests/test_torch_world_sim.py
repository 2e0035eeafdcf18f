"""The combined world sim (`entry.build` with `WORLD_SIM_OVERRIDES`,
`GLASS_BOXES` and `WORLD_SIM_CAMERA`; the benchmark's configuration
`world_sim_1080p`) on the CPU at a small size, against the benchmark's
plain reference (`benchmark/reference/world_sim.py`).

The configuration file cut to 64 bodies (a lattice 4 wide) at 256x128,
its split atlas to cascades of 256, 128 and 128; the eight-material
rotation, clouds, trans-depth and the file's camera, which sees sky, stay.
The program is built, stepped and checked as the benchmark's `world_sim`
entry does: two seeded steps, each held to one reference step from the
program's own input within the cell's limits (`benchmark/limits/
world_sim_1080p.sim.json`). The same steps come out of the limits against
a reference whose boxes are all opaque, or whose clouds are off: the
comparison sees the translucent passes and the clouds. A traced step
counts the cloud rays above the horizon as the reference's view rays
give them, and the blend kernels' kept slots within those they test.
Without `camera=` the step's constants are the flagship's, bit for bit.
~31 s serial on this host.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import copy

import pytest
import torch

from benchmark import check, harness
from benchmark.entries import world_sim
from benchmark.reference import scenes as ref_scenes
from benchmark.reference.core import math3d as ref_m3
from benchmark.reference.ops.blur import decimate2x
from benchmark.reference.render import lighting as ref_lighting
from garden_tpu_torch import entry
from garden_tpu_torch.utils import profiler

CELL = "world_sim_1080p.sim"
SEED = 2 ** 31 + 1234


def small_config():
    cfg = copy.deepcopy(harness.load_cell(CELL)["config"])
    cfg["n_bodies"] = 64
    cfg["bodies"]["lattice"].update(side=4, dims={"x": 4, "y": 4, "z": 4})
    cfg.update(width=256, height=128)
    cfg["render"]["shadow"]["cascade_sizes"] = [256, 128, 128]
    return cfg


@pytest.fixture(scope="module")
def sim():
    """(the entry's runner, its initial state, two kept steps, the cell's
    limits, the configuration)."""
    cfg = small_config()
    drv = world_sim.build(cfg, {}, SEED, [torch.device("cpu")])
    initial = drv.initial
    kept = []
    for _ in range(2):
        drv.step()
        kept.append(drv.snapshot())
    return drv, initial, kept, harness.load_cell(CELL)["limits"], cfg


def _judge(drv, initial, kept, limits, cfg):
    ref_cfg = drv.cfg
    drv.cfg = cfg
    try:
        nums = {}
        for n in drv.check(initial, kept):
            check.widest(nums, n)
    finally:
        drv.cfg = ref_cfg
    return check.judge(nums, limits)


def test_the_small_file_is_the_world_sim_preset(sim):
    drv, _, _, _, cfg = sim
    assert entry.WORLD_SIM_OVERRIDES == dict(entry.GLASS_OVERRIDES, use_clouds=True)
    rcfg = drv.fn.renderer.config
    assert rcfg.use_clouds and rcfg.use_trans_depth and rcfg.use_oit
    assert rcfg.shadow.cascade_sizes == (256, 128, 128)
    assert world_sim.materials(cfg) == entry.GLASS_BOXES
    cam = cfg["camera"]
    assert (tuple(cam["eye"]), tuple(cam["target"])) == entry.WORLD_SIM_CAMERA


def test_steps_match_the_reference_within_the_cells_limits(sim):
    drv, initial, kept, limits, cfg = sim
    ok, got = _judge(drv, initial, kept, limits, cfg)
    assert ok, got


@pytest.mark.parametrize("fault", ["all_opaque", "clouds_off"])
def test_a_reference_without_the_mechanism_fails_the_limits(sim, fault):
    drv, initial, kept, limits, cfg = sim
    bad = copy.deepcopy(cfg)
    if fault == "all_opaque":
        bad["materials"] = [{"base_color": [0.8, 0.3, 0.2]}] * 8
    else:
        bad["render"]["use_clouds"] = False
    ok, got = _judge(drv, initial, kept, limits, bad)
    assert not ok
    assert got["image_levels"]["value"] > got["image_levels"]["limit"], got


@pytest.fixture(scope="module")
def traced(sim):
    """The spans of one traced step of the program from the second kept
    step's state."""
    drv = sim[0]
    state = sim[2][-1][1]
    first = profiler.RECORDER.next_step
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        drv.fn(state)
    return [s for s in profiler.recorded() if s["step"] >= first]


def test_cloud_rays_up_counts_the_rays_above_the_horizon(sim, traced):
    drv, _, _, _, cfg = sim
    (march,) = [s for s in traced if s["name"] == "clouds"]
    rays = ref_lighting.view_rays({"depth": torch.zeros(cfg["height"], cfg["width"])},
                                  drv.fn.constants)
    half = decimate2x(rays)
    mu = ref_m3.normalize(half)[..., 1]
    assert march["counters"]["cloud_rays"] == mu.numel()
    assert march["counters"]["cloud_rays_up"] == int((mu > 0.02).sum())
    assert 0.25 * mu.numel() < march["counters"]["cloud_rays_up"] < mu.numel()
    assert [s["name"] for s in traced].count("cloud_shadow") == 1


def test_blend_kernels_keep_a_part_of_the_slots_they_test(traced):
    by = {s["name"]: s["counters"] for s in traced if "blend_slots" in s["counters"]}
    assert {"oit", "refraction", "sorted", "csm_render"} <= set(by)
    for c in by.values():
        assert 0 <= c["blend_slots_kept"] <= c["blend_slots"]
    assert sum(c["blend_slots_kept"] for c in by.values()) > 0
    assert sum(c["blend_slots"] for c in by.values()) > 0


def test_default_camera_is_the_flagships_bit_for_bit():
    n, w, h = 64, 256, 128
    step, _ = entry.build(n, w, h, grid_dim=8, device="cpu")
    frozen = ref_scenes._camera(4, w, h, "cpu")
    assert check.differing_leaves(step.constants, frozen) == 0
    named, _ = entry.build(n, w, h, grid_dim=8, device="cpu", camera=None)
    assert check.differing_leaves(step.constants, named.constants) == 0
    moved, _ = entry.build(n, w, h, grid_dim=8, device="cpu", camera=entry.WORLD_SIM_CAMERA)
    assert check.differing_leaves(step.constants, moved.constants) > 0


@pytest.mark.gpu
def test_traced_step_on_card_counts_without_a_sync():
    """On a card: the small world sim's traced step counts the same syncs
    with its counters as without them (the kernels' `kept` and the ray
    count are device tensors, never read back), and the counts keep the
    bounds they keep on the CPU. The entry builds and loads the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    drv = world_sim.build(small_config(), {}, SEED, [torch.device("cuda")])
    for _ in range(3):
        drv.step()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def traced(counting):
        with pytest.MonkeyPatch.context() as mp:
            if not counting:
                mp.setattr(profiler, "recording", lambda: False)
            first = profiler.RECORDER.next_step
            with torch.profiler.profile(activities=acts):
                drv.fn(drv.state)
            torch.cuda.synchronize()
        return [s for s in profiler.recorded() if s["step"] >= first]

    with_counters, without = traced(True), traced(False)
    assert [s["name"] for s in with_counters] == [s["name"] for s in without]
    assert ([s["counters"]["syncs"] for s in with_counters]
            == [s["counters"]["syncs"] for s in without])
    (march,) = [s for s in with_counters if s["name"] == "clouds"]
    assert 0 < march["counters"]["cloud_rays_up"] < march["counters"]["cloud_rays"]
    by = {s["name"]: s["counters"] for s in with_counters if "blend_slots" in s["counters"]}
    assert {"oit", "refraction", "sorted", "csm_render"} <= set(by)
    for c in by.values():
        assert 0 <= c["blend_slots_kept"] <= c["blend_slots"]
    assert sum(c["blend_slots_kept"] for c in by.values()) > 0
