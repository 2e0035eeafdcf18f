"""Garden's Ultra quality (`entry.build` with the render block of the
benchmark's configuration `ultra_1080p`: clouds, SSR, SSGI and the 5x5 PCF)
on the CPU at a small size, against the benchmark's plain reference
(`benchmark/reference/scenes.Flagship` with the same block).

The configuration file cut to 64 bodies (a lattice 4 wide) at 128x64,
`grid_dim` 8, its cascades to three of 256; every pass switch, the SSR and
SSGI settings and the 5x5 PCF stay. The program is built, stepped and
checked as the benchmark's `ultra` entry does: three steps from the
initial state, so that the second and third read a real previous frame,
each held to one reference step from the program's own input within the
cell's limits (`benchmark/limits/ultra_1080p.play.json`), the frame state
it hands on (`prev_hdr`, `avg_luminance`, `prev_view_proj`) compared too.
The steps that read a lit previous frame come out of the limits against a
reference without SSR, without SSGI or with the 3x3 PCF, each by the lit
HDR handed on (without SSR by it alone: the image stays within its 8
levels), and a step that hands on a black HDR comes out of them by its
frame state alone. A traced step counts the rays
and pixels that the reference's own confidence and GI, before their
upsample, say it should; an untraced one charges no counter. No JAX.
~25 s serial.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import copy
import types

import pytest
import torch

from benchmark import check, harness, spans, trace
from benchmark.entries import ultra
from benchmark.reference import scenes as ref_scenes
from benchmark.reference.render import ssgi as ref_ssgi
from benchmark.reference.render import ssr as ref_ssr
from garden_tpu_torch.core.config import QUALITY_PRESETS
from garden_tpu_torch.render import ssgi, ssr
from garden_tpu_torch.utils import profiler

CELL = "ultra_1080p.play"
SEED = 2 ** 31 + 4321
STEPS = 3


def small_config():
    cfg = copy.deepcopy(harness.load_cell(CELL)["config"])
    cfg["n_bodies"] = 64
    cfg["bodies"]["lattice"].update(side=4, dims={"x": 4, "y": 4, "z": 4})
    cfg.update(width=128, height=64)
    cfg["physics"]["grid_dim"] = 8
    cfg["render"]["shadow"]["map_size"] = 256
    return cfg


@pytest.fixture(scope="module")
def stepped():
    """(the entry's runner, its initial state, STEPS kept steps, the cell's
    limits, the configuration)."""
    cfg = small_config()
    drv = ultra.build(cfg, {}, SEED, [torch.device("cpu")])
    initial = drv.initial
    kept = []
    for _ in range(STEPS):
        drv.step()
        kept.append(drv.snapshot())
    return drv, initial, kept, harness.load_cell(CELL)["limits"], cfg


def _numbers(drv, initial, kept, cfg):
    """Each kept step's numbers, the reference built from `cfg`."""
    saved = drv.cfg
    drv.cfg = cfg
    try:
        return drv.check(initial, kept)
    finally:
        drv.cfg = saved


def test_the_small_file_is_the_ultra_preset(stepped):
    drv, _, _, _, cfg = stepped
    rcfg = drv.fn.renderer.config
    preset = QUALITY_PRESETS["ultra"]
    assert rcfg.use_clouds and rcfg.use_ssr and rcfg.use_ssgi
    assert {k: getattr(rcfg, k) for k in ("use_clouds", "use_ssr", "use_ssgi")} == {
        k: preset[k] for k in ("use_clouds", "use_ssr", "use_ssgi")}
    assert rcfg.shadow.pcf_radius == preset["shadow"].pcf_radius == 2
    assert rcfg.shadow.map_size == 256 and rcfg.shadow.resolve_step == 1
    bad = copy.deepcopy(cfg)
    bad["ssr"]["steps"] = 8
    with pytest.raises(ValueError, match="screen-space"):
        ultra.require_screen_space(drv.fn, bad)


def test_each_step_matches_the_reference_within_the_cells_limits(stepped):
    drv, initial, kept, limits, cfg = stepped
    per_step = _numbers(drv, initial, kept, cfg)
    assert len(per_step) == STEPS
    for nums in per_step:
        ok, got = check.judge(nums, limits)
        assert ok, got
    # the steps after the first read a lit previous frame
    assert float(kept[0][0]["frame"]["prev_hdr"].abs().max()) == 0.0
    for prev, _, _ in kept[1:]:
        assert float(prev["frame"]["prev_hdr"].max()) > 0.0


@pytest.mark.parametrize("fault", ["ssr_off", "ssgi_off", "pcf_3x3"])
def test_a_reference_without_the_mechanism_fails_the_limits(stepped, fault):
    drv, initial, kept, limits, cfg = stepped
    bad = copy.deepcopy(cfg)
    if fault == "ssr_off":
        bad["render"]["use_ssr"] = False
    elif fault == "ssgi_off":
        bad["render"]["use_ssgi"] = False
    else:
        bad["render"]["shadow"]["pcf_radius"] = 1
    for nums in _numbers(drv, initial, kept[1:], bad):
        assert nums["lit_hdr"] > limits["lit_hdr"], nums


def test_a_black_handed_on_hdr_fails_by_the_frame_state(stepped):
    drv, initial, kept, limits, cfg = stepped
    zeroed = []
    for prev, nxt, image in kept[1:]:
        frame = dict(nxt["frame"], prev_hdr=torch.zeros_like(nxt["frame"]["prev_hdr"]))
        zeroed.append((prev, dict(nxt, frame=frame), image))
    for nums in _numbers(drv, initial, zeroed, cfg):
        ok, got = check.judge(nums, limits)
        assert not ok
        assert got["lit_hdr"]["value"] > got["lit_hdr"]["limit"]
        assert got["image_levels"]["value"] <= got["image_levels"]["limit"]


@pytest.fixture(scope="module")
def traced(stepped):
    """The spans of one traced program step from the last kept state, and
    the reference's confidence and GI before their upsample from the same
    state."""
    drv, _, kept, _, cfg = stepped
    state = kept[-1][1]
    first = profiler.RECORDER.next_step
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        drv.fn(state)
    recorded = [s for s in profiler.recorded() if s["step"] >= first]
    seen = {}

    def spy(module, key):
        up = module.bilateral_upsample_to

        def caught(x, *a):
            seen[key] = x
            return up(x, *a)
        return caught
    ref = ref_scenes.Flagship(cfg, drv.positions.numpy(), torch.device("cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_ssr, "bilateral_upsample_to", spy(ref_ssr, "ssr"))
        mp.setattr(ref_ssgi, "bilateral_upsample_to", spy(ref_ssgi, "ssgi"))
        ref(state)
    return recorded, seen["ssr"][..., 3], seen["ssgi"]


def test_counters_equal_counts_of_the_reference(traced):
    recorded, conf, gi = traced
    (march,) = [s for s in recorded if s["name"] == "ssr"]
    (gather,) = [s for s in recorded if s["name"] == "ssgi"]
    assert march["counters"]["ssr_rays"] == conf.numel() == 16 * 32
    assert march["counters"]["ssr_rays_hit"] == int((conf > 0).sum())
    assert gather["counters"]["ssgi_pixels"] == gi.shape[0] * gi.shape[1] == 32 * 64
    assert gather["counters"]["ssgi_pixels_lit"] == int((gi.amax(-1) > 0).sum())
    assert 0 < march["counters"]["ssr_rays_hit"] < march["counters"]["ssr_rays"]
    assert 0 < gather["counters"]["ssgi_pixels_lit"] < gather["counters"]["ssgi_pixels"]


def test_no_counter_is_charged_while_not_recording(stepped, monkeypatch):
    drv, _, kept, _, _ = stepped
    charged = []
    count = profiler.count
    monkeypatch.setattr(profiler, "count",
                        lambda name, value: (charged.append(name), count(name, value)))
    new = {"ssr_rays", "ssr_rays_hit", "ssgi_pixels", "ssgi_pixels_lit"}
    drv.fn(kept[-1][1])
    assert not profiler.recording()
    assert not new & set(charged)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        drv.fn(kept[-1][1])
    assert new <= set(charged)


@pytest.mark.gpu
def test_counters_add_no_sync_and_untraced_launches_are_unchanged():
    """On a card: a traced step of the small ultra frame counts the same
    syncs with the SSR and SSGI counters as without them, and launches the
    same device ops outside `ssr` and `ssgi`; with the counters off (as in
    every untraced step, where nothing records) those two spans launch what
    they launch with them on, less the counters' own reductions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    drv = ultra.build(small_config(), {}, SEED, [torch.device("cuda")])
    for _ in range(STEPS):
        drv.step()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def traced(counting):
        with pytest.MonkeyPatch.context() as mp:
            if not counting:
                quiet = types.SimpleNamespace(recording=lambda: False, count=profiler.count)
                mp.setattr(ssr, "profiler", quiet)
                mp.setattr(ssgi, "profiler", quiet)
            first = profiler.RECORDER.next_step
            with torch.profiler.profile(activities=acts) as prof:
                drv.fn(drv.state)
                torch.cuda.synchronize()
        run = harness.Run(prof=trace.from_profiler(prof), traffic={"trace_steps": 1})
        counts = {name: spans.launches_per_step(run, name)["value"]
                  for name in ("step", "ssr", "ssgi")}
        return [s for s in profiler.recorded() if s["step"] >= first], counts

    (with_counters, on), (without, off) = traced(True), traced(False)
    assert [s["name"] for s in with_counters] == [s["name"] for s in without]
    assert ([s["counters"]["syncs"] for s in with_counters]
            == [s["counters"]["syncs"] for s in without])
    assert on["step"] - on["ssr"] - on["ssgi"] == off["step"] - off["ssr"] - off["ssgi"]
    assert 0 < on["ssr"] - off["ssr"] <= 4 and 0 < on["ssgi"] - off["ssgi"] <= 4
    (march,) = [s for s in with_counters if s["name"] == "ssr"]
    assert 0 < march["counters"]["ssr_rays_hit"] < march["counters"]["ssr_rays"]
