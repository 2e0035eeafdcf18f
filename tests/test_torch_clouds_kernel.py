"""The cloud kernels (`csrc/clouds.cu`: the march and the shadow) and the
dispatch in `render/clouds.py` that chooses them.

On the CPU: `render_clouds` and `cloud_shadow` take their plain versions
and give the values of the benchmark's frozen plain reference
(`benchmark/reference/render/clouds.py`, the module as it was before the
kernels) in every bit; their defaults are the world sim's cloud layer;
each call charges `cloud_calls` 1 and `cloud_kernel_calls` 0 to its span,
and the march its `cloud_rays` and `cloud_rays_up`; the CUDA wrappers
refuse CPU tensors (no fallback).

On a card (`gpu`; this file imports no JAX, so run it with
`python -m pytest --noconftest -m gpu tests/test_torch_clouds_kernel.py -q`):
the kernels against the plain versions run on the same card, at the world
sim's shapes (the 518,400 half-res view rays of `entry.WORLD_SIM_CAMERA`
at 1920x1080, and the ground points under them:
`entry.world_sim_cloud_inputs`) and at a ragged
small size: rgb, alpha and the shadow in every bit (the kernels run the
plain versions' float32 operations in the same order, built with
-fmad=false); rays with mu <= 0.02 exactly 0; one call one launch; no
host synchronization, with a profiler recording or without, and the
kernel's count of up rays equal to the plain version's.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.entries import world_sim
from benchmark.reference.render import clouds as ref_clouds
from garden_tpu_torch import cuda_build, entry
from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.render import clouds
from garden_tpu_torch.utils import profiler

ROOT = Path(__file__).resolve().parents[1]
SUN = (0.4, 0.7, 0.5)
DEFAULTS = {"render_clouds": {"camera_height": 0.2, "time": None, "base_km": 1.2,
                              "top_km": 2.4, "coverage": 0.45, "steps": 10, "seed": 0},
            "cloud_shadow": {"time": None, "base_km": 1.2, "coverage": 0.45, "seed": 0}}


def _rays(shape, seed):
    """Random view directions (shape..., 3), a third of them below the
    clouds' horizon."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(*shape, 3)).astype(np.float32)
    d[..., 1] = np.abs(d[..., 1]) * np.where(rng.uniform(size=shape) < 0.33, -0.2, 1.0)
    return torch.from_numpy(d)


def _ground(shape, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-3e3, 3e3, (*shape, 3)).astype(np.float32)
    p[..., 1] = rng.uniform(-2.0, 30.0, shape)
    return torch.from_numpy(p)


def _spans(fn):
    """fn() inside `clouds` and `cloud_shadow` spans of one recorded root
    step -> ({span name: counters}, fn's result)."""
    first = profiler.RECORDER.next_step
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.span("step"):
            out = fn()
    spans = [s for s in profiler.recorded() if s["step"] >= first]
    return {s["name"]: s["counters"] for s in spans}, out


# -- the CPU: the plain path ---------------------------------------------------

def test_cpu_tensors_give_the_plain_reference_bits():
    rays, ground = _rays((6, 20), 1), _ground((5, 7), 2)
    sun, t = torch.tensor(SUN), torch.tensor(3.5)
    launches = (cuda_build.launches["cloud_march"], cuda_build.launches["cloud_shadow"])
    rgb, alpha = clouds.render_clouds(rays, sun, time=t)
    ref_rgb, ref_alpha = ref_clouds.render_clouds(rays, sun, time=t)
    assert torch.equal(rgb, ref_rgb) and torch.equal(alpha, ref_alpha)
    assert float(alpha.max()) > 0.05
    shadow = clouds.cloud_shadow(ground, sun, time=t)
    assert torch.equal(shadow, ref_clouds.cloud_shadow(ground, sun, time=t))
    assert float(shadow.min()) < 1.0
    assert (cuda_build.launches["cloud_march"],
            cuda_build.launches["cloud_shadow"]) == launches
    assert all(type(n) is int for n in launches)


def test_defaults_are_the_world_sims_cloud_layer():
    for fn in (clouds.render_clouds, clouds.cloud_shadow):
        params = inspect.signature(fn).parameters
        got = {k: p.default for k, p in params.items() if p.default is not inspect.Parameter.empty}
        assert got == DEFAULTS[fn.__name__]
        plain = getattr(clouds, f"{fn.__name__}_plain")
        assert inspect.signature(plain) == inspect.signature(fn)
    cfg = json.loads((ROOT / "benchmark/configs/world_sim_1080p.json").read_text())
    world_sim.require_cloud_layer(cfg)
    with pytest.raises(ValueError):
        world_sim.require_cloud_layer(dict(cfg, clouds=dict(cfg["clouds"], steps=12)))


@pytest.mark.parametrize("kernel", ["render_clouds_cuda", "cloud_shadow_cuda"])
def test_cuda_wrappers_refuse_cpu_tensors(kernel):
    with pytest.raises(ValueError, match="CUDA"):
        getattr(clouds, kernel)(torch.zeros(4, 3), torch.tensor(SUN))


def test_other_devices_have_no_path():
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="no path"):
        clouds.render_clouds(meta, torch.tensor(SUN))
    with pytest.raises(ValueError, match="no path"):
        clouds.cloud_shadow(meta, torch.tensor(SUN))


def test_cpu_calls_are_charged_as_plain_calls():
    rays, ground = _rays((4, 9), 3), _ground((3, 5), 4)
    sun = torch.tensor(SUN)

    def run():
        with profiler.span("clouds"):
            clouds.render_clouds(rays, sun, steps=2)
        with profiler.span("cloud_shadow"):
            clouds.cloud_shadow(ground, sun)

    by, _ = _spans(run)
    for name in ("clouds", "cloud_shadow"):
        assert by[name]["cloud_calls"] == 1
        assert by[name]["cloud_kernel_calls"] == 0
    mu = m3.normalize(rays)[..., 1]
    assert by["clouds"]["cloud_rays"] == mu.numel()
    assert by["clouds"]["cloud_rays_up"] == int((mu > 0.02).sum())
    assert "cloud_rays" not in by["cloud_shadow"]


def test_reciprocals_round_as_pytorch_divides():
    # the kernels take a division by a Python number as PyTorch's CUDA
    # kernel does it: a multiply by float32(1) / float32(x)
    for x in (1023.0, 0.4, 0.08, 1.2, 10):
        want = (torch.tensor(1.0) / torch.tensor(float(x))).item()
        assert cuda_build.recip(x) == want
    assert cuda_build.f32(1.0 - 0.45 * 1.6) == torch.tensor(1.0 - 0.45 * 1.6).item()


# -- the card: the kernels against the plain versions --------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    bad = ~((a == b) | (torch.isnan(a) & torch.isnan(b)))
    assert not bool(bad.any()), (f"{int(bad.sum())} of {a.numel()} differ, max "
                                 f"{float((a - b).abs()[bad].max())}")


@pytest.mark.gpu
@pytest.mark.parametrize("time", [None, 37.25])
def test_march_and_shadow_equal_the_plain_versions_at_the_sim_shapes(cuda, time):
    rays_h, sun, t0, ground = entry.world_sim_cloud_inputs(cuda)
    t = t0 if time is None else torch.tensor(time, device=cuda)
    rgb, alpha = clouds.render_clouds(rays_h, sun, time=t)
    p_rgb, p_alpha = clouds.render_clouds_plain(rays_h, sun, time=t)
    _same(rgb, p_rgb)
    _same(alpha, p_alpha)
    up = m3.normalize(rays_h)[..., 1] > 0.02
    assert 0.25 < float(up.float().mean()) < 0.75
    assert bool((rgb[~up] == 0).all()) and bool((alpha[~up] == 0).all())
    assert float(alpha[up].max()) > 0.05
    shadow = clouds.cloud_shadow(ground, sun, time=t)
    _same(shadow, clouds.cloud_shadow_plain(ground, sun, time=t))
    assert float(shadow.min()) < 1.0


@pytest.mark.gpu
def test_ragged_inputs_equal_the_plain_versions(cuda):
    rays, ground = _rays((37, 11), 7).to(cuda), _ground((13, 29), 8).to(cuda)
    sun, t = torch.tensor((-0.3, 0.5, 0.8), device=cuda), torch.tensor(-12.5, device=cuda)
    for kw in ({}, {"camera_height": 0.5, "coverage": 0.6, "steps": 7, "seed": 3}):
        got = clouds.render_clouds(rays, sun, time=t, **kw)
        for a, b in zip(got, clouds.render_clouds_plain(rays, sun, time=t, **kw)):
            _same(a, b)
    for kw in ({}, {"base_km": 1.5, "coverage": 0.3, "seed": 2}):
        _same(clouds.cloud_shadow(ground, sun, time=t, **kw),
              clouds.cloud_shadow_plain(ground, sun, time=t, **kw))


@pytest.mark.gpu
def test_one_call_is_one_launch_and_no_sync(cuda):
    rays_h, sun, t, ground = entry.world_sim_cloud_inputs(cuda)
    clouds.render_clouds(rays_h, sun, time=t)        # loads the library
    torch.cuda.synchronize()
    march, shadow = cuda_build.launches["cloud_march"], cuda_build.launches["cloud_shadow"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        clouds.render_clouds(rays_h, sun, time=t)
        clouds.cloud_shadow(ground, sun, time=t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_build.launches["cloud_march"] == march + 1
    assert cuda_build.launches["cloud_shadow"] == shadow + 1


@pytest.mark.gpu
def test_kernel_calls_are_charged_and_count_the_up_rays(cuda):
    rays_h, sun, t, ground = entry.world_sim_cloud_inputs(cuda)
    clouds.render_clouds(rays_h, sun, time=t)
    torch.cuda.synchronize()

    def run():
        with profiler.span("clouds"):
            clouds.render_clouds(rays_h, sun, time=t)
        with profiler.span("cloud_shadow"):
            clouds.cloud_shadow(ground, sun, time=t)

    by, _ = _spans(run)
    for name in ("clouds", "cloud_shadow"):
        assert (by[name]["cloud_calls"], by[name]["cloud_kernel_calls"]) == (1, 1)
        assert by[name]["syncs"] == 0
    mu = m3.normalize(rays_h)[..., 1]
    assert by["clouds"]["cloud_rays"] == mu.numel()
    assert by["clouds"]["cloud_rays_up"] == int((mu > 0.02).sum())
