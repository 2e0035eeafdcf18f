"""The atmosphere kernels (`csrc/atmosphere.cu`: the sky and the aerial
perspective) and the dispatch in `render/atmosphere.py` that chooses them.

On the CPU: `sky_radiance`, `aerial_perspective` and `sky_sh` take the
plain versions and give the values of the benchmark's frozen plain
reference (`benchmark/reference/render/atmosphere.py`, the module as it
was before the kernels) in every bit; the plain versions keep the public
functions' signatures; each call charges `atmosphere_calls` 1 and
`atmosphere_kernel_calls` 0 to its span; the CUDA wrappers refuse a wrong
dtype, a wrong shape, a non-contiguous input and CPU tensors (no
fallback).

On a card (`gpu`; this file imports no JAX, so run it with
`python -m pytest --noconftest -m gpu tests/test_torch_atmosphere_kernel.py -q`):
the kernels against the plain versions run on the same card, at play's
shapes (518,400 half-res rays at 12 and 4 steps, the 128 SH directions at
8, 2,073,600 aerial pixels) and at a ragged size with another camera
height and step count, under a high, a low and a set sun: every value in
every bit (the kernels run the plain versions' float32 operations in the
same order, built with -fmad=false). The rays cover the ground, grazing
rays on both sides of the horizon, the sun disk and zero vectors, the
depths 0 and far. One call is one launch, with no host synchronization,
and a recorded call is charged as a kernel call.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import inspect

import numpy as np
import pytest
import torch

from benchmark.reference.render import atmosphere as ref_atm
from garden_tpu_torch import cuda_build, entry
from garden_tpu_torch.render import atmosphere
from garden_tpu_torch.utils import profiler

SUNS = {"high": (-0.4, 0.7, 0.5),      # the flagship's sun, toward the light
        "low": (0.9, 0.03, 0.2),       # just above the horizon: long grazing paths
        "set": (0.3, -0.25, 0.6)}      # below it: the Chapman lower branch, blocked rays


def _rays(shape, seed, sun):
    """View directions (shape..., 3) of random lengths: most uniform on the
    sphere, a tenth grazing the horizon (|mu| < 0.02, on both sides of
    where the ground starts), a tenth within a degree of the sun (the sun
    disk), and a few zero vectors."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(*shape, 3))
    flat = d.reshape(-1, 3)
    n = flat.shape[0]
    graze = rng.uniform(size=n) < 0.1
    flat[graze, 1] = rng.uniform(-0.02, 0.02, int(graze.sum())) * np.hypot(
        flat[graze, 0], flat[graze, 2])
    disk = ~graze & (rng.uniform(size=n) < 0.11)
    s = np.asarray(sun) / np.linalg.norm(sun)
    flat[disk] = s + rng.normal(scale=0.01, size=(int(disk.sum()), 3))
    flat[rng.choice(n, size=min(n, 3), replace=False)] = 0.0
    flat *= rng.uniform(0.5, 2.0, (n, 1))
    return torch.from_numpy(d.astype(np.float32))


def _depths(shape, seed):
    """Depths in km: mostly 0-40, a tenth exactly 0, a few far."""
    rng = np.random.default_rng(seed)
    km = rng.uniform(0.0, 40.0, shape)
    km[rng.uniform(size=shape) < 0.1] = 0.0
    km[rng.uniform(size=shape) < 0.01] = 1e3
    return torch.from_numpy(km.astype(np.float32))


def _spans(fn):
    """fn() inside a recorded root step -> {span name: counters}."""
    first = profiler.RECORDER.next_step
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.span("step"):
            fn()
    return {s["name"]: s["counters"] for s in profiler.recorded() if s["step"] >= first}


def _lighting_calls(rays_h, rays, depth, sun):
    """The four calls of `DeferredRenderer._atmosphere_lighting`, each in a
    span of its own."""
    with profiler.span("sky"):
        atmosphere.sky_radiance(rays_h, sun)
    with profiler.span("spec"):
        atmosphere.sky_radiance(rays_h, sun, steps=4)
    with profiler.span("sh"):
        atmosphere.sky_sh(sun)
    with profiler.span("aerial"):
        atmosphere.aerial_perspective(depth, rays, sun)


# -- the CPU: the plain path ---------------------------------------------------

@pytest.mark.parametrize("sun", list(SUNS))
def test_cpu_tensors_give_the_plain_reference_bits(sun):
    rays, depth, s = _rays((9, 14), 1, SUNS[sun]), _depths((9, 14), 2), torch.tensor(SUNS[sun])
    launches = dict(cuda_build.launches)
    for steps in (12, 4):
        got = atmosphere.sky_radiance(rays, s, steps=steps)
        assert torch.equal(got, ref_atm.sky_radiance(rays, s, steps=steps))
        assert torch.equal(got, atmosphere.sky_radiance_plain(rays, s, steps=steps))
    assert torch.equal(atmosphere.sky_radiance(rays, s, 1.5, 7),
                       ref_atm.sky_radiance(rays, s, 1.5, 7))
    for h0 in (0.2, 0.9):
        got = atmosphere.aerial_perspective(depth, rays, s, h0)
        for a, b in zip(got, ref_atm.aerial_perspective(depth, rays, s, h0)):
            assert torch.equal(a, b)
    assert torch.equal(atmosphere.sky_sh(s), ref_atm.sky_sh(s))
    assert cuda_build.launches == launches


def test_plain_versions_keep_the_signatures():
    for name in ("sky_radiance", "aerial_perspective"):
        fn, plain = getattr(atmosphere, name), getattr(atmosphere, f"{name}_plain")
        assert inspect.signature(plain) == inspect.signature(fn)
        assert inspect.signature(getattr(atmosphere, f"{name}_cuda")) == inspect.signature(fn)
        assert inspect.signature(fn) == inspect.signature(getattr(ref_atm, name))


def test_sh_directions_are_the_fibonacci_sphere_bits():
    # sky_sh reads its 128 directions from a constant built once a device,
    # not from a host copy every call
    dirs = torch.tensor(atmosphere._SH_DIRS)
    assert torch.equal(dirs, torch.from_numpy(atmosphere._fibonacci_sphere(128)))


def test_cpu_calls_are_charged_as_plain_calls():
    rays, depth = _rays((6, 8), 3, SUNS["high"]), _depths((6, 8), 4)
    by = _spans(lambda: _lighting_calls(rays, rays, depth, torch.tensor(SUNS["high"])))
    for name in ("sky", "spec", "sh", "aerial"):
        assert (by[name]["atmosphere_calls"], by[name]["atmosphere_kernel_calls"]) == (1, 0)
    assert "atmosphere_calls" not in by["step"]


BAD_INPUTS = {
    "float64 rays": (dict(view=torch.zeros(4, 3, dtype=torch.float64)), "dtype"),
    "rays of 4": (dict(view=torch.zeros(4, 4)), "shape"),
    "strided rays": (dict(view=torch.zeros(3, 4)[:, :3]), "contiguous"),
    "transposed rays": (dict(view=torch.zeros(3, 5).t()), "contiguous"),
    "cpu rays": (dict(), "CUDA"),
}


@pytest.mark.parametrize("kernel", ["sky_radiance_cuda", "aerial_perspective_cuda"])
@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_cuda_wrappers_refuse_bad_inputs(kernel, case):
    kw, match = BAD_INPUTS[case]
    view = kw.get("view", torch.zeros(5, 3))
    args = (view, torch.tensor(SUNS["high"]))
    if kernel == "aerial_perspective_cuda":
        args = (torch.zeros(view.shape[:-1]),) + args
    with pytest.raises(ValueError, match=match):
        getattr(atmosphere, kernel)(*args)


def test_other_devices_have_no_path():
    meta = torch.empty(4, 3, device="meta")
    sun = torch.tensor(SUNS["high"])
    with pytest.raises(ValueError, match="no path"):
        atmosphere.sky_radiance(meta, sun)
    with pytest.raises(ValueError, match="no path"):
        atmosphere.aerial_perspective(torch.empty(4, device="meta"), meta, sun)


# -- the card: the kernels against the plain versions --------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    bad = a.view(torch.int32) != b.view(torch.int32)
    assert not bool(bad.any()), (f"{int(bad.sum())} of {a.numel()} differ, max "
                                 f"{float((a - b).abs()[bad].max())}")


def _wrong_way_sky(rays, sun):
    """The rays' shares into the ground and on the sun disk, by the plain
    version's tests."""
    v = rays / rays.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    s = sun / sun.norm()
    return float((v[..., 1] < -0.01).float().mean()), float(((v @ s) > 0.99955).float().mean())


@pytest.mark.gpu
@pytest.mark.parametrize("sun", list(SUNS))
def test_sky_equals_the_plain_version_at_plays_shapes(cuda, sun):
    rays, s = _rays((540, 960), 5, SUNS[sun]).to(cuda), torch.tensor(SUNS[sun], device=cuda)
    ground, disk = _wrong_way_sky(rays, s)
    assert ground > 0.2 and disk > 0.05
    for steps in (12, 4):
        _same(atmosphere.sky_radiance(rays, s, steps=steps),
              atmosphere.sky_radiance_plain(rays, s, steps=steps))
    dirs = torch.tensor(atmosphere._SH_DIRS, device=cuda)
    _same(atmosphere.sky_radiance(dirs, s, steps=8),
          atmosphere.sky_radiance_plain(dirs, s, steps=8))


@pytest.mark.gpu
def test_kernels_equal_the_plain_versions_on_the_flagship_frames_rays(cuda):
    # play's own inputs: its half-res view rays (nearly all into the
    # ground), their mirror images off the floor (all sky) and the full-res
    # rays with their distance to the ground
    rays, rays_h, refl_h, depth, sun = entry.flagship_atmosphere_inputs(cuda)
    assert rays_h.shape == refl_h.shape == (540, 960, 3) and depth.shape == (1080, 1920)
    _same(atmosphere.sky_radiance(rays_h, sun), atmosphere.sky_radiance_plain(rays_h, sun))
    _same(atmosphere.sky_radiance(refl_h, sun, steps=4),
          atmosphere.sky_radiance_plain(refl_h, sun, steps=4))
    for a, b in zip(atmosphere.aerial_perspective(depth, rays, sun),
                    atmosphere.aerial_perspective_plain(depth, rays, sun)):
        _same(a, b)


@pytest.mark.gpu
def test_sky_equals_the_plain_version_on_the_world_sims_rays(cuda):
    rays_h, sun, _, _ = entry.world_sim_cloud_inputs(cuda)
    for steps in (12, 4):
        _same(atmosphere.sky_radiance(rays_h, sun, steps=steps),
              atmosphere.sky_radiance_plain(rays_h, sun, steps=steps))


@pytest.mark.gpu
@pytest.mark.parametrize("sun", list(SUNS))
def test_aerial_perspective_equals_the_plain_version_at_plays_shapes(cuda, sun):
    rays = _rays((1080, 1920), 6, SUNS[sun]).to(cuda)
    depth, s = _depths((1080, 1920), 7).to(cuda), torch.tensor(SUNS[sun], device=cuda)
    assert float((depth == 0).float().mean()) > 0.05
    for a, b in zip(atmosphere.aerial_perspective(depth, rays, s),
                    atmosphere.aerial_perspective_plain(depth, rays, s)):
        _same(a, b)


@pytest.mark.gpu
def test_ragged_inputs_and_other_heights_equal_the_plain_versions(cuda):
    rays, depth = _rays((37, 11), 8, SUNS["low"]).to(cuda), _depths((37, 11), 9).to(cuda)
    for name, sun in SUNS.items():
        s = torch.tensor(sun, device=cuda)
        for h0, steps in ((0.2, 1), (1.5, 7), (12.0, 16)):
            _same(atmosphere.sky_radiance(rays, s, h0, steps),
                  atmosphere.sky_radiance_plain(rays, s, h0, steps))
            for a, b in zip(atmosphere.aerial_perspective(depth, rays, s, h0),
                            atmosphere.aerial_perspective_plain(depth, rays, s, h0)):
                _same(a, b)


@pytest.mark.gpu
def test_one_call_is_one_launch_and_no_sync(cuda):
    rays = _rays((1080, 1920), 10, SUNS["high"]).to(cuda)
    rays_h, depth = rays[::2, ::2].contiguous(), _depths((1080, 1920), 11).to(cuda)
    sun = torch.tensor(SUNS["high"], device=cuda)
    atmosphere.sky_sh(sun)              # builds the library and the SH constant
    atmosphere.aerial_perspective(depth, rays, sun)
    torch.cuda.synchronize()
    before = dict(cuda_build.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _lighting_calls(rays_h, rays, depth, sun)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_build.launches["sky_radiance"] == before["sky_radiance"] + 3
    assert cuda_build.launches["aerial_perspective"] == before["aerial_perspective"] + 1


@pytest.mark.gpu
def test_kernel_calls_are_charged(cuda):
    rays, depth = _rays((64, 96), 12, SUNS["high"]).to(cuda), _depths((64, 96), 13).to(cuda)
    sun = torch.tensor(SUNS["high"], device=cuda)
    _lighting_calls(rays, rays, depth, sun)
    torch.cuda.synchronize()
    by = _spans(lambda: _lighting_calls(rays, rays, depth, sun))
    for name in ("sky", "spec", "sh", "aerial"):
        assert (by[name]["atmosphere_calls"], by[name]["atmosphere_kernel_calls"]) == (1, 1)
        assert by[name]["syncs"] == 0
