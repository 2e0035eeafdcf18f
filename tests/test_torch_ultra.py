"""The ultra and temporal pass sets and the render_scale presets: the
combined step of `entry.build` against `__graft_entry__._build` under the
same config, two steps from the initial state (so that SSR, SSGI, Hi-Z,
velocity and disocclusion read a real previous frame), 32 bodies. The JAX
step runs jitted (one compile, called twice), its Pallas kernels in
interpret mode. Cases:

- `ultra_temporal`: the ultra preset without clouds (SSR, SSGI, the dense
  atlas with a 5x5 PCF, cascades cut to 256/128/128) plus
  TEMPORAL_OVERRIDES (velocity, Hi-Z, SMAA), 256x128;
- `potato`: render_scale 0.5, every effect off, 384x128 (renders 128x128,
  upscaled by 3 in x);
- `low`: render_scale 0.75, two 512 cascades, no HBAO or bloom, 384x128
  (renders 256x128, upscaled by 1.5 in x).

Bars (the flagship's): tri_id on >= 99.9% of pixels, the uint8 image
within 2 levels on >= 99.5%, bodies within 1e-5, the frame state's keys
equal. Measured: tri_id 100% in all three cases; image 99.98% / 100% /
99.99%; bodies max |d| 0. The slow test runs the ultra preset exactly as
defined (clouds on) at 128x64; its JAX step takes minutes to compile.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import inspect

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from garden_tpu.core.config import QUALITY_PRESETS as J_PRESETS
from garden_tpu.core.config import ShadowConfig as JShadowConfig
from garden_tpu_torch import entry
from garden_tpu_torch.convert import from_jax
from garden_tpu_torch.core.config import QUALITY_PRESETS, ShadowConfig

CUT = dict(cascade_sizes=(256, 128, 128))
CASES = {
    "ultra_temporal": (dict(n_bodies=32, width=256, height=128, grid_dim=8),
                       dict(QUALITY_PRESETS["ultra"], use_clouds=False,
                            **entry.TEMPORAL_OVERRIDES),
                       dict(map_size=2048, pcf_radius=2, **CUT)),
    "potato": (dict(n_bodies=32, width=384, height=128, grid_dim=8),
               dict(QUALITY_PRESETS["potato"]), None),
    "low": (dict(n_bodies=32, width=384, height=128, grid_dim=8),
            dict(QUALITY_PRESETS["low"]), dict(map_size=512, cascade_count=2,
                                               resolve_step=2)),
}
KEYS = ("tri_id", "velocity", "disocclusion")


def _overrides(over, shadow_kw, shadow_cls):
    out = {k: v for k, v in over.items() if k != "shadow"}
    if shadow_kw is not None:
        out["shadow"] = shadow_cls(**shadow_kw)
    return out


def _reference(size, over, shadow_kw, steps=2):
    """`steps` calls of one jitted reference step; each also returns the
    frame's tri_id, velocity and disocclusion (captured while tracing)."""
    jstep, jstate = graft._build(**size, cfg_overrides=_overrides(over, shadow_kw,
                                                                  JShadowConfig))
    renderer = inspect.getclosurevars(jstep).nonlocals["renderer"]
    seen = {}
    render = renderer.render

    def spy(*args, **kw):
        out = render(*args, **kw)
        seen.update(out)
        return out
    renderer.render = spy

    def step(state):
        nxt, img = jstep(state)
        return nxt, img, {k: seen[k] for k in KEYS if seen.get(k) is not None}
    fn = jax.jit(step)
    state = jstate
    for _ in range(steps):
        state, img, out = fn(state)
    return jax.device_get((state, img, out))


def _port(size, over, shadow_kw, steps=2):
    tstep, tstate = entry.build(**size, cfg_overrides=_overrides(over, shadow_kw,
                                                                 ShadowConfig),
                                device="cpu")
    seen = {}
    render = tstep.renderer.render

    def spy(*args, **k):
        out = render(*args, **k)
        seen.update(out)
        return out
    tstep.renderer.render = spy
    state = tstate
    for _ in range(steps):
        state, img = tstep(state)
    return state, img, seen


def _check(size, jres, tres):
    (jnext, jimg, jout), (tnext, timg, tout) = jres, tres
    assert timg.shape == (size["height"], size["width"], 3) and timg.dtype == torch.uint8
    for k in ("pos", "quat"):
        np.testing.assert_allclose(jnext["physics"]["bodies"][k],
                                   tnext["physics"]["bodies"][k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    tri = (jout["tri_id"] == tout["tri_id"].numpy()).mean()
    d = np.abs(jimg.astype(int) - timg.numpy().astype(int)).max(-1)
    assert tri >= 0.999, tri
    assert (d <= 2).mean() >= 0.995, (d <= 2).mean()
    # the frame state carries the same keys, and from_jax carries them in
    assert set(jnext["frame"]) == set(tnext["frame"])
    conv = from_jax(jnext["frame"], "cpu")
    for k, v in tnext["frame"].items():
        assert conv[k].shape == v.shape and conv[k].dtype == v.dtype, k
    return jout, tout


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_steps_match_reference(case):
    size, over, shadow_kw = CASES[case]
    jout, tout = _check(size, _reference(size, over, shadow_kw),
                        _port(size, over, shadow_kw))
    if case == "ultra_temporal":
        vis = tout["gbuffer"]["visible"].numpy()
        vel_j, vel_t = jout["velocity"], tout["velocity"].numpy()
        same = (jout["tri_id"] == tout["tri_id"].numpy())
        np.testing.assert_allclose(vel_j[same], vel_t[same], rtol=0, atol=1e-3)
        # the second frame's previous depth is real: little is disoccluded
        dis_j, dis_t = jout["disocclusion"], tout["disocclusion"].numpy()
        assert (dis_j == dis_t).mean() >= 0.995
        assert dis_t[vis].mean() < 0.5


@pytest.mark.slow
def test_ultra_preset_with_clouds_matches_reference():
    """The ultra preset as defined, clouds on, two steps against the
    jitted reference at 128x64 (the same bars)."""
    size = dict(n_bodies=32, width=128, height=64, grid_dim=8)
    over = dict(QUALITY_PRESETS["ultra"])
    shadow_kw = dict(map_size=2048, pcf_radius=2, **CUT)
    _check(size, _reference(size, over, shadow_kw), _port(size, over, shadow_kw))
