"""Whole deferred frames of the port against `garden_tpu.render.deferred`
on the same scene: the feature frame (`entry.build_feature_frame`:
slot-binned cascades, textures on every other box, the environment map in
place of the atmosphere, the HUD after AA) and the bench frame
(`entry.build_bench_frame`: bench.py's boxes and spheres, each sphere a
two-level LOD chain), each at a few bodies and 256x128, rendered from the
initial poses. The JAX renderer gets a copy of the port's host scene and
runs jitted, its Pallas kernels in interpret mode.

Tolerances: tri_id on >= 99.9% of pixels; the uint8 image within 2
levels on >= 99.5% (the bf16 post chain and FXAA's edge decisions, as the
flagship's parity test).
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import config as jconfig
from garden_tpu.render import deferred as jdef
from garden_tpu.render import mesh as jmesh
from garden_tpu_torch import entry
from garden_tpu_torch.core.config import ShadowConfig

SIZE = dict(width=256, height=128)
CUT = dict(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
           atlas_foot_y=None, max_active_tiles=24)


def _jax_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["shadow"] = jconfig.ShadowConfig(**dataclasses.asdict(cfg.shadow))
    kw["ssr"] = jconfig.SSRConfig(**dataclasses.asdict(cfg.ssr))
    return jconfig.RenderConfig(**kw)


def _jax_scene(host):
    """The JAX package's SceneBuffers holding a copy of the port's host
    arrays."""
    s = jmesh.SceneBuffers(host.max_vertices, host.max_triangles, host.max_instances)
    for k, v in vars(host).items():
        setattr(s, k, v.copy() if isinstance(v, np.ndarray) else v)
    return s


def _frames(step, state):
    mats = step.instance_matrices(state["physics"])
    tout = step.render(mats, state["frame"])
    ren = step.renderer
    jren = jdef.DeferredRenderer(_jax_config(ren.config), _jax_scene(ren.scene_host))
    np_ = lambda d: {k: jnp.asarray(v.numpy() if torch.is_tensor(v) else v)
                     for k, v in d.items()}
    opt = lambda x: None if x is None else jnp.asarray(x.numpy())
    ui = None if step.ui_sprites is None else np_(step.ui_sprites)

    def render(m, fs, env, atlas, sprites):
        out = jren.render(jren.device_scene(), m, np_(step.constants), fs, atlas, sprites,
                          environment=env)
        return out["image"], out["tri_id"]
    jimg, jtri = jax.device_get(jax.jit(render)(
        jnp.asarray(mats.numpy()), np_(state["frame"]), opt(step.environment),
        opt(step.ui_atlas), ui))
    return (jimg, jtri), (tout["image"].numpy(), tout["tri_id"].numpy()), tout


def _check(j, t):
    assert t[0].shape == (128, 256, 3)
    assert (j[1] == t[1]).mean() >= 0.999
    d = np.abs(j[0].astype(int) - t[0].astype(int)).max(-1)
    assert (d <= 2).mean() >= 0.995


def test_feature_frame_matches_reference():
    step, state = entry.build_feature_frame(
        32, **SIZE, grid_dim=8, cfg_overrides=dict(shadow=ShadowConfig(**CUT)),
        device="cpu", env_height=16)
    assert step.renderer.any_textured and step.environment.shape == (16, 32, 3)
    j, t, tout = _frames(step, state)
    _check(j, t)
    g = tout["gbuffer"]
    boxes = g["visible"] & (g["instance"] >= 1)
    textured = boxes & (g["instance"] % 2 == 0)          # box 2j + 1 is instance 2j + 2
    assert textured.any() and (~g["visible"]).any()       # textured boxes and sky


def test_bench_frame_matches_reference():
    step, state = entry.build_bench_frame(64, **SIZE, cfg_overrides=dict(
        shadow=ShadowConfig(**dict(CUT, atlas_foot_y=2))), device="cpu")
    assert step.renderer.any_lods
    j, t, tout = _frames(step, state)
    _check(j, t)
    tri = torch.from_numpy(t[1])
    lod = step.scene["tri_lod"][tri.clamp(min=0).long()][tri >= 0]
    assert set(torch.unique(lod).tolist()) == {0, 1}      # both levels drawn
