"""Parity of the port's slot-binned cascade atlas with `garden_tpu`: a
y-footprint other than 2 atlas tiles (the default for 16-row tiles is 8)
bins each caster into every tile of its footprint
(`raster.bin_triangles(max_active=)` on the split path) before the split
depth raster (K2, then K3 on the active tiles) or the dense one (K4); the
translucent map bins at the same footprint. JAX's depth raster runs its
Pallas kernels in interpret mode.

Tolerances: lists, counts, the big list and act_ids are equal (the tie
order among equal counts included); from the same setup, the atlases
agree on coverage on >= 99.9% of pixels and within 1e-6 where both cover;
through csm.render_cascades, whose light-space setup differs by XLA's
fused multiply-adds, within 1e-5 (test_torch_csm's bar). The casters are
wound front-facing in the atlas and the tests assert that something is
drawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import math3d as jm3
from garden_tpu.core.config import RenderConfig as JRenderConfig
from garden_tpu.core.config import ShadowConfig as JShadowConfig
from garden_tpu.render import csm as jcsm
from garden_tpu.render import raster as jr
from garden_tpu.systems import camera as jcam
from garden_tpu_torch.core.config import RenderConfig, ShadowConfig
from garden_tpu_torch.render import csm as tcsm
from garden_tpu_torch.render import deferred as tdef
from garden_tpu_torch.render import mesh as tmesh
from garden_tpu_torch.render import raster as tr

_j_bin = jax.jit(jr.bin_triangles, static_argnums=(1, 2, 3, 4),
                 static_argnames=("max_big", "foot", "tile_h", "foot_y", "max_active"))
_j_super = jax.jit(jr.bin_big_supertiles, static_argnums=(2, 3, 4, 5, 6, 7, 8))


def _atlas_scene(seed, w=512, h=256, n_small=160, n_big=6):
    """Host setup of right triangles in atlas pixels, front-facing: small
    casters spanning 1-4 rows of 16-row tiles, a few big ones."""
    rng = np.random.default_rng(seed)
    px = np.concatenate([rng.uniform(0, w - 12, n_small), rng.uniform(0, w * 0.6, n_big)])
    py = np.concatenate([rng.uniform(0, h - 6, n_small), rng.uniform(0, h * 0.6, n_big)])
    ps = np.concatenate([rng.uniform(3, 60.0, n_small),
                         rng.uniform(150, 400.0, n_big)]).astype(np.float32)
    t = n_small + n_big
    z = rng.uniform(0.1, 0.9, t).astype(np.float32)
    sx = np.stack([px, px, px + ps], 0).astype(np.float32)
    sy = np.stack([py, py + ps, py], 0).astype(np.float32)
    valid = np.ones((t,), bool)
    valid[::17] = False
    return {"sx": sx, "sy": sy, "z": np.stack([z, z * 0.9, z * 1.05], 0),
            "inv_area": (1.0 / (ps * ps)).astype(np.float32),
            "xmin": sx.min(0), "xmax": sx.max(0), "ymin": sy.min(0),
            "ymax": sy.max(0), "valid": valid}


def _both(host):
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.as_tensor(v) for k, v in host.items()})


def _eq(j, t, name=""):
    np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


def _atlas_close(j, t, tol=1e-6, covered=0.05):
    cov_j, cov_t = j > 0, t > 0
    assert (cov_j == cov_t).mean() >= 0.999
    both = cov_j & cov_t
    assert np.abs(j[both] - t[both]).max(initial=0.0) <= tol
    assert cov_t.mean() > covered


@pytest.mark.parametrize("max_active", [None, 12, 40])
@pytest.mark.parametrize("foot_y", [8, 4])
def test_slot_binning_matches(max_active, foot_y):
    jset, tset = _both(_atlas_scene(3))
    kw = dict(foot=2, tile_h=16, foot_y=foot_y, max_big=32, max_active=max_active)
    jb = _j_bin(jset, 512, 256, 128, 64, **kw)
    tb = tr.bin_triangles(tset, 512, 256, 128, 64, **kw)
    assert len(jb) == len(tb) == (3 if max_active is None else 4)
    for j, t, name in zip(jb, tb, ("tile_tris", "counts", "big_list", "act_ids")):
        _eq(j, t, name)
    if max_active is None:        # a caster goes into every tile of its footprint
        assert int((tb[0] >= 0).sum()) > int(tset["valid"].sum())


@pytest.fixture(scope="module")
def slot_atlases():
    """Both packages' atlases of one scene, slot-binned at foot 2 x 8 on
    16-row tiles: the dense raster, and the split one over the 24 most
    populated tiles (fewer than are occupied)."""
    host = _atlas_scene(11)
    t = host["valid"].shape[0]
    bounds = ((0, 256, 0, 256), (256, 512, 0, 256))
    tri_atlas = (np.arange(t) % 2).astype(np.int32)
    w, h, th = 512, 256, 16
    out = {}
    for name, s in zip("jt", _both(host)):
        atl = jnp.asarray(tri_atlas) if name == "j" else torch.as_tensor(tri_atlas)
        mod, binner, sup_bin = ((jr, _j_bin, _j_super) if name == "j"
                                else (tr, tr.bin_triangles, tr.bin_big_supertiles))
        dense_b = binner(s, w, h, 128, 64, foot=2, tile_h=th, foot_y=8)
        tiles, counts, big, act = binner(s, w, h, 128, 64, foot=2, tile_h=th, foot_y=8,
                                         max_big=256, max_active=24)
        sup = sup_bin(s, big, w, h, 128, th, 4, 8, 64)
        sup = (sup[0], sup[1], tuple(int(x) for x in sup[2]))
        kw = dict(atlas_bounds=bounds, tri_atlas=atl, tile_h=th)
        dense = mod.rasterize_depth(s, *dense_b, w, h, 128, **kw)
        split = mod.rasterize_depth(s, tiles, counts, big, w, h, 128, sup_bins=sup,
                                    max_active=24, act_ids=act, **kw)
        out[name] = (np.asarray(dense), np.asarray(split), np.asarray(counts))
    return out


def test_slot_atlas_dense_matches(slot_atlases):
    _atlas_close(slot_atlases["j"][0], slot_atlases["t"][0])


def test_slot_atlas_split_matches(slot_atlases):
    _atlas_close(slot_atlases["j"][1], slot_atlases["t"][1])
    # 24 active tiles of more occupied ones: some tiles lose their list
    assert (slot_atlases["t"][1] != slot_atlases["t"][0]).any()


def _camera(w, h):
    eye = jnp.array([0.0, 9.0, 14.0])
    view = jm3.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    proj = jm3.perspective_reverse_z(1.0, w / h, 0.1)
    return jcam.common_constants(eye, view, proj, jnp.array([0.4, -0.7, -0.5]),
                                 (w, h), 0.0, 1.0 / 60.0)


def test_render_cascades_slot_binned_matches():
    """csm.render_cascades with atlas_foot_y=None on 16-row tiles (foot_y
    8), the dense raster: the opaque atlas and the translucent map (its
    binning at the same footprint), from world triangles of both
    windings. The light-space setup sums in another order than XLA's fused
    multiply-adds, so depths agree within 1e-5 here (test_torch_csm's
    bar; measured 1.8e-6); the split raster's parity is the fixture's."""
    c = _camera(256, 128)
    cfg = dict(cascade_sizes=(256, 128, 128), atlas_tile_h=16, atlas_foot_y=None,
               distance=40.0)
    jcfg, tcfg = JShadowConfig(**cfg), ShadowConfig(**cfg)
    assert tcsm.atlas_tiling(tcfg)[2] == 8
    splits = jcsm.cascade_splits(jcfg, 0.1)
    ivp, ld = np.asarray(c["inv_view_proj"]), np.asarray(c["light_dir"])
    jl = jcsm.fit_cascades(jnp.asarray(ivp), jnp.asarray(ld), 0.1, splits, 0.1)
    tl = tcsm.fit_cascades(torch.from_numpy(ivp), torch.from_numpy(ld), 0.1, splits, 0.1)
    rng = np.random.default_rng(37)
    t = 240
    base = rng.uniform(-12, 12, (1, t, 3)) * [1, 0.3, 1]
    corners = (base + rng.normal(0, 0.8, (3, t, 3))).astype(np.float32)
    planes = [np.ascontiguousarray(corners[..., k]) for k in range(3)]
    valid = np.ones(t, bool)
    trans = np.arange(t) % 5 == 0
    tint = rng.uniform(0.2, 1.0, (t, 4)).astype(np.float32)
    jatlas, jtrans = jax.jit(lambda v, l, pl, tr_, ti: jcsm.render_cascades(
        None, None, v, l, jcfg, pos_planes=pl, tri_translucent=tr_, tri_tint=ti))(
        jnp.asarray(valid), jl, tuple(jnp.asarray(p) for p in planes),
        jnp.asarray(trans), jnp.asarray(tint))
    tatlas, ttrans = tcsm.render_cascades(
        tuple(torch.from_numpy(p) for p in planes), torch.from_numpy(valid), tl, tcfg,
        tri_translucent=torch.from_numpy(trans), tri_tint=torch.from_numpy(tint))
    _atlas_close(np.asarray(jatlas), tatlas.numpy(), 1e-5, 0.005)
    jt, tt = np.asarray(jtrans), ttrans.numpy()
    _atlas_close(jt[..., 3], tt[..., 3], 1e-5, 0.001)
    np.testing.assert_allclose(jt[..., :3], tt[..., :3], rtol=0, atol=1e-5)
    assert (tt[..., :3] < 1).any()


def test_slot_binned_renderer_builds_and_renders():
    """A RenderConfig whose cascades are slot-binned renders on the port."""
    scene = tmesh.SceneBuffers(400, 400, 8)
    m = scene.add_material(tmesh.Material())
    scene.add_instance(tmesh.plane_grid(20.0, 4), material=m)
    for _ in range(3):
        scene.add_instance(tmesh.cube(0.8), material=m)
    cfg = RenderConfig(width=128, height=64, max_triangles=400, max_vertices=400,
                       max_instances=8, shadow=ShadowConfig(
                           cascade_sizes=(256, 128, 128), atlas_tile_h=16,
                           atlas_foot_y=None, max_active_tiles=24))
    ren = tdef.DeferredRenderer(cfg, scene, "cpu")
    mats = torch.eye(4).repeat(8, 1, 1)
    mats[1:4, 1, 3] = 0.8
    mats[1:4, 0, 3] = torch.tensor([-2.0, 0.0, 2.0])
    c = {k: torch.from_numpy(np.asarray(v)) for k, v in _camera(128, 64).items()}
    out = ren.render(ren.device_scene(), mats, c, ren.initial_frame_state())
    assert out["image"].shape == (64, 128, 3)
    vis = out["gbuffer"]["visible"]
    assert (out["shadow"][vis] < 1).any()
