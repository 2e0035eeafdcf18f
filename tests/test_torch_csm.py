"""Parity of the port's cascaded shadows with `garden_tpu.render.csm` and the
atlas parts of `garden_tpu.render.raster`: corner binning, super-tile
binning, the cascade fit and setup, the depth raster (dense and split) and
the shadow resolve. The JAX depth raster runs its Pallas kernels in
interpret mode.

Tolerances: binning (lists, counts, act_ids, super-tile lists) and the
atlas layout are exact. Matrices agree to rtol 1e-6 (the reference's
4x4 products may sum in another order; the translation column's floor is
explained at its assert) and atlas pixel coordinates to 1e-4 px; `valid`
is exact on these scenes. The depth atlas agrees to 1e-5 where both sides
cover a pixel, coverage on >= 99.9% of pixels: XLA's CPU backend
contracts the reference's a*px + b*py + c into fused multiply-adds, which
moves edge values by an ulp (measured: identical coverage, max |d| 5.4e-7
on the module scenes and 3.6e-6 on the cascade atlas). The port's split
path equals its dense path exactly, as the reference's do. The resolve
agrees to 1e-4 on >= 99.5% of pixels, since one atlas ulp can flip a
texel at a silhouette (measured: every pixel, max |d| 0).

The scenes wind their triangles front-facing (negative signed area in the
y-down atlas) and the tests assert that something is drawn: the
reference's own split/dense and corner/slot tests (tests/test_raster.py)
wind theirs the other way and compare empty atlases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core.config import ShadowConfig as JShadowConfig
from garden_tpu.render import csm as jcsm
from garden_tpu.render import raster as jr
from garden_tpu.core import math3d as jm3
from garden_tpu_torch.core.config import ShadowConfig
from garden_tpu_torch.render import csm as tcsm
from garden_tpu_torch.render import raster as tr


# binning is integer work after one division per bound, so jitting it (one
# compile instead of one per op) cannot change its result
_j_corner = jax.jit(jr.bin_triangles_corner, static_argnums=(1, 2, 3, 4),
                    static_argnames=("max_big", "tile_h", "max_active"))
_j_super = jax.jit(jr.bin_big_supertiles, static_argnums=(2, 3, 4, 5, 6, 7, 8))


def _both(host):
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.as_tensor(v) for k, v in host.items()})


def _atlas_scene(seed, w=512, h=256, n_small=160, n_big=6, small_max=30.0,
                 big_max=400.0, drop_every=17):
    """Host setup of right triangles in atlas pixels: many small casters
    and a few big ones spanning several super-tiles, with some invalid."""
    rng = np.random.default_rng(seed)
    px = np.concatenate([rng.uniform(0, w - 12, n_small), rng.uniform(0, w * 0.6, n_big)])
    py = np.concatenate([rng.uniform(0, h - 6, n_small), rng.uniform(0, h * 0.6, n_big)])
    ps = np.concatenate([rng.uniform(3, small_max, n_small),
                         rng.uniform(100, big_max, n_big)]).astype(np.float32)
    t = n_small + n_big
    z = rng.uniform(0.1, 0.9, t).astype(np.float32)
    # front-facing winding: negative signed area in the y-down atlas
    sx = np.stack([px, px, px + ps], 0).astype(np.float32)
    sy = np.stack([py, py + ps, py], 0).astype(np.float32)
    valid = np.ones((t,), bool)
    valid[::drop_every] = False
    return {"sx": sx, "sy": sy, "z": np.stack([z, z * 0.9, z * 1.05], 0),
            "inv_area": (1.0 / (ps * ps)).astype(np.float32),
            "xmin": sx.min(0), "xmax": sx.max(0), "ymin": sy.min(0),
            "ymax": sy.max(0), "valid": valid}


def _eq(j, t, name=""):
    np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


@pytest.mark.parametrize("max_active", [None, 40, 7], ids=["dense", "active", "tight"])
@pytest.mark.parametrize("tile_h", [16, 128])
def test_corner_binning_matches(max_active, tile_h):
    """Lists, counts, the big list and act_ids exactly, including the
    tie order of act_ids (equal counts: higher tile index first) and a
    saturated cap."""
    jset, tset = _both(_atlas_scene(3))
    kw = dict(tile_h=tile_h, max_big=16, max_active=max_active)
    jb = _j_corner(jset, 512, 256, 128, 8, **kw)
    tb = tr.bin_triangles_corner(tset, 512, 256, 128, 8, **kw)
    assert len(jb) == len(tb) == (3 if max_active is None else 4)
    for j, t, name in zip(jb, tb, ("tile_tris", "counts", "big_list", "act_ids")):
        _eq(j, t, name)
    full = tr.bin_triangles_corner(tset, 512, 256, 128, 64, tile_h=tile_h,
                                   max_big=16)[1]
    assert (full > 8).any()                  # some tile overflows the cap


def test_supertile_binning_matches():
    jset, tset = _both(_atlas_scene(5, n_big=12))
    jbig = _j_corner(jset, 512, 256, 128, 32, tile_h=16, max_big=32)[2]
    tbig = tr.bin_triangles_corner(tset, 512, 256, 128, 32, tile_h=16, max_big=32)[2]
    for cap in (16, 4):                      # 4 overflows some super-tiles
        j = _j_super(jset, jbig, 512, 256, 128, 16, 2, 4, cap)
        t = tr.bin_big_supertiles(tset, tbig, 512, 256, 128, 16, 2, 4, cap)
        _eq(j[0], t[0], "sup_tris")
        _eq(j[1], t[1], "sup_counts")
        assert j[2] == t[2]


def _depth_pair(host, w, h, bounds, tri_atlas, tile_h, max_active, max_big=16):
    """The JAX (interpret mode) and port depth atlases, split and dense,
    from the same corner binning."""
    jset, tset = _both(host)
    out = {}
    for name, (corner, sup_bin), s, atl in (
            ("j", (_j_corner, _j_super), jset, jnp.asarray(tri_atlas)),
            ("t", (tr.bin_triangles_corner, tr.bin_big_supertiles), tset,
             torch.as_tensor(tri_atlas))):
        dense_b = corner(s, w, h, 128, 64, max_big=max_big, tile_h=tile_h)
        tiles, counts, big, act = corner(s, w, h, 128, 64, max_big=max_big,
                                         tile_h=tile_h, max_active=max_active)
        sup = sup_bin(s, big, w, h, 128, tile_h, 2, 4, 16)
        sup = (sup[0], sup[1], tuple(int(x) for x in sup[2]))
        if name == "j":
            def depth(setup, tt, cnt, bg, sup_tc=None, act_ids=None):
                sb = None if sup_tc is None else (*sup_tc, sup[2])
                return jr.rasterize_depth(setup, tt, cnt, bg, w, h, 128,
                                          atlas_bounds=bounds, tri_atlas=atl,
                                          tile_h=tile_h, sup_bins=sb,
                                          act_ids=act_ids)
            depth = jax.jit(depth)
            dense = depth(s, *dense_b)
            split = depth(s, tiles, counts, big, sup[:2], act)
        else:
            dense = tr.rasterize_depth(s, *dense_b, w, h, 128, atlas_bounds=bounds,
                                       tri_atlas=atl, tile_h=tile_h)
            split = tr.rasterize_depth(s, tiles, counts, big, w, h, 128,
                                       atlas_bounds=bounds, tri_atlas=atl,
                                       tile_h=tile_h, sup_bins=sup, act_ids=act)
        out[name] = (np.asarray(dense), np.asarray(split))
    return out


def _atlas_close(j, t):
    cov_j, cov_t = j > 0, t > 0
    assert (cov_j == cov_t).mean() >= 0.999
    both = cov_j & cov_t
    assert np.abs(j[both] - t[both]).max(initial=0.0) <= 1e-5


@pytest.mark.parametrize("tile_h", [16, 128])
def test_depth_atlas_matches_reference(tile_h):
    """Port plain versions against the JAX kernels in interpret mode, dense
    and split, with atlas-rect clipping; the port's split equals its dense
    exactly (the reference's test_split_depth_matches_dense)."""
    host = _atlas_scene(11)
    t = host["valid"].shape[0]
    bounds = ((0, 256, 0, 256), (256, 512, 0, 256))
    tri_atlas = (np.arange(t) % 2).astype(np.int32)
    n_tiles = 4 * (256 // tile_h)
    out = _depth_pair(host, 512, 256, bounds, tri_atlas, tile_h, n_tiles)
    for a in range(2):
        _atlas_close(out["j"][a], out["t"][a])
    np.testing.assert_array_equal(out["t"][0], out["t"][1])
    assert (out["t"][0] > 0).mean() > 0.05


def test_split_depth_drops_inactive_tiles_like_reference():
    """With fewer active tiles than occupied ones, the least populated
    tiles lose their lists on both sides alike."""
    host = _atlas_scene(13, n_big=3)
    t = host["valid"].shape[0]
    out = _depth_pair(host, 512, 256, (), np.zeros(t, np.int32), 16, 9)
    _atlas_close(out["j"][1], out["t"][1])
    assert (out["t"][1] != out["t"][0]).any()


def test_corner_binning_matches_slot_binning_depth_on_port():
    """Mirror of test_corner_binning_matches_slot_binning_depth: the port's
    dense depth from corner binning equals the depth from the slot-copy
    binning (bin_triangles foot 2x2), and so does its split path."""
    _, s = _both(_atlas_scene(23, small_max=30.0, n_big=5))
    w, h, th = 512, 256, 16
    ref = tr.rasterize_depth(s, *tr.bin_triangles(s, w, h, 128, 64, max_big=16,
                                                  foot=2, tile_h=th, foot_y=2),
                             w, h, 128, tile_h=th)
    ctiles, ccounts, cbig = tr.bin_triangles_corner(s, w, h, 128, 64, max_big=16,
                                                    tile_h=th)
    torch.testing.assert_close(tr.rasterize_depth(s, ctiles, ccounts, cbig, w, h,
                                                  128, tile_h=th), ref, rtol=0, atol=0)
    n_occ = int((ccounts > 0).sum())
    tiles, counts, big, act = tr.bin_triangles_corner(
        s, w, h, 128, 64, max_big=16, tile_h=th, max_active=n_occ + 2)
    sup = tr.bin_big_supertiles(s, big, w, h, 128, th, 2, 4, 16)
    split = tr.rasterize_depth(s, tiles, counts, big, w, h, 128, tile_h=th,
                               sup_bins=sup, act_ids=act)
    torch.testing.assert_close(split, ref, rtol=0, atol=0)
    # the split path with its own compaction (no act_ids: the top counts)
    split2 = tr.rasterize_depth(s, ctiles, ccounts, cbig, w, h, 128, tile_h=th,
                                sup_bins=sup, max_active=n_occ + 1)
    torch.testing.assert_close(split2, ref, rtol=0, atol=0)


def test_early_exit_keeps_the_result():
    """The plain versions' early exit fires on covered tiles, and the
    result equals a run without it (a bound of +inf never stops): two near
    triangles cover each 128x128 tile and come first in its list, far
    small casters follow."""
    host = _atlas_scene(29, n_small=120, n_big=0, drop_every=10 ** 6)
    host["z"][:] = np.linspace(0.5, 0.1, host["z"].shape[1], dtype=np.float32)
    cover_x, cover_y = [], []
    for ty in range(2):
        for tx in range(4):
            x0, y0, x1, y1 = tx * 128.0, ty * 128.0, tx * 128.0 + 128, ty * 128.0 + 128
            cover_x += [(x0, x0, x1), (x1, x1, x0)]
            cover_y += [(y0, y1, y0), (y1, y0, y1)]
    cx = np.array(cover_x, np.float32).T
    cy = np.array(cover_y, np.float32).T
    n = cx.shape[1]
    host = {"sx": np.concatenate([cx, host["sx"]], 1),
            "sy": np.concatenate([cy, host["sy"]], 1),
            "z": np.concatenate([np.full((3, n), 0.9, np.float32), host["z"]], 1),
            "inv_area": np.concatenate([np.full(n, 1 / 128.0 ** 2, np.float32),
                                        host["inv_area"]]),
            "valid": np.concatenate([np.ones(n, bool), host["valid"]])}
    for k, f in (("xmin", np.min), ("xmax", np.max)):
        host[k] = f(host["sx"], 0)
    for k, f in (("ymin", np.min), ("ymax", np.max)):
        host[k] = f(host["sy"], 0)
    _, s = _both(host)
    b = tr.bin_triangles_corner(s, 512, 256, 128, 256, tile_h=128)
    a = tr.depth_args(s, *b, 512, 256, 128, tile_h=128)["dense"]
    no_exit = torch.full_like(a[4], float("inf"))
    with_exit = tr.depth_dense_plain(*a)
    torch.testing.assert_close(with_exit, tr.depth_dense_plain(*a[:4], no_exit, *a[5:]),
                               rtol=0, atol=0)
    # after the first block alone, tiles with more blocks are covered
    # nearer than everything after them, so their loops stop there
    first = tr.depth_dense_plain(a[0], a[1], torch.clamp(a[2], max=16), *a[3:])
    tile_min = tr._image_tiles(first, 4, 128, 128).amin(dim=1)
    assert ((tile_min >= a[4][:, 1]) & (a[2] > 16)).any()
    assert (with_exit > 0.85).all()


@pytest.fixture(scope="module")
def cascades():
    """Camera constants at 256x128, the fitted cascades of both packages,
    random world triangles (corner-major (3, T) planes) and both packages'
    atlases of them (render_cascades)."""
    from garden_tpu.systems import camera as jcam
    eye = jnp.array([0.0, 9.0, 14.0])
    view = jm3.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    proj = jm3.perspective_reverse_z(1.0, 2.0, 0.1)
    c = jcam.common_constants(eye, view, proj, jnp.array([0.4, -0.7, -0.5]),
                              (256, 128), 0.0, 1.0 / 60.0)
    cfg = dict(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
               atlas_foot_y=2, max_active_tiles=24, distance=40.0)
    jcfg, tcfg = JShadowConfig(**cfg), ShadowConfig(**cfg)
    splits = jcsm.cascade_splits(jcfg, 0.1)
    assert splits == tcsm.cascade_splits(tcfg, 0.1)
    ivp, ld = np.asarray(c["inv_view_proj"]), np.asarray(c["light_dir"])
    jl = jcsm.fit_cascades(jnp.asarray(ivp), jnp.asarray(ld), 0.1, splits, 0.1)
    tl = tcsm.fit_cascades(torch.from_numpy(ivp), torch.from_numpy(ld), 0.1, splits, 0.1)
    rng = np.random.default_rng(37)
    t = 600
    base = rng.uniform(-12, 12, (1, t, 3)) * [1, 0.3, 1]
    corners = (base + rng.normal(0, 0.6, (3, t, 3))).astype(np.float32)
    planes = [np.ascontiguousarray(corners[..., k]) for k in range(3)]
    valid = np.ones(t, bool)
    jatlas, _ = jcsm.render_cascades(None, None, jnp.asarray(valid), jl, jcfg,
                                     pos_planes=tuple(jnp.asarray(p) for p in planes))
    tatlas, ttrans = tcsm.render_cascades(tuple(torch.from_numpy(p) for p in planes),
                                          torch.from_numpy(valid), tl, tcfg)
    assert ttrans is None                      # no translucent casters given
    return c, jcfg, tcfg, splits, jl, tl, planes, jatlas, tatlas


def test_cascade_fit_and_setup_match(cascades):
    c, jcfg, tcfg, splits, jl, tl, planes = cascades[:7]
    assert jcsm.cascade_layout(jcfg) == tcsm.cascade_layout(tcfg)
    # rtol 1e-6; the absolute floor is the translation column's: its entries
    # are dot products of terms ~200 (the light's eye sits 200 units back),
    # so summing them in another order moves them by ~ulp(200) = 1.5e-5
    for k in ("view", "projs", "lvps"):
        np.testing.assert_allclose(np.asarray(jl[k]), tl[k].numpy(), rtol=1e-6,
                                   atol=3e-5, err_msg=k)
    sizes, offs, _, _ = tcsm.cascade_layout(tcfg)
    v = tl["view"]
    lpl = [v[i, 0] * torch.from_numpy(planes[0]) + v[i, 1] * torch.from_numpy(planes[1])
           + v[i, 2] * torch.from_numpy(planes[2]) + v[i, 3] for i in range(3)]
    valid = np.ones(planes[0].shape[1], bool)
    valid[::11] = False
    jset = jcsm._setup_cascades(*[jnp.asarray(x.numpy()) for x in lpl],
                                jnp.asarray(valid), sizes, offs, jnp.asarray(tl["projs"]))
    tset = tcsm._setup_cascades(*lpl, torch.from_numpy(valid), sizes, offs, tl["projs"])
    for k in ("sx", "sy", "xmin", "xmax", "ymin", "ymax"):
        np.testing.assert_allclose(np.asarray(jset[k]), tset[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
    for k in ("z", "inv_area"):
        np.testing.assert_allclose(np.asarray(jset[k]), tset[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _eq(jset["valid"], tset["valid"], "valid")
    assert 0 < int(tset["valid"].sum()) < tset["valid"].shape[0]


@pytest.mark.parametrize("step", [1, 2])
def test_resolve_shadow_matches(cascades, step):
    """render_cascades + resolve_shadow of both packages on the same
    inputs: the atlases within the raster bar, the factor within 1e-4 on
    >= 99.5% of pixels."""
    import dataclasses
    c, jcfg, tcfg, splits, jl, tl, planes, jatlas, tatlas = cascades
    jcfg = dataclasses.replace(jcfg, resolve_step=step)
    tcfg = dataclasses.replace(tcfg, resolve_step=step)
    _atlas_close(np.asarray(jatlas), tatlas.numpy())
    assert (tatlas > 0).float().mean() > 0.01
    rng = np.random.default_rng(41)
    h, w = 64, 96
    pos = np.stack([rng.uniform(-12, 12, (h, w)), rng.uniform(-0.5, 4, (h, w)),
                    rng.uniform(-12, 12, (h, w))], -1).astype(np.float32)
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    cam = np.asarray(c["camera_pos"])
    vd = np.linalg.norm(pos - cam, axis=-1).astype(np.float32)
    js = np.asarray(jcsm.resolve_shadow(jnp.asarray(pos), jnp.asarray(nrm),
                                        jnp.asarray(vd), jatlas, None, jl, jcfg,
                                        splits, jnp.asarray(c["light_dir"])))
    ts = tcsm.resolve_shadow(torch.from_numpy(pos), torch.from_numpy(nrm),
                             torch.from_numpy(vd), tatlas, tl, tcfg, splits).numpy()
    assert js.shape == ts.shape == (h, w, 1)
    assert (np.abs(js - ts) <= 1e-4).mean() >= 0.995
    assert 0.0 < ts.mean() < 1.0 and (ts < 1.0).mean() > 0.01
