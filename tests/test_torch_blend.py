"""Parity of the port's non-opaque rasters with the reference: the exact
back-to-front binning (`bin_triangles(priority=)`), `merge_big_list`, the
visibility raster of the refraction pass (the plain version of kernel K5),
the ordered alpha blend (K6) and the weighted-blended OIT (K7) with its
composite, against `garden_tpu.render.raster` and `garden_tpu.render.oit`,
whose Pallas kernels run in interpret mode.

Tolerances: binning is compared exactly, and so is tri_id. Depth and the
barycentrics agree to 1e-5, the blended colour, the OIT accumulators and
the composite to 1e-5 relative to their scale, on every pixel except the
few whose coverage flips: XLA's CPU backend contracts the interpret-mode
kernels' edge products into fused multiply-adds, while the port rounds
every op (as its CUDA kernels, built with -fmad=false, do), so a pixel
centre lying on a triangle edge can fall on either side. The bar is
>= 99.5% of pixels (measured: every pixel on these scenes).
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.render import oit as joit
from garden_tpu.render import raster as jr
from garden_tpu_torch.render import oit as toit
from garden_tpu_torch.render import raster as tr

W, H = 128, 128

_j_bin = jax.jit(jr.bin_triangles, static_argnums=(1, 2, 3, 4),
                 static_argnames=("max_per_tile", "max_big", "foot", "tile_h",
                                  "foot_y"))
_j_vis = jax.jit(jr.rasterize_visibility, static_argnums=(4, 5, 6),
                 static_argnames=("tile_h",))
_j_blend = jax.jit(jr.rasterize_sorted_blend, static_argnums=(7, 8, 9),
                   static_argnames=("atlas_bounds", "tile_h"))
_j_oit = jax.jit(joit.rasterize_oit, static_argnums=(5, 6, 7))


def _clip_tris(seed, n_small, n_big, small_xmax=0.9):
    """Front-facing clip-space triangles at w = 2: many small ones (their
    first corner's ndc x below small_xmax) and a few spanning several tiles
    (the big list) -> (T*3, 4) vertices."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.9, 0.9, (n_small + n_big, 2)).astype(np.float32)
    base[:n_small, 0] = rng.uniform(-0.9, small_xmax, n_small)
    d1 = np.concatenate([rng.uniform(0.05, 0.4, (n_small, 2)),
                         rng.uniform(0.8, 1.6, (n_big, 2))]).astype(np.float32)
    rot = np.stack([-d1[:, 1], d1[:, 0]], -1)
    zz = rng.uniform(0.2, 1.6, (n_small + n_big, 1)).astype(np.float32)
    verts = [np.concatenate([p * 2.0, zz, np.full_like(zz, 2.0)], -1)
             for p in (base, base + d1, base + rot)]
    return np.stack(verts, 1).reshape(-1, 4)


def _setups(clip, w=W, h=H):
    n = clip.shape[0] // 3
    idx = jnp.arange(n * 3, dtype=jnp.int32).reshape(n, 3)
    js = jr.setup_triangles(jnp.asarray(clip), idx, jnp.ones((n,), bool), w, h)
    planes = [torch.from_numpy(np.ascontiguousarray(clip.reshape(n, 3, 4)[:, :, c].T))
              for c in range(4)]
    return js, tr.setup_triangles_planes(*planes, torch.ones(n, dtype=torch.bool), w, h)


def _sorted_priority(ts):
    """The sorted pass's priority: the inverse of a stable argsort of the
    centroid reverse-Z (far first), invalid triangles last."""
    zkey = torch.where(ts["valid"], ts["z"].mean(dim=0), 2.0)
    order = torch.argsort(zkey, stable=True)
    prio = torch.empty_like(order)
    prio[order] = torch.arange(order.shape[0])
    return prio.int()


def _eq(j, t, name):
    np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


def _mostly_close(j, t, atol, frac=0.995):
    """|j - t| <= atol on >= frac of the pixels (any channel)."""
    d = np.abs(np.asarray(j) - t.numpy())
    d = d.reshape(d.shape[0], d.shape[1], -1).max(-1)
    assert (d <= atol).mean() >= frac, (d <= atol).mean()


BIN_CASES = {
    "square": dict(tile=32, max_per_tile=64, max_big=16, foot=2),
    "rect": dict(tile=32, max_per_tile=32, max_big=16, foot=2, tile_h=16, foot_y=2),
    "overflow": dict(tile=32, max_per_tile=8, max_big=4, foot=2),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_priority_binning_matches(case):
    """bin_triangles(priority=) equals the reference exactly: tile lists in
    ascending priority, the big list too, mapped back to triangle ids."""
    kw = dict(BIN_CASES[case])
    tile = kw.pop("tile")
    js, ts = _setups(_clip_tris(1, 70, 6))
    prio = _sorted_priority(ts)
    jb = _j_bin(js, W, H, tile, priority=jnp.asarray(prio.numpy()), **kw)
    tb = tr.bin_triangles(ts, W, H, tile, priority=prio, **kw)
    for j, t, name in zip(jb, tb, ("tile_tris", "counts", "big_list")):
        _eq(j, t, name)
    assert int((tb[2] >= 0).sum()) >= 2                  # big triangles present
    # the lists run far to near: non-decreasing priority along each row
    rows = torch.where(tb[0] >= 0, prio[tb[0].clamp(min=0).long()], 1 << 30)
    assert bool((rows[:, 1:] >= rows[:, :-1]).all())
    with pytest.raises(ValueError):
        tr.bin_triangles(ts, W, H, tile, priority=prio,
                         bucket_priority=torch.zeros_like(prio), **kw)


def test_merge_big_list_matches():
    """Merged counts are B + counts where a tile has entries, else the big
    list's used slots; tiles with only big triangles keep their big rows."""
    js, ts = _setups(_clip_tris(2, 40, 5, small_xmax=-0.5))
    jb = _j_bin(js, W, H, 32, 8, max_big=16, foot=2)
    tb = tr.bin_triangles(ts, W, H, 32, 8, max_big=16, foot=2)
    jm = jr.merge_big_list(*jb)
    tm = tr.merge_big_list(*tb)
    _eq(jm[0], tm[0], "tile_tris")
    _eq(jm[1], tm[1], "counts")
    n_big = int((tb[2] >= 0).sum())
    assert ((tb[1] == 0) & (tm[1] == n_big)).any() and n_big > 0
    assert (tm[1] == 16 + tb[1])[tb[1] > 0].all()


@pytest.mark.parametrize("tile,tile_h,foot_y", [(32, None, None), (32, 16, 4),
                                                (64, 16, 8)],
                         ids=["square", "rect", "rect_wide"])
def test_visibility_matches_reference(tile, tile_h, foot_y):
    """The plain version of the visibility kernel against the reference's
    rasterize_visibility (the refraction pass's raster), and rectangular
    tiles against square ones (the reference's test_rectangular_tiles_
    match_square)."""
    js, ts = _setups(_clip_tris(3, 60, 4))
    kw = dict(tile_h=tile_h, foot_y=foot_y, max_big=16)
    jb = _j_bin(js, W, H, tile, 64, **kw)
    tb = tr.bin_triangles(ts, W, H, tile, 64, **kw)
    jv = _j_vis(js, *jb, W, H, tile, tile_h=tile_h)
    tv = tr.rasterize_visibility(ts, *tb, W, H, tile, tile_h=tile_h)
    _eq(jv["tri_id"], tv["tri_id"], "tri_id")
    for k in ("depth", "b0", "b1"):
        np.testing.assert_allclose(np.asarray(jv[k]), tv[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert (tv["tri_id"] >= 0).float().mean() > 0.3
    sq = tr.rasterize_visibility(ts, *tr.bin_triangles(ts, W, H, 32, 64, max_big=16),
                                 W, H, 32)
    for k in ("tri_id", "depth", "b0", "b1"):
        assert torch.equal(sq[k], tv[k]), k


def test_visibility_ties_follow_the_tournament():
    """Stacked coplanar copies tie everywhere, also between the big list
    and the tile lists: tri_id must follow the reference's bit-reversed
    block order exactly."""
    clip = _clip_tris(4, 12, 2).reshape(-1, 3, 4)
    clip[..., 2] = 1.0                                    # one depth plane
    clip = np.concatenate([clip[np.random.default_rng(5).permutation(len(clip))]
                           for _ in range(4)]).reshape(-1, 4)
    js, ts = _setups(clip)
    jb = _j_bin(js, W, H, 32, 48, max_big=16, foot=2)
    tb = tr.bin_triangles(ts, W, H, 32, 48, max_big=16, foot=2)
    jv = _j_vis(js, *jb, W, H, 32)
    tv = tr.rasterize_visibility(ts, *tb, W, H, 32)
    _eq(jv["tri_id"], tv["tri_id"], "tri_id")
    assert (tv["tri_id"] >= 0).float().mean() > 0.3


def _blend_inputs(seed, n_small=70, n_big=5, small_xmax=0.9):
    rng = np.random.default_rng(seed)
    clip = _clip_tris(seed, n_small, n_big, small_xmax)
    js, ts = _setups(clip)
    t = ts["valid"].shape[0]
    rgba = rng.uniform(0.1, 0.9, (t, 4)).astype(np.float32)
    hdr = rng.uniform(0.0, 2.0, (H, W, 3)).astype(np.float32)
    # an opaque wall at reverse-Z 0.45 over the left half, sky elsewhere
    opaque = np.where(np.arange(W)[None, :] < W // 2, 0.45, 0.0)
    opaque = np.broadcast_to(opaque, (H, W)).astype(np.float32).copy()
    return js, ts, rgba, hdr, opaque


@pytest.mark.parametrize("atlas", [False, True], ids=["screen", "atlas_rects"])
@pytest.mark.parametrize("tile_h", [None, 16], ids=["square", "rect"])
def test_sorted_blend_matches_reference(atlas, tile_h):
    """The plain version of the sorted_blend kernel against the reference's
    rasterize_sorted_blend, binned back to front with the sorted pass's
    priority; with atlas rects each triangle clips to its rect."""
    js, ts, rgba, hdr, opaque = _blend_inputs(6)
    prio = _sorted_priority(ts)
    kw = dict(max_big=16, foot=2, tile_h=tile_h, foot_y=2 if tile_h else None)
    jb = _j_bin(js, W, H, 32, 32, priority=jnp.asarray(prio.numpy()), **kw)
    tb = tr.bin_triangles(ts, W, H, 32, 32, priority=prio, **kw)
    for j, t, name in zip(jb, tb, ("tile_tris", "counts", "big_list")):
        _eq(j, t, name)
    t_count = rgba.shape[0]
    bounds = ((0, 64, 0, 128), (64, 128, 0, 96)) if atlas else ()
    atl = (np.arange(t_count) % 3).astype(np.int32) if atlas else None
    jout = _j_blend(js, jnp.asarray(rgba), *jb, jnp.asarray(opaque), jnp.asarray(hdr),
                    W, H, 32, atlas_bounds=bounds,
                    tri_atlas=None if atl is None else jnp.asarray(atl), tile_h=tile_h)
    tout = tr.rasterize_sorted_blend(
        ts, torch.from_numpy(rgba), *tb, torch.from_numpy(opaque),
        torch.from_numpy(hdr), W, H, 32, atlas_bounds=bounds,
        tri_atlas=None if atl is None else torch.from_numpy(atl), tile_h=tile_h)
    assert tout.shape == (H, W, 3)
    _mostly_close(jout, tout, 1e-5 * 2.0)
    changed = (tout.numpy() != hdr).any(-1)
    assert changed.mean() > 0.2
    if atlas:   # rect index 2 names no rect: those triangles draw nothing
        assert not changed[96:, 64:].any()


def test_sorted_blend_order_is_back_to_front():
    """Two stacked full-screen layers: the nearer one is blended last,
    whatever their triangle ids."""
    clip = np.array([[[-3, -1, z, 2], [3, -1, z, 2], [0, 3, z, 2]]
                     for z in (1.4, 0.6)], np.float32).reshape(-1, 4)  # near first
    _, ts = _setups(clip)
    rgba = torch.tensor([[1.0, 0.0, 0.0, 0.5], [0.0, 0.0, 1.0, 0.5]])
    bins = tr.bin_triangles(ts, W, H, 32, 8, priority=_sorted_priority(ts))
    out = tr.rasterize_sorted_blend(ts, rgba, *bins, torch.zeros(H, W),
                                    torch.zeros(H, W, 3), W, H, 32)
    c = out[H // 2, W // 2]
    assert c[2] == 0.25 and c[0] == 0.5          # blue under red: red on top


@pytest.mark.parametrize("cap", [64, 8], ids=["fits", "overflow"])
def test_oit_matches_reference(cap):
    """The plain version of the OIT kernel and the composite against the
    reference on merged lists, with and without list overflow; tiles with
    only big triangles walk the big list alone."""
    js, ts, rgba, hdr, opaque = _blend_inputs(7, n_small=90, n_big=6, small_xmax=-0.5)
    jb = jr.merge_big_list(*_j_bin(js, W, H, 32, cap, max_big=16, foot=2))
    tb = tr.merge_big_list(*tr.bin_triangles(ts, W, H, 32, cap, max_big=16, foot=2))
    _eq(jb[0], tb[0], "tile_tris")
    _eq(jb[1], tb[1], "counts")
    jacc, jrev = _j_oit(js, jnp.asarray(rgba), *jb, jnp.asarray(opaque), W, H, 32)
    tacc, trev = toit.rasterize_oit(ts, torch.from_numpy(rgba), *tb,
                                    torch.from_numpy(opaque), W, H, 32)
    assert tacc.shape == (H, W, 4) and trev.shape == (H, W)
    scale = float(np.abs(np.asarray(jacc)).max())
    _mostly_close(jacc, tacc, 1e-5 * scale)
    _mostly_close(jrev, trev, 1e-5)
    assert (trev < 1).float().mean() > 0.2 and (trev == 1).any()
    jc = joit.composite(jnp.asarray(hdr), jacc, jrev)
    tc = toit.composite(torch.from_numpy(hdr), tacc, trev)
    _mostly_close(jc, tc, 1e-5 * 2.0)
    counts = tr.bin_triangles(ts, W, H, 32, cap, max_big=16, foot=2)[1]
    assert (counts == 0).any() and (tb[1][counts == 0] > 0).any()


def test_cpu_wrappers_take_plain_versions_and_count_no_launch():
    """On CPU tensors each wrapper runs its plain version and counts no
    launch; the CUDA entry points refuse CPU tensors."""
    js, ts, rgba, hdr, opaque = _blend_inputs(8, n_small=20, n_big=2)
    bins = tr.bin_triangles(ts, W, H, 32, 32, max_big=16)
    merged = tr.merge_big_list(*bins)
    fns = (tr.rasterize_visibility, tr.rasterize_sorted_blend, toit.rasterize_oit)
    before = [f.launches for f in fns]
    tr.rasterize_visibility(ts, *bins, W, H, 32)
    tr.rasterize_sorted_blend(ts, torch.from_numpy(rgba), *bins,
                              torch.from_numpy(opaque), torch.from_numpy(hdr), W, H, 32)
    toit.rasterize_oit(ts, torch.from_numpy(rgba), *merged, torch.from_numpy(opaque),
                       W, H, 32)
    assert [f.launches for f in fns] == before
    with pytest.raises(ValueError):
        tr.visibility_cuda(*tr.visibility_args(ts, *bins, W, H, 32))
    with pytest.raises(ValueError):
        tr.blend_cuda(*tr.blend_args(ts, torch.from_numpy(rgba), *bins,
                                     torch.from_numpy(opaque), torch.from_numpy(hdr),
                                     W, H, 32))
    with pytest.raises(ValueError):
        toit.oit_cuda(*toit.oit_args(ts, torch.from_numpy(rgba), *merged,
                                     torch.from_numpy(opaque), W, H, 32))
