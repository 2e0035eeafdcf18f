"""Parity of the port's raster path (setup, binning, the raster_shade plain
version) with `garden_tpu.render.raster`, whose Pallas kernel runs in
interpret mode here.

Tolerances: setup, binning and tri_id are compared exactly. Depth and the
barycentrics agree to 1e-5, not bitwise: XLA's CPU backend contracts the
interpret-mode kernel's a*px + b*py + c into fused multiply-adds, while
the port rounds every op (as its CUDA kernel, built with -fmad=false,
does). The finished G-buffer planes agree to 2e-5, the bar of the
reference's own test_gbuf_kernel_matches_attrs_path, except velocity:
pixel position minus interpolated previous position, both ~1e2 px here, so
the barycentrics' ~1e-6 rounding difference grows to ~1e-4 px (2e-4 bar).
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.render import raster as jr
from garden_tpu_torch import cuda_build
from garden_tpu_torch.render import raster as tr

W, H, TILE = 128, 128, 64

# binning and raster run jitted (one compile instead of one per op); setup
# runs op by op, since under jit XLA contracts its products into FMAs
_j_bin = jax.jit(jr.bin_triangles, static_argnums=(1, 2, 3, 4),
                 static_argnames=("max_per_tile", "max_big", "foot", "tile_h",
                                  "foot_y"))
_j_raster = jax.jit(jr.rasterize_visibility_shaded, static_argnums=(5, 6, 7),
                    static_argnames=("tile_h", "gbuf"))


def _random_tris(seed, n, zmin=0.2, zmax=1.6):
    """Random small CCW clip-space triangles at w=2 -> (n*3, 4) verts."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.9, 0.9, (n, 2)).astype(np.float32)
    d1 = rng.uniform(0.05, 0.5, (n, 2)).astype(np.float32)
    rot = np.stack([-d1[:, 1], d1[:, 0]], -1)
    zz = rng.uniform(zmin, zmax, (n, 1)).astype(np.float32)
    verts = [np.concatenate([p * 2.0, zz, np.full((n, 1), 2.0, np.float32)], -1)
             for p in (base, base + d1, base + rot)]
    return np.stack(verts, 1).reshape(n * 3, 4)


def _records(seed, n):
    """Shading records with realistic fields (gbuffer.pack_triangle_records)."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((n, 36), np.float32)
    nrm = rng.normal(size=(n, 3, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    rec[:, 0:9] = nrm.reshape(n, 9)
    rec[:, 9:15] = rng.uniform(0, 1, (n, 6))
    rec[:, 15:24] = rng.uniform(0, 1, (n, 9))
    rec[:, 24] = -1.0
    rec[:, 25] = rng.integers(0, 7, n)
    rec[:, 26:32] = rng.uniform(0, 128, (n, 6))
    rec[:, 32:35] = rng.uniform(0.4, 2.0, (n, 3))
    return rec


def _setups(clip, w=W, h=H):
    """JAX and port setups of the same triangles (vertex i*3+k = corner k)."""
    n = clip.shape[0] // 3
    idx = jnp.arange(n * 3, dtype=jnp.int32).reshape(n, 3)
    js = jr.setup_triangles(jnp.asarray(clip), idx, jnp.ones((n,), bool), w, h)
    planes = [torch.from_numpy(np.ascontiguousarray(
        clip.reshape(n, 3, 4)[:, :, c].T)) for c in range(4)]
    ts = tr.setup_triangles_planes(*planes, torch.ones(n, dtype=torch.bool), w, h)
    return js, ts


def _bins_equal(jb, tb):
    for j, t, name in zip(jb, tb, ("tile_tris", "counts", "big_list")):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


def _assert_vis_equal(jvis, tvis):
    np.testing.assert_array_equal(np.asarray(jvis["tri_id"]),
                                  tvis["tri_id"].numpy())
    for k in ("depth", "b0", "b1"):
        np.testing.assert_allclose(np.asarray(jvis[k]), tvis[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def _assert_gbuf_close(jg, tg):
    np.testing.assert_allclose(jg[:16], tg[:16], rtol=0, atol=2e-5)
    np.testing.assert_allclose(jg[16:], tg[16:], rtol=0, atol=2e-4,
                               err_msg="velocity")


def test_setup_matches():
    js, ts = _setups(_random_tris(3, 50))
    for k, v in js.items():
        np.testing.assert_array_equal(np.asarray(v), ts[k].numpy(), err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(tile=64, max_per_tile=64),
    dict(tile=64, max_per_tile=16, max_big=8),
    dict(tile=64, max_per_tile=64, tile_h=16, foot_y=8),
    dict(tile=64, max_per_tile=32, max_big=32, foot=2, tile_h=32, foot_y=2,
         bucket=True),
], ids=["square", "overflow", "rect", "main_pass"])
def test_binning_matches(kw):
    kw = dict(kw)
    clip = _random_tris(4, 60)
    js, ts = _setups(clip)
    if kw.pop("bucket", False):
        z = np.asarray(js["z"]).max(0)
        bucket = (np.arange(z.shape[0]) * 7) % 16
        kw["bucket_priority"] = bucket
    tile = kw.pop("tile")
    tkw = dict(kw)
    if "bucket_priority" in kw:
        kw["bucket_priority"] = jnp.asarray(kw["bucket_priority"], jnp.int32)
        tkw["bucket_priority"] = torch.as_tensor(tkw["bucket_priority"])
    _bins_equal(_j_bin(js, W, H, tile, **kw),
                tr.bin_triangles(ts, W, H, tile, **tkw))


def test_overflow_drops_farthest_with_bucket_priority():
    """Mirror of the reference test: tile overflow keeps the nearest depth
    buckets, and the port's lists equal the reference's."""
    n = 40
    rng = np.random.default_rng(1)
    z = np.linspace(0.1, 0.9, n).astype(np.float32)
    cx = rng.uniform(10, 100, n).astype(np.float32)
    cy = rng.uniform(10, 100, n).astype(np.float32)
    host = {"sx": np.stack([cx, cx + 3, cx], 0), "sy": np.stack([cy, cy, cy + 3], 0),
            "z": np.stack([z, z, z], 0), "inv_w": np.ones((3, n), np.float32),
            "inv_area": np.ones((n,), np.float32), "xmin": cx, "xmax": cx + 3,
            "ymin": cy, "ymax": cy + 3, "valid": np.ones((n,), bool)}
    bucket = 15 - np.clip(((z - 0.1) / 0.8 * 16).astype(np.int32), 0, 15)
    jb = _j_bin({k: jnp.asarray(v) for k, v in host.items()},
                          128, 128, 128, max_per_tile=8, max_big=4,
                          bucket_priority=jnp.asarray(bucket))
    tb = tr.bin_triangles({k: torch.as_tensor(v) for k, v in host.items()},
                          128, 128, 128, max_per_tile=8, max_big=4,
                          bucket_priority=torch.as_tensor(bucket))
    _bins_equal(jb, tb)
    kept = sorted(int(x) for x in tb[0][0] if x >= 0)
    assert int(tb[1][0]) == 8
    dropped = sorted(set(range(n)) - set(kept))
    assert z[kept].min() >= z[dropped].max() - 0.0501


def _raster_both(clip, rec, w=W, h=H, tile=TILE, tile_h=None, **bin_kw):
    js, ts = _setups(clip, w, h)
    jb = _j_bin(js, w, h, tile, tile_h=tile_h, **bin_kw)
    tb = tr.bin_triangles(ts, w, h, tile, tile_h=tile_h, **bin_kw)
    _bins_equal(jb, tb)
    jvis, jg = _j_raster(js, jnp.asarray(rec), *jb, w, h, tile,
                                              tile_h=tile_h, gbuf=True)
    tvis, tg = tr.rasterize_visibility_shaded(ts, torch.from_numpy(rec), *tb, w, h,
                                              tile, tile_h=tile_h)
    return jvis, np.asarray(jg), tvis, tg.numpy()


def test_gbuf_raster_matches_reference():
    """Mirror of test_gbuf_kernel_matches_attrs_path: the plain version of
    raster_shade against rasterize_visibility_shaded(gbuf=True)."""
    n = 30
    jvis, jg, tvis, tg = _raster_both(_random_tris(5, n), _records(6, n),
                                      max_per_tile=64)
    _assert_vis_equal(jvis, tvis)
    assert (tvis["tri_id"] >= 0).float().mean() > 0.3
    assert tg.shape == (18, H, W)
    _assert_gbuf_close(jg, tg)
    assert np.all(tg[:, tvis["tri_id"].numpy() < 0] == 0.0)


def test_rectangular_tiles_match_square():
    """Mirror of the reference test: short-wide tiles give the same frame
    as square ones, and both equal the reference."""
    n = 40
    clip, rec = _random_tris(7, n), _records(8, n)
    sq = _raster_both(clip, rec, max_per_tile=64)
    rc = _raster_both(clip, rec, tile_h=16, foot_y=8, max_per_tile=64)
    for jvis, jg, tvis, tg in (sq, rc):
        _assert_vis_equal(jvis, tvis)
        _assert_gbuf_close(jg, tg)
    for k in ("tri_id", "depth", "b0", "b1"):
        np.testing.assert_array_equal(sq[2][k].numpy(), rc[2][k].numpy(), err_msg=k)


@pytest.mark.parametrize("copies", [3, 24], ids=["in_block", "across_blocks"])
def test_exact_depth_ties_pick_the_reference_winner(copies):
    """Coplanar triangles with exactly equal depth: the winner among equal
    depths must follow the reference's tournament (bit-reversed order
    inside a 16-slot block, earlier block first), so tri_id matches
    exactly. Quads split on the diagonal tie on the shared edge; stacked
    copies tie everywhere, also between the big list and the tile list."""
    rng = np.random.default_rng(9)
    quads = []
    for q in range(6):
        x0, y0 = rng.uniform(-0.8, 0.3, 2)
        s = rng.uniform(0.2, 0.5)
        z = 0.5 if q % 2 else 0.8                 # two shared depth planes
        a, b, c, d = ((x0, y0), (x0 + s, y0), (x0 + s, y0 + s), (x0, y0 + s))
        quads += [(a, b, c, z), (a, c, d, z)]
    big = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), 0.8)  # spans many tiles
    tris = []
    for i in range(copies):
        order = rng.permutation(len(quads))
        tris += [quads[k] for k in order]
        if i % 2 == 0:
            tris.append(big)
    clip = np.array([[[px * 2, py * 2, z, 2.0] for (px, py) in t[:3]]
                     for t in tris], np.float32).reshape(-1, 4)
    n = len(tris)
    jvis, jg, tvis, tg = _raster_both(clip, _records(10, n), max_per_tile=64,
                                      max_big=32)
    _assert_vis_equal(jvis, tvis)
    _assert_gbuf_close(jg, tg)
    # the tie rule matters here: first-in-list order would pick other ids
    assert (tvis["tri_id"] >= 0).float().mean() > 0.5


def test_tie_order_is_bit_reversed():
    """The scan order reproduces the halving tournament on every tie
    pattern of one 16-slot block."""
    rng = np.random.default_rng(0)
    for _ in range(2000):
        z = rng.integers(0, 3, 16).astype(np.float32)
        idx = list(range(16))
        k = 16
        while k > 1:
            h = k // 2
            idx = [idx[i + h] if z[idx[i + h]] > z[idx[i]] else idx[i]
                   for i in range(h)]
            k = h
        best = None
        for s in tr.BITREV16:
            if best is None or z[s] > z[best]:
                best = s
        assert best == idx[0]


def test_cpu_wrapper_uses_plain_version_and_counts_no_launch():
    n = 10
    clip = _random_tris(11, n)
    _, ts = _setups(clip)
    tb = tr.bin_triangles(ts, W, H, TILE, 64)
    before = cuda_build.launches["raster_shade"]
    vis, g = tr.rasterize_visibility_shaded(ts, torch.from_numpy(_records(1, n)),
                                            *tb, W, H, TILE)
    args = tr.kernel_args(ts, torch.from_numpy(_records(1, n)), *tb, W, H, TILE)
    pvis, pg = tr.raster_shade_plain(*args, max_elems=1 << 12)   # many chunks
    assert cuda_build.launches["raster_shade"] == before
    assert torch.equal(g, pg)
    for k in vis:
        assert torch.equal(vis[k], pvis[k])
    with pytest.raises(ValueError):
        tr.raster_shade_cuda(*args)
