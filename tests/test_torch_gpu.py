"""Tests of the port's CUDA kernels; they need an NVIDIA card (sm_90a) and
the CUDA toolkit, and skip without one. This file imports no JAX, so on a
machine without JAX run it with the repository's conftest disabled:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The raster_shade kernel must agree with its plain PyTorch version run on
the card: tri_id, depth and barycentrics exactly (the kernel is built with
-fmad=false and evaluates the same ops in the same order), the G-buffer
planes to 2e-5 (the kernel's rsqrtf may differ from torch.rsqrt by an ulp).
The depth kernels (depth_super, depth_grid, depth_dense) must equal their
plain versions exactly, and the split pair the dense one. So must the
visibility kernel (K5), the ordered blend (K6, with and without atlas
rects) and the OIT accumulation (K7, whose 128x128 tiles run as sixteen
128x8 row bands). Small combined steps on the card, the glass step's
among them, match the CPU within the image bar. All seven cull their slots;
they equal their plain versions in every bit, and their `kept` counts
equal the row sums of the cull's plain twin (`raster.tile_slot_keep`; for
the row bands of K1 and K5 over `raster.band_args`, of K7 over
`oit.cull_args`, of K2 over `raster.super_lists`, of K3 with
tiles=act_ids), at two tile shapes and at a frame size that is not a
multiple of the tile. The tracer (`utils/profiler`) counts the card's host
synchronizations per span, and its contact and binning counters add none.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import numpy as np
import pytest
import torch

from garden_tpu_torch import cuda_build
from garden_tpu_torch.entry import (GLASS_BOXES, GLASS_OVERRIDES, SLICE_OVERRIDES,
                                    build)
from garden_tpu_torch.physics.shapes import SHAPE_NAMES
from garden_tpu_torch.render import oit, raster

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(seed, n, w, h, ties):
    """Setup and shading records of random small triangles; with `ties`,
    every triangle appears several times (exactly equal depths)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.9, 0.9, (n, 2))
    d1 = rng.uniform(0.05, 0.5, (n, 2))
    rot = np.stack([-d1[:, 1], d1[:, 0]], -1)
    zz = rng.uniform(0.2, 1.6, (n, 1))
    corners = np.stack([base, base + d1, base + rot], 0) * 2.0     # (3, n, 2)
    if ties:
        corners = np.concatenate([corners] * 3, axis=1)[:, rng.permutation(3 * n)]
        zz = np.concatenate([zz] * 3)[: 3 * n]
        zz[:] = 0.5
    t = corners.shape[1]
    planes = [torch.tensor(corners[..., 0], dtype=torch.float32),
              torch.tensor(corners[..., 1], dtype=torch.float32),
              torch.tensor(np.broadcast_to(zz[:, 0], (3, t)), dtype=torch.float32),
              torch.full((3, t), 2.0)]
    setup = raster.setup_triangles_planes(*planes, torch.ones(t, dtype=torch.bool),
                                          w, h)
    rec = rng.uniform(0, 1, (t, 36)).astype(np.float32)
    rec[:, 32:35] += 0.4
    return setup, torch.from_numpy(rec)


@pytest.mark.parametrize("tile,tile_h", [(128, 32), (64, 64), (128, 16),
                                         (128, 128)])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_kernel_matches_plain_on_card(cuda, tile, tile_h, ties):
    w, h = 320, 200                                  # ragged last tiles
    setup, rec = _scene(3, 60, w, h, ties)
    bins = raster.bin_triangles(setup, w, h, tile, 96, max_big=32,
                                tile_h=tile_h, foot=2, foot_y=2)
    to = lambda x: {k: v.to(cuda) for k, v in x.items()} if isinstance(x, dict) \
        else x.to(cuda)
    args = raster.kernel_args(to(setup), to(rec), *[to(b) for b in bins], w, h,
                              tile, tile_h)
    kvis, kg = raster.raster_shade_cuda(*args)
    pvis, pg = raster.raster_shade_plain(*args)
    torch.cuda.synchronize()
    for k in ("tri_id", "depth", "b0", "b1"):
        assert torch.equal(kvis[k], pvis[k]), k
    assert (kg - pg).abs().max().item() <= 2e-5
    assert (kvis["tri_id"] >= 0).float().mean().item() > 0.2


def test_wrapper_launches_kernel_and_counts(cuda):
    w, h = 256, 128
    setup, rec = _scene(4, 40, w, h, False)
    bins = raster.bin_triangles(setup, w, h, 128, 96, tile_h=32)
    cpu_vis, cpu_g = raster.rasterize_visibility_shaded(setup, rec, *bins, w, h,
                                                        128, tile_h=32)
    before = cuda_build.launches["raster_shade"]
    g_vis, g_g = raster.rasterize_visibility_shaded(
        {k: v.to(cuda) for k, v in setup.items()}, rec.to(cuda),
        *[b.to(cuda) for b in bins], w, h, 128, tile_h=32)
    assert cuda_build.launches["raster_shade"] == before + 1
    assert torch.equal(g_vis["tri_id"].cpu(), cpu_vis["tri_id"])
    assert (g_g.cpu() - cpu_g).abs().max().item() <= 2e-5


def test_kernel_rejects_bad_inputs(cuda):
    w, h = 256, 128
    setup, rec = _scene(5, 10, w, h, False)
    bins = raster.bin_triangles(setup, w, h, 128, 96, tile_h=32)
    args = list(raster.kernel_args({k: v.to(cuda) for k, v in setup.items()},
                                   rec.to(cuda), *[b.to(cuda) for b in bins],
                                   w, h, 128, 32))
    bad = list(args)
    bad[2] = bad[2].long()                         # tile lists must be int32
    with pytest.raises(ValueError):
        raster.raster_shade_cuda(*bad)
    bad = list(args)
    bad[0] = bad[0].cpu()                          # mixed devices
    with pytest.raises(ValueError):
        raster.raster_shade_cuda(*bad)


def test_small_combined_step_matches_cpu(cuda):
    out = {}
    for dev in ("cpu", cuda):
        step, state = build(32, 256, 128, grid_dim=8,
                            cfg_overrides=SLICE_OVERRIDES, device=dev)
        nxt, img = step(state)
        out[str(dev)] = (img.cpu(), nxt["physics"]["bodies"]["pos"].cpu())
    d = (out["cpu"][0].int() - out["cuda"][0].int()).abs().amax(-1)
    assert (d <= 2).float().mean().item() >= 0.995
    assert (out["cpu"][1] - out["cuda"][1]).abs().max().item() <= 1e-4


def _atlas_setup(seed, w, h, n_small=300, n_big=8):
    """Setup of front-facing right triangles in atlas pixels: small casters
    and big ones spanning several super-tiles, some invalid."""
    rng = np.random.default_rng(seed)
    px = np.concatenate([rng.uniform(0, w - 12, n_small), rng.uniform(0, w * 0.6, n_big)])
    py = np.concatenate([rng.uniform(0, h - 6, n_small), rng.uniform(0, h * 0.6, n_big)])
    ps = np.concatenate([rng.uniform(3, 30, n_small), rng.uniform(100, 400, n_big)])
    t = n_small + n_big
    z = rng.uniform(0.1, 0.9, t)
    sx = np.stack([px, px, px + ps], 0)
    sy = np.stack([py, py + ps, py], 0)
    valid = np.ones((t,), bool)
    valid[::17] = False
    host = {"sx": sx, "sy": sy, "z": np.stack([z, z * 0.9, z * 1.05], 0),
            "inv_area": 1.0 / (ps * ps), "xmin": sx.min(0), "xmax": sx.max(0),
            "ymin": sy.min(0), "ymax": sy.max(0)}
    setup = {k: torch.tensor(v, dtype=torch.float32) for k, v in host.items()}
    setup["valid"] = torch.from_numpy(valid)
    return setup, (np.arange(t) % 2).astype(np.int32)


@pytest.mark.parametrize("tile_h", [16, 32, 128])
def test_depth_kernels_match_plain_on_card(cuda, tile_h):
    """depth_super, depth_grid (in place on depth_super's output) and
    depth_dense against their plain versions on the card, bit for bit, with
    atlas-rect clipping; the split result equals the dense one."""
    w, h = 512, 256
    setup, atl = _atlas_setup(7, w, h)
    setup = {k: v.to(cuda) for k, v in setup.items()}
    atl = torch.from_numpy(atl).to(cuda)
    bounds = ((0, 256, 0, 256), (256, 512, 0, 256))
    dense_b = raster.bin_triangles_corner(setup, w, h, 128, 64, max_big=64,
                                          tile_h=tile_h)
    a = raster.depth_args(setup, *dense_b, w, h, 128, bounds, atl, tile_h)["dense"]
    kd, pd = raster.depth_dense_cuda(*a), raster.depth_dense_plain(*a)
    tiles, counts, big, act = raster.bin_triangles_corner(
        setup, w, h, 128, 64, max_big=64, tile_h=tile_h, max_active=10 ** 6)
    sup = raster.bin_big_supertiles(setup, big, w, h, 128, tile_h, 4,
                                    max(128 // tile_h, 1), 64)
    s = raster.depth_args(setup, tiles, counts, big, w, h, 128, bounds, atl,
                          tile_h, sup, act_ids=act)
    ks, ps = raster.depth_super_cuda(*s["super"]), raster.depth_super_plain(*s["super"])
    torch.cuda.synchronize()
    assert torch.equal(ks, ps)
    kg = raster.depth_grid_cuda(ks.clone(), *s["grid"])
    pg = raster.depth_grid_plain(ps.clone(), *s["grid"])
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(kg, pg)
    assert torch.equal(kg, kd)
    assert (kd > 0).float().mean().item() > 0.1


def test_depth_wrapper_launches_and_counts(cuda):
    w, h = 512, 256
    setup, atl = _atlas_setup(9, w, h)
    bins = raster.bin_triangles_corner(setup, w, h, 128, 64, tile_h=16)
    cpu = raster.rasterize_depth(setup, *bins, w, h, 128, tile_h=16)
    before = (cuda_build.launches["depth_dense"], cuda_build.launches["depth_super"],
              cuda_build.launches["depth_grid"])
    gpu = raster.rasterize_depth({k: v.to(cuda) for k, v in setup.items()},
                                 *[b.to(cuda) for b in bins], w, h, 128, tile_h=16)
    assert cuda_build.launches["depth_dense"] == before[0] + 1
    assert torch.equal(gpu.cpu(), cpu)
    sup = raster.bin_big_supertiles(setup, bins[2], w, h, 128, 16, 4, 8, 64)
    gs = {k: v.to(cuda) for k, v in setup.items()}
    raster.rasterize_depth(gs, *[b.to(cuda) for b in bins], w, h, 128, tile_h=16,
                           sup_bins=(sup[0].to(cuda), sup[1].to(cuda), sup[2]),
                           max_active=12)
    assert cuda_build.launches["depth_super"] == before[1] + 1
    assert cuda_build.launches["depth_grid"] == before[2] + 1
    a = raster.depth_args(gs, *[b.to(cuda) for b in bins], w, h, 128, tile_h=16)
    bad = list(a["dense"])
    bad[1] = bad[1].long()                          # lists must be int32
    with pytest.raises(ValueError):
        raster.depth_dense_cuda(*bad)
    bad = list(a["dense"])
    bad[7] = 100                                    # not a kernel tile shape
    with pytest.raises(ValueError):
        raster.depth_dense_cuda(*bad)
    s = raster.depth_args(gs, *[b.to(cuda) for b in bins], w, h, 128, tile_h=16,
                          sup_bins=(sup[0].to(cuda), sup[1].to(cuda), sup[2]),
                          max_active=12)
    short = torch.zeros(3, dtype=torch.int32, device=cuda)   # kept: one int a tile
    with pytest.raises(ValueError):
        raster.depth_super_cuda(*s["super"], kept=short)
    with pytest.raises(ValueError):
        raster.depth_grid_cuda(torch.zeros(h, w, device=cuda), *s["grid"], kept=short)


@pytest.mark.parametrize("shadow", ["split", "dense"])
def test_small_flagship_step_matches_cpu(cuda, shadow):
    from garden_tpu_torch.core.config import ShadowConfig
    kw = (dict(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
               atlas_foot_y=2, max_active_tiles=24) if shadow == "split"
          else dict(cascade_sizes=(256, 128, 128)))
    out = {}
    for dev in ("cpu", cuda):
        step, state = build(32, 256, 128, grid_dim=8,
                            cfg_overrides={"shadow": ShadowConfig(**kw)}, device=dev)
        nxt, img = step(state)
        out[str(dev)] = (img.cpu(), nxt["physics"]["bodies"]["pos"].cpu())
    d = (out["cpu"][0].int() - out["cuda"][0].int()).abs().amax(-1)
    assert (d <= 2).float().mean().item() >= 0.995
    assert (out["cpu"][1] - out["cuda"][1]).abs().max().item() <= 1e-4


def _to(x, dev):
    if isinstance(x, dict):
        return {k: v.to(dev) for k, v in x.items()}
    return x.to(dev) if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("tile,tile_h", [(128, 32), (128, 16), (64, 64)])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_visibility_kernel_matches_plain_on_card(cuda, tile, tile_h, ties):
    w, h = 320, 200
    setup, _ = _scene(12, 60, w, h, ties)
    bins = raster.bin_triangles(setup, w, h, tile, 64, max_big=64, tile_h=tile_h,
                                foot=2, foot_y=2)
    args = [_to(a, cuda) for a in raster.visibility_args(setup, *bins, w, h, tile,
                                                         tile_h)]
    kv, pv = raster.visibility_cuda(*args), raster.visibility_plain(*args)
    torch.cuda.synchronize()
    for k in ("tri_id", "depth", "b0", "b1"):
        assert torch.equal(kv[k], pv[k]), k
    assert (kv["tri_id"] >= 0).float().mean().item() > 0.2


def _blend_scene(seed, w, h):
    setup, _ = _scene(seed, 80, w, h, False)
    t = setup["valid"].shape[0]
    rng = np.random.default_rng(seed)
    rgba = torch.tensor(rng.uniform(0.1, 0.9, (t, 4)), dtype=torch.float32)
    hdr = torch.tensor(rng.uniform(0, 2, (h, w, 3)), dtype=torch.float32)
    opaque = torch.where(torch.arange(w)[None, :] < w // 2, 0.45, 0.0).expand(h, w)
    return setup, rgba, hdr, opaque.contiguous()


@pytest.mark.parametrize("tile_h", [32, 16])
@pytest.mark.parametrize("atlas", [False, True], ids=["screen", "atlas_rects"])
def test_blend_kernel_matches_plain_on_card(cuda, tile_h, atlas):
    """Back-to-front bins (the sorted pass's priority), bit for bit."""
    w, h = 320, 200
    setup, rgba, hdr, opaque = _blend_scene(13, w, h)
    zkey = torch.where(setup["valid"], setup["z"].mean(dim=0), 2.0)
    order = torch.argsort(zkey, stable=True)
    prio = torch.empty_like(order)
    prio[order] = torch.arange(order.shape[0])
    bins = raster.bin_triangles(setup, w, h, 128, 64, priority=prio, tile_h=tile_h,
                                foot=2, foot_y=2)
    t = rgba.shape[0]
    bounds = ((0, 160, 0, 200), (160, 320, 0, 128)) if atlas else ()
    atl = torch.arange(t, dtype=torch.int32) % 3 if atlas else None
    args = [_to(a, cuda) for a in raster.blend_args(
        setup, rgba, *bins, opaque, hdr, w, h, 128, bounds, atl, tile_h)]
    kb, pb = raster.blend_cuda(*args), raster.blend_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb)
    assert (kb.cpu() != hdr).any(-1).float().mean().item() > 0.2


@pytest.mark.parametrize("tile", [128, 64])
def test_oit_kernel_matches_plain_on_card(cuda, tile):
    """Merged lists (overflowing the 32-slot cap), bit for bit; 128x128
    tiles run as sixteen 128x8 bands reading one list."""
    w, h = 320, 200
    setup, rgba, _, opaque = _blend_scene(14, w, h)
    merged = raster.merge_big_list(*raster.bin_triangles(setup, w, h, tile, 32,
                                                         max_big=64))
    args = [_to(a, cuda) for a in oit.oit_args(setup, rgba, *merged, opaque, w, h,
                                               tile)]
    (ka, kr), (pa, pr) = oit.oit_cuda(*args), oit.oit_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ka, pa) and torch.equal(kr, pr)
    assert (kr < 1).float().mean().item() > 0.2


def test_nonopaque_wrappers_launch_and_count(cuda):
    w, h = 256, 128
    setup, rgba, hdr, opaque = _blend_scene(15, w, h)
    bins = raster.bin_triangles(setup, w, h, 128, 64, tile_h=32, foot=2, foot_y=2)
    merged = raster.merge_big_list(*raster.bin_triangles(setup, w, h, 128, 64))
    gs, gb, gm = _to(setup, cuda), [_to(b, cuda) for b in bins], \
        [_to(m, cuda) for m in merged]
    kernels = ("visibility", "sorted_blend", "oit")
    before = [cuda_build.launches[k] for k in kernels]
    v = raster.rasterize_visibility(gs, *gb, w, h, 128, tile_h=32)
    b = raster.rasterize_sorted_blend(gs, rgba.to(cuda), *gb, opaque.to(cuda),
                                      hdr.to(cuda), w, h, 128, tile_h=32)
    a, r = oit.rasterize_oit(gs, rgba.to(cuda), *gm, opaque.to(cuda), w, h, 128)
    assert [cuda_build.launches[k] for k in kernels] == [n + 1 for n in before]
    assert torch.equal(v["tri_id"].cpu(),
                       raster.rasterize_visibility(setup, *bins, w, h, 128,
                                                   tile_h=32)["tri_id"])
    assert torch.equal(b.cpu(), raster.rasterize_sorted_blend(
        setup, rgba, *bins, opaque, hdr, w, h, 128, tile_h=32))
    assert torch.equal(r.cpu(), oit.rasterize_oit(setup, rgba, *merged, opaque, w, h,
                                                  128)[1])
    bad = list(oit.oit_args(gs, rgba.to(cuda), *gm, opaque.to(cuda), w, h, 128))
    bad[1] = bad[1].long()                          # lists must be int32
    with pytest.raises(ValueError):
        oit.oit_cuda(*bad)


def test_small_glass_step_matches_cpu(cuda):
    from garden_tpu_torch.core.config import ShadowConfig
    shadow = ShadowConfig(resolve_step=2, cascade_sizes=(256, 128, 128),
                          atlas_tile_h=16, atlas_foot_y=2, max_active_tiles=24)
    out = {}
    for dev in ("cpu", cuda):
        step, state = build(32, 256, 128, grid_dim=8, box_materials=GLASS_BOXES,
                            cfg_overrides=dict(GLASS_OVERRIDES, shadow=shadow),
                            device=dev)
        nxt, img = step(state)
        out[str(dev)] = (img.cpu(), nxt["physics"]["bodies"]["pos"].cpu())
    d = (out["cpu"][0].int() - out["cuda"][0].int()).abs().amax(-1)
    assert (d <= 2).float().mean().item() >= 0.995
    assert (out["cpu"][1] - out["cuda"][1]).abs().max().item() <= 1e-4


def _bits(x):
    return x.contiguous().view(torch.int32)


def _cull_scene(seed, w, h, tile, tile_h, covering, n=96, n_big=48, cap=64):
    """Triangles and lists for the culled kernels (K4, K6): with
    `covering`, every triangle covers the whole frame, so no slot misses a
    tile; else small and large triangles anywhere, named by lists drawn at
    random, so most slots miss most tiles. -> (setup, lists, counts, big,
    atlas indices, rgba, hdr, opaque)."""
    rng = np.random.default_rng(seed)
    if covering:
        c = rng.uniform([-4e3, -4e3], [-2e3, -2e3], (n, 2))
        pts = np.stack([c, c + [0.0, 1e4], c + [1e4, 0.0]], 0)
    else:
        c = rng.uniform([-40, -20], [w + 40, h + 20], (n, 2))
        size = rng.choice([3.0, 20.0, 90.0, 300.0], (n, 1))
        pts = np.stack([c, c + size * rng.uniform(-1, 1, (n, 2)),
                        c + size * rng.uniform(-1, 1, (n, 2))], 0)
    sx, sy = pts[..., 0].astype(np.float32), pts[..., 1].astype(np.float32)
    area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
    host = {"sx": sx, "sy": sy, "z": rng.uniform(0.05, 0.95, (3, n)),
            "inv_area": 1.0 / np.maximum(np.abs(area), 1e-6),
            "xmin": sx.min(0), "xmax": sx.max(0), "ymin": sy.min(0), "ymax": sy.max(0)}
    setup = {k: torch.tensor(v, dtype=torch.float32) for k, v in host.items()}
    setup["valid"] = torch.ones(n, dtype=torch.bool)
    _, _, n_tiles = raster._grid(w, h, tile, tile_h)
    big = torch.full((n_big,), -1, dtype=torch.int32)
    big[:n_big - 5] = torch.from_numpy(rng.permutation(n)[:n_big - 5].astype(np.int32))
    counts = torch.from_numpy(rng.integers(0, cap + 1, n_tiles).astype(np.int32))
    lists = torch.full((n_tiles, cap), -1, dtype=torch.int32)
    for t in range(n_tiles):
        lists[t, :counts[t]] = torch.from_numpy(rng.choice(n, int(counts[t]),
                                                           replace=False).astype(np.int32))
    atlas = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    rgba = torch.tensor(rng.uniform(0.05, 0.95, (n, 4)), dtype=torch.float32)
    hdr = torch.tensor(rng.uniform(0.1, 2.0, (h, w, 3)), dtype=torch.float32)
    opaque = torch.tensor(rng.choice([0.0, 0.4], (h, w)), dtype=torch.float32)
    return setup, lists, counts, big, atlas, rgba, hdr, opaque


def _check_kept_share(kept, lists, big, covering, atlas):
    """Where triangles lie anywhere, the cull drops over a third of the
    named slots; where they cover the frame and no rect clips them, none."""
    named = int((lists >= 0).sum() + (big >= 0).sum() * lists.shape[0])
    if not covering:
        assert 3 * int(kept.sum()) < 2 * named
    elif not atlas:
        assert int(kept.sum()) == named


def _cull_bounds(w, h):
    return ((0, w // 2, 0, h), (w // 2, w, 0, h // 2), (w // 2 + 8, w, h // 2 + 3, h))


@pytest.mark.parametrize("w,h", [(264, 72), (262, 70)], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("tile_h", [16, 32])
@pytest.mark.parametrize("covering", [False, True], ids=["most_miss", "none_miss"])
@pytest.mark.parametrize("atlas", [False, True], ids=["screen", "atlas_rects"])
def test_culled_blend_matches_plain_on_card(cuda, w, h, tile_h, covering, atlas):
    """K6 with its cull equals blend_plain bit for bit, whether or not its
    rows are 16-byte aligned; `kept` equals tile_slot_keep's row sums; a
    null `kept` changes nothing."""
    setup, lists, counts, big, atl, rgba, hdr, opaque = _cull_scene(
        21 + tile_h, w, h, 128, tile_h, covering)
    bounds = _cull_bounds(w, h) if atlas else ()
    args = [_to(a, cuda) for a in raster.blend_args(
        setup, rgba, lists, counts, big, opaque, hdr, w, h, 128, bounds,
        atl if atlas else None, tile_h)]
    kept = torch.full((counts.shape[0],), -7, dtype=torch.int32, device=cuda)
    kb = raster.blend_cuda(*args, kept=kept)
    kb0 = raster.blend_cuda(*args)
    pb = raster.blend_plain(*args)
    keep = raster.tile_slot_keep(*args[:4], w, h, 128, tile_h, bounds, "vertex")
    torch.cuda.synchronize()
    assert torch.equal(_bits(kb), _bits(pb)) and torch.equal(_bits(kb0), _bits(kb))
    assert torch.equal(kept, keep.sum(1).int())
    _check_kept_share(kept, args[1], args[3], covering, atlas)
    assert (kb.cpu() != hdr).any(-1).float().mean().item() > 0.05


@pytest.mark.parametrize("w,h", [(264, 72), (262, 70)], ids=["even", "odd"])
@pytest.mark.parametrize("tile_h", [16, 32, 128])
@pytest.mark.parametrize("covering", [False, True], ids=["most_miss", "none_miss"])
@pytest.mark.parametrize("atlas", [False, True], ids=["screen", "atlas_rects"])
def test_culled_depth_matches_plain_on_card(cuda, w, h, tile_h, covering, atlas):
    """K4 with its cull and early exit equals depth_dense_plain bit for bit;
    `kept` equals tile_slot_keep's row sums; a null `kept` changes
    nothing."""
    setup, lists, counts, big, atl, *_ = _cull_scene(31 + tile_h, w, h, 128, tile_h,
                                                     covering)
    bounds = _cull_bounds(w, h) if atlas else ()
    a = [_to(x, cuda) for x in raster.depth_args(
        setup, lists, counts, big, w, h, 128, bounds, atl if atlas else None,
        tile_h)["dense"]]
    kept = torch.full((counts.shape[0],), -7, dtype=torch.int32, device=cuda)
    kd = raster.depth_dense_cuda(*a, kept=kept)
    kd0 = raster.depth_dense_cuda(*a)
    pd = raster.depth_dense_plain(*a)
    keep = raster.tile_slot_keep(*a[:4], w, h, 128, tile_h, bounds, "edge")
    torch.cuda.synchronize()
    assert torch.equal(_bits(kd), _bits(pd)) and torch.equal(_bits(kd0), _bits(kd))
    assert torch.equal(kept, keep.sum(1).int())
    _check_kept_share(kept, a[1], a[3], covering, atlas)
    assert (kd > 0).float().mean().item() > 0.05


@pytest.mark.parametrize("w,h", [(264, 72), (262, 70)], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("tile_h", [16, 32])
@pytest.mark.parametrize("atlas", [False, True], ids=["screen", "atlas_rects"])
def test_culled_split_depth_matches_plain_on_card(cuda, w, h, tile_h, atlas):
    """K2 over 2x2-tile super-tile lists and K3 over active rows out of tile
    order, each with its cull and warp skip, equal depth_super_plain and
    depth_grid_plain bit for bit; `kept` equals the row sums of
    tile_slot_keep over their layouts (super_lists; tiles = act_ids); a
    null `kept` changes nothing."""
    setup, lists, counts, big, atl, *_ = _cull_scene(41 + tile_h, w, h, 128, tile_h,
                                                     False)
    tiles_x, tiles_y, n_tiles = raster._grid(w, h, 128, tile_h)
    sups_x = -(-tiles_x // 2)
    n_sup = sups_x * -(-tiles_y // 2)
    act = np.random.default_rng(tile_h).permutation(n_tiles)[:max(n_tiles // 2, 1)]
    act = torch.from_numpy(act.astype(np.int32))
    bounds = _cull_bounds(w, h) if atlas else ()
    a = raster.depth_args(setup, lists[act.long()], counts[act.long()], big[:0], w, h,
                          128, bounds, atl if atlas else None, tile_h,
                          sup_bins=(lists[:n_sup], counts[:n_sup], (2, 2, sups_x)),
                          act_ids=act)
    sup, grid = ([_to(x, cuda) for x in a[k]] for k in ("super", "grid"))
    kept2 = torch.full((n_tiles,), -7, dtype=torch.int32, device=cuda)
    kept3 = torch.full((act.numel(),), -7, dtype=torch.int32, device=cuda)
    k2 = raster.depth_super_cuda(*sup, kept=kept2)
    k2n = raster.depth_super_cuda(*sup)
    k3 = raster.depth_grid_cuda(k2.clone(), *grid, kept=kept3)
    k3n = raster.depth_grid_cuda(k2.clone(), *grid)
    p2 = raster.depth_super_plain(*sup)
    p3 = raster.depth_grid_plain(p2.clone(), *grid)
    none = grid[3][0, :0]
    keep2 = raster.tile_slot_keep(sup[0], *raster.super_lists(*sup[1:8]), none,
                                  *sup[4:9], "edge")
    keep3 = raster.tile_slot_keep(grid[0], grid[3], grid[2], none, *grid[5:10], "edge",
                                  grid[1])
    torch.cuda.synchronize()
    assert torch.equal(_bits(k2), _bits(p2)) and torch.equal(_bits(k2n), _bits(k2))
    assert torch.equal(_bits(k3), _bits(p3)) and torch.equal(_bits(k3n), _bits(k3))
    assert torch.equal(kept2, keep2.sum(1).int())
    assert torch.equal(kept3, keep3.sum(1).int())
    assert 0 < int(kept2.sum()) < int((raster.super_lists(*sup[1:8])[0] >= 0).sum())
    assert (k3 > k2).any() and (k2 > 0).any()


def test_grid_early_exit_after_a_culled_block_on_card(cuda):
    """K3 on active rows out of tile order (row 0 is tile 1, row 1 tile 0):
    row 1's block 0 covers tile 0 at depth 0.9, its block 1 holds only
    triangles inside tile 1 (zmax 0.95, culled for tile 0) and its block 2
    triangles at depth 0.5, so the exit fires after the block that the
    cull emptied. The kernel equals depth_grid_plain in every bit, with the
    exit and with a bound that never exits; `kept` is 16 and 17."""
    w, h = 256, 16
    tris = [(-300.0, -300.0, 900.0, 900.0, 0.9)]
    tris += [(140.0 + 6 * k, 2.0, 146.0 + 6 * k, 10.0, 0.95) for k in range(16)]
    tris += [(10.0 + 5 * k, 3.0, 14.0 + 5 * k, 9.0, 0.5) for k in range(16)]
    x0, y0, x1, y1, z = (np.array(c, np.float32) for c in zip(*tris))
    sx, sy = np.stack([x0, x0, x1]), np.stack([y0, y1, y0])
    area = np.abs((x1 - x0) * (y1 - y0))
    setup = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in {
        "sx": sx, "sy": sy, "z": np.stack([z, z, z]), "inv_area": 1.0 / area,
        "xmin": sx.min(0), "xmax": sx.max(0), "ymin": sy.min(0),
        "ymax": sy.max(0)}.items()}
    setup["valid"] = torch.ones(len(tris), dtype=torch.bool)
    lists = torch.full((2, 48), -1, dtype=torch.int32)
    lists[0, :16] = torch.arange(1, 17)
    lists[1, 0] = 0
    lists[1, 16:48] = torch.arange(1, 33)
    empty = torch.full((1, 16), -1, dtype=torch.int32)
    a = raster.depth_args(setup, lists, torch.tensor([16, 48], dtype=torch.int32),
                          lists[0, :0], w, h, 128, (), None, 16,
                          sup_bins=(empty, torch.zeros(1, dtype=torch.int32), (4, 1, 1)),
                          act_ids=torch.tensor([1, 0], dtype=torch.int32))["grid"]
    a = [_to(x, cuda) for x in a]
    for bnd in (a[4], torch.full_like(a[4], float("inf"))):
        args = a[:4] + [bnd] + a[5:]
        kept = torch.full((2,), -7, dtype=torch.int32, device=cuda)
        k3 = raster.depth_grid_cuda(torch.zeros(h, w, device=cuda), *args, kept=kept)
        p3 = raster.depth_grid_plain(torch.zeros(h, w, device=cuda), *args)
        torch.cuda.synchronize()
        assert torch.equal(_bits(k3), _bits(p3))
        assert kept.tolist() == [16, 17]
    assert (k3[:, :128] == 0.9).all()


def _shade_records(seed, n):
    rec = np.random.default_rng(seed).uniform(0, 1, (n, 36)).astype(np.float32)
    rec[:, 32:35] += 0.4
    return torch.from_numpy(rec)


def _compact_big(big):
    """The big list with its holes moved to the end, as binning leaves it."""
    return torch.cat([big[big >= 0], big[big < 0]])


@pytest.mark.parametrize("w,h", [(320, 200), (384, 256)], ids=["ragged", "whole"])
@pytest.mark.parametrize("tile,tile_h", [(128, 32), (64, 64)])
@pytest.mark.parametrize("lists", ["random", "binned_ties"])
def test_culled_raster_matches_plain_on_card(cuda, w, h, tile, tile_h, lists):
    """K1 and K5 with their cull equal their plain versions in every bit
    (tri_id, depth, b0, b1; K1's G-buffer within 2e-5), on lists that name
    triangles at random (most slots miss most tiles) and on binned lists of
    exactly tied triangles; `kept` equals tile_slot_keep's row sums over
    the kernels' band grid (`raster.band_args`); a null `kept` changes
    nothing."""
    if lists == "random":
        setup, tris, counts, big, *_ = _cull_scene(41 + tile_h, w, h, tile, tile_h,
                                                   False, n_big=32, cap=96)
        bins = (tris, counts, _compact_big(big))
    else:
        setup, _ = _scene(42, 60, w, h, True)
        bins = raster.bin_triangles(setup, w, h, tile, 96, max_big=32, tile_h=tile_h,
                                    foot=2, foot_y=2)
    rec = _shade_records(43, setup["valid"].shape[0])
    args = [_to(a, cuda) for a in raster.kernel_args(setup, rec, *bins, w, h, tile,
                                                     tile_h)]
    vargs = [_to(a, cuda) for a in raster.visibility_args(setup, *bins, w, h, tile,
                                                          tile_h)]
    band1, band5 = raster.band_args(args), raster.band_args(vargs)
    keep1 = raster.tile_slot_keep(band1[0], *band1[2:9], (), "edge")
    keep5 = raster.tile_slot_keep(*band5[:8], (), "edge")
    n_bands = keep1.shape[0]
    kept1 = torch.full((n_bands,), -7, dtype=torch.int32, device=cuda)
    kept5 = torch.full((n_bands,), -7, dtype=torch.int32, device=cuda)
    kvis, kg = raster.raster_shade_cuda(*args, kept=kept1)
    kvis0, kg0 = raster.raster_shade_cuda(*args)
    pvis, pg = raster.raster_shade_plain(*args)
    kv = raster.visibility_cuda(*vargs, kept=kept5)
    pv = raster.visibility_plain(*vargs)
    torch.cuda.synchronize()
    for k in ("tri_id", "depth", "b0", "b1"):
        assert torch.equal(_bits(kvis[k]), _bits(pvis[k])), k
        assert torch.equal(_bits(kvis0[k]), _bits(kvis[k])), k
        assert torch.equal(_bits(kv[k]), _bits(pv[k])), k
    assert (kg - pg).abs().max().item() <= 2e-5 and torch.equal(_bits(kg0), _bits(kg))
    assert torch.equal(kept1, keep1.sum(1).int())
    assert torch.equal(kept5, keep5.sum(1).int())
    named = int((band1[2] >= 0).sum()) + int((args[4] >= 0).sum()) * n_bands
    assert 0 < int(kept1.sum()) < named
    assert (kvis["tri_id"] >= 0).any()


@pytest.mark.parametrize("w,h", [(320, 200), (256, 256)], ids=["ragged", "whole"])
@pytest.mark.parametrize("tile", [128, 64])
def test_culled_oit_matches_plain_on_card(cuda, w, h, tile):
    """K7 with its per-band cull equals oit_plain in every bit on merged
    lists (64 big slots with holes, overflowing 32-slot tile lists);
    `kept` equals its cull's row sums over the band grid; a null `kept`
    changes nothing."""
    setup, rgba, _, opaque = _blend_scene(44, w, h)
    merged = raster.merge_big_list(*raster.bin_triangles(setup, w, h, tile, 32,
                                                         max_big=64))
    args = [_to(a, cuda) for a in oit.oit_args(setup, rgba, *merged, opaque, w, h,
                                               tile)]
    keep = raster.tile_slot_keep(*oit.cull_args(args))
    kept = torch.full((keep.shape[0],), -7, dtype=torch.int32, device=cuda)
    (ka, kr), (ka0, kr0) = oit.oit_cuda(*args, kept=kept), oit.oit_cuda(*args)
    pa, pr = oit.oit_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(_bits(ka), _bits(pa)) and torch.equal(_bits(kr), _bits(pr))
    assert torch.equal(_bits(ka0), _bits(ka)) and torch.equal(_bits(kr0), _bits(kr))
    assert torch.equal(kept, keep.sum(1).int())
    lists, counts = oit.band_lists(args[1], args[2], w, h, tile)
    assert 0 < int(kept.sum()) < int((lists >= 0).sum())
    assert (kr < 1).float().mean().item() > 0.2


# -- physics on the card -----------------------------------------------------------
#
# The physics step is plain PyTorch. Each pair family's manifolds on the
# card equal the CPU's to 1e-5 (reductions in another order), a normal
# built from two nearly coincident points to ULP_POS / their distance; a
# golden scene's curves to 1e-4 over its whole run, and the card repeats
# itself bit for bit.

_FAMILY_TYPES = [(1, 1), (1, 2), (1, 3), (1, 6), (2, 2), (2, 3), (2, 6), (3, 3), (3, 6),
                 (1, 4), (2, 4), (3, 4), (4, 4), (4, 6), (1, 7), (2, 7), (3, 7), (4, 7),
                 (1, 8), (2, 8), (3, 8), (4, 8), (1, 5), (2, 5), (3, 5), (4, 5), (5, 5),
                 (5, 6), (5, 7), (5, 8)]
_ULP_POS = 2.4e-7


@pytest.fixture(scope="module")
def contact_manifolds():
    """Every ordered pair of `scenes.contact_scene`, all kernels present,
    on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from garden_tpu_torch.physics import narrowphase as nph
    from garden_tpu_torch.physics import scenes
    from garden_tpu_torch.physics import shapes as tsh
    sc = scenes.contact_scene(tsh.ShapeTable)
    n = len(sc["stype"])
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    off = ii != jj
    pi, pj = ii[off].astype(np.int32), jj[off].astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.as_tensor(a, device=dev)
        out[dev] = nph.generate_contacts(
            t(sc["pos"]), t(sc["q"]), t(sc["stype"]), t(sc["params"]), t(pi), t(pj),
            torch.ones(len(pi), dtype=torch.bool, device=dev), margin=t(sc["margin"]),
            present_types=sc["table"].present_types(),
            tables=sc["table"].device_arrays(dev))
    return sc, {d: {k: v.cpu() for k, v in m.items()} for d, m in out.items()}


@pytest.mark.parametrize("family", _FAMILY_TYPES,
                         ids=[f"{SHAPE_NAMES[a]}-{SHAPE_NAMES[b]}" for a, b in _FAMILY_TYPES])
def test_pair_family_matches_cpu_on_card(contact_manifolds, family):
    sc, out = contact_manifolds
    g, c = out["cuda"], out["cpu"]
    assert torch.equal(g["a"], c["a"])
    st = torch.as_tensor(sc["stype"])
    prm = torch.as_tensor(sc["params"])
    a, b = c["a"].long(), c["b"].long()
    rows = (st[a] == family[0]) & (st[b] == family[1])
    v = c["valid"][rows]
    assert torch.equal(g["valid"][rows], v) and bool(v.any()), family
    for k in ("point", "pen"):
        assert float((g[k][rows] - c[k][rows]).abs()[v].max()) <= 1e-5, k
    rad = sum(torch.where((st[x] == 1) | (st[x] == 3), prm[x, 0], 0.0) for x in (a, b))
    sep = rad[rows][:, None] - c["pen"][rows]
    tol = torch.clamp(_ULP_POS / torch.clamp(sep, min=1e-9), min=1e-5)[..., None]
    assert bool(((g["normal"][rows] - c["normal"][rows]).abs() <= tol)[v].all())


def test_golden_pendulum_matches_cpu_on_card(cuda):
    """The joint scene (dense one-hot impulse sums, a 3x3 inverse per
    joint): the card's curves equal the CPU's to 1e-4 and repeat bit for
    bit; the analytic budget holds."""
    from garden_tpu_torch.physics import golden
    card = golden.simulate("pendulum", cuda)
    again = golden.simulate("pendulum", cuda)
    host = golden.simulate("pendulum", "cpu")
    golden.check("pendulum", card)
    for k in card:
        assert np.array_equal(card[k], again[k]), k
        np.testing.assert_allclose(card[k], host[k], rtol=0, atol=1e-4, err_msg=k)


def test_mixed_world_step_matches_cpu_on_card(cuda):
    """Every shape type, a joint and sleep: 5 steps on the card against the
    CPU within 1e-4, and the compacted branch with them."""
    from garden_tpu_torch.physics import scenes
    from garden_tpu_torch.physics import world as pw
    out = {}
    for dev in (cuda, "cpu"):
        st, cfg, types = scenes.mixed_world(dev)
        for _ in range(5):
            st = pw.step(st, cfg, 1.0 / 60.0, types)
        out[str(dev)] = st["bodies"]["pos"].cpu()
    assert torch.isfinite(out["cuda"]).all()
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-4


# The ultra and temporal passes (plain PyTorch, no hand kernel) on the card
# against the CPU. The card's division by a constant multiplies by the
# reciprocal, and its exp, sqrt and rsqrt may round another way by an ulp,
# so floor, hit and threshold decisions flip on a few samples: each is held
# to 1e-4 on >= 99% of its samples (SMAA, the pyramid and the hash: exact).

def _pass_frame(dev, w=128, h=96):
    """The G-buffer and depth of a glossy floor with five boxes, rendered
    on the CPU, moved to `dev`, with a seeded previous HDR and the camera."""
    from garden_tpu_torch.core import math3d as m3
    from garden_tpu_torch.core.config import RenderConfig
    from garden_tpu_torch.render import deferred, mesh
    from garden_tpu_torch.systems.camera import common_constants
    scene = mesh.SceneBuffers(2000, 2000, 8)
    floor = scene.add_material(mesh.Material(base_color=(0.6, 0.6, 0.6), roughness=0.05))
    box = scene.add_material(mesh.Material(base_color=(0.9, 0.2, 0.1), roughness=0.3))
    scene.add_instance(mesh.plane_grid(20.0, 4), material=floor)
    mats = torch.eye(4).repeat(8, 1, 1)
    for i, (x, z) in enumerate([(-2.0, 0.0), (0.0, -1.0), (2.0, 0.5), (-0.8, 1.5),
                                (1.2, -2.5)], start=1):
        scene.add_instance(mesh.cube(0.5), material=box)
        mats[i, :3, 3] = torch.tensor([x, 0.5, z])
    vec = lambda *c: torch.tensor(c)
    eye = vec(0.0, 3.0, 8.0)
    c = common_constants(eye, m3.look_at(eye, vec(0.0, 0.5, 0.0), vec(0.0, 1.0, 0.0)),
                         m3.perspective_reverse_z(1.0, w / h, 0.1, device="cpu"),
                         vec(0.4, -0.7, -0.5), (w, h), 0.0, 1.0 / 60.0)
    ren = deferred.DeferredRenderer(RenderConfig(width=w, height=h, max_triangles=2000,
                                                 max_vertices=2000, max_instances=8,
                                                 **SLICE_OVERRIDES), scene, "cpu")
    out = ren.render(ren.device_scene(), mats, c, ren.initial_frame_state())
    prev = torch.from_numpy(np.random.default_rng(3).uniform(0, 3, (h, w, 3))
                            .astype(np.float32))
    return {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in
            {"g": {k: v.to(dev) for k, v in out["gbuffer"].items()},
             "depth": out["depth"], "prev": prev,
             "c": {k: v.to(dev) for k, v in c.items()}}.items()}


def _close_share(card, host, tol=1e-4, share=0.99):
    d = (card.cpu().float() - host.float()).abs()
    assert bool(torch.isfinite(card).all())
    ok = (d <= tol).float().mean().item()
    assert ok >= share, (ok, d.max().item())


@pytest.mark.parametrize("trace_step", [1, 4])
def test_ssr_matches_cpu_on_card(cuda, trace_step):
    from garden_tpu_torch.core.config import SSRConfig
    from garden_tpu_torch.render import ssr
    out = {}
    for dev in (cuda, "cpu"):
        f = _pass_frame(dev)
        out[str(dev)] = ssr.trace(f["g"], f["depth"], f["prev"], f["c"]["view_proj"],
                                  f["c"], SSRConfig(trace_step=trace_step))
    for a, b in zip(out["cuda"], out["cpu"]):
        _close_share(a, b)
    assert float(out["cuda"][1].max()) > 0.5


@pytest.mark.parametrize("half_res", [True, False], ids=["half", "full"])
def test_ssgi_matches_cpu_on_card(cuda, half_res):
    from garden_tpu_torch.render import ssgi
    out = {}
    for dev in (cuda, "cpu"):
        f = _pass_frame(dev)
        g = f["g"]
        out[str(dev)] = ssgi.compute_ssgi(g["position"], g["normal"], g["visible"],
                                          f["depth"], f["prev"], f["c"]["view_proj"],
                                          half_res=half_res)
    _close_share(out["cuda"], out["cpu"])
    assert float(out["cuda"].max()) > 0.01


def test_noise_and_clouds_match_cpu_on_card(cuda):
    """The hash in every bit; Perlin-Worley, the cloud march over sky rays
    (10 steps) and the cloud shadow over a 20 km ground grid."""
    from garden_tpu_torch.ops import noise
    from garden_tpu_torch.render import clouds
    rng = np.random.default_rng(5)
    ij = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (3, 4096)).astype(np.int32))
    assert torch.equal(noise._hash(*ij.to(cuda), seed=9).cpu(), noise._hash(*ij, seed=9))
    xyz = torch.from_numpy(rng.uniform(-30, 30, (3, 64, 64)).astype(np.float32))
    _close_share(noise.perlin_worley3(*xyz.to(cuda), seed=2), noise.perlin_worley3(*xyz, seed=2))
    rays = torch.from_numpy(rng.normal(size=(32, 32, 3)).astype(np.float32))
    rays[..., 1] = rays[..., 1].abs() + 0.05
    ground = torch.from_numpy(rng.uniform(-1e4, 1e4, (32, 32, 3)).astype(np.float32))
    ground[..., 1] = 0.0
    sun, t = torch.tensor([0.4, 0.7, 0.5]), torch.tensor(2.0)
    out = {}
    for dev in (cuda, "cpu"):
        rgb, alpha = clouds.render_clouds(rays.to(dev), sun.to(dev), time=t.to(dev))
        out[str(dev)] = (rgb, alpha, clouds.cloud_shadow(ground.to(dev), sun.to(dev),
                                                         time=t.to(dev)))
    for a, b in zip(out["cuda"], out["cpu"]):
        _close_share(a, b)
    assert float(out["cuda"][1].max()) > 0.05 and float(out["cuda"][2].min()) < 1.0


def test_hiz_matches_cpu_on_card(cuda):
    from garden_tpu_torch.render import hiz
    f = _pass_frame("cpu")
    pyr = {str(dev): hiz.build_pyramid(f["depth"][:95].to(dev)) for dev in (cuda, "cpu")}
    for a, b in zip(pyr["cuda"], pyr["cpu"]):
        assert torch.equal(a.cpu(), b)
    rng = np.random.default_rng(6)
    c = torch.from_numpy(rng.uniform(-4, 4, (300, 3)).astype(np.float32))
    half = torch.from_numpy(rng.uniform(0.05, 1, (300, 3)).astype(np.float32))
    vp = f["c"]["view_proj"]
    occ = {str(dev): hiz.occlusion_cull((c - half).to(dev), (c + half).to(dev), vp.to(dev),
                                        pyr[str(dev)], 128, 95) for dev in (cuda, "cpu")}
    assert (occ["cuda"].cpu() == occ["cpu"]).float().mean().item() >= 0.99


def test_smaa_matches_cpu_on_card(cuda):
    from garden_tpu_torch.render import smaa
    img = torch.zeros(48, 48, 3)
    for y in range(48):
        img[y, : min(2 + y // 2, 48)] = 1.0
    rnd = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (40, 56, 3))
                           .astype(np.float32))
    for x in (img, rnd):
        assert float((smaa.apply_smaa(x.to(cuda)).cpu() - smaa.apply_smaa(x)).abs().max()) <= 1e-5


@pytest.mark.parametrize("pass_set", ["ultra", "temporal"])
def test_small_pass_set_steps_match_cpu(cuda, pass_set):
    """Two 32-body 256x128 steps (SSR, SSGI and Hi-Z read a real previous
    frame) on the card against the CPU: the image bar of the flagship."""
    from garden_tpu_torch.core.config import ShadowConfig
    from garden_tpu_torch.entry import TEMPORAL_OVERRIDES, ULTRA_OVERRIDES
    cut = dict(cascade_sizes=(256, 128, 128))
    over = (dict(ULTRA_OVERRIDES, shadow=ShadowConfig(map_size=2048, pcf_radius=2, **cut))
            if pass_set == "ultra" else
            dict(TEMPORAL_OVERRIDES, shadow=ShadowConfig(
                resolve_step=2, atlas_tile_h=16, atlas_foot_y=2, max_active_tiles=24, **cut)))
    out = {}
    for dev in ("cpu", cuda):
        step, state = build(32, 256, 128, grid_dim=8, cfg_overrides=over, device=dev)
        for _ in range(2):
            state, img = step(state)
        out[str(dev)] = (img.cpu(), state["physics"]["bodies"]["pos"].cpu())
    d = (out["cpu"][0].int() - out["cuda"][0].int()).abs().amax(-1)
    assert (d <= 2).float().mean().item() >= 0.995
    assert (out["cpu"][1] - out["cuda"][1]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("w,h", [(320, 200), (384, 256)], ids=["ragged", "whole"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_visibility_on_square_tiles_matches_plain_on_card(cuda, w, h, ties):
    """K5 as the forward renderer runs it (raster.render_pass): default
    slot binning into 128x128 tiles, 512 list slots and the 64-slot big
    list, 128x8 row bands; bit for bit against the plain version, its kept
    counts against tile_slot_keep over band_args, and render_pass on the
    card equal to render_pass on the CPU."""
    setup, _ = _scene(31, 400, w, h, ties)
    bins = raster.bin_triangles(setup, w, h, 128, 512)
    args = [_to(a, cuda) for a in raster.visibility_args(setup, *bins, w, h, 128)]
    keep = raster.tile_slot_keep(*raster.band_args(args)[:8], (), "edge")
    kept = torch.full((keep.shape[0],), -1, dtype=torch.int32, device=cuda)
    kv, pv = raster.visibility_cuda(*args, kept=kept), raster.visibility_plain(*args)
    torch.cuda.synchronize()
    for k in ("tri_id", "depth", "b0", "b1"):
        assert torch.equal(kv[k].view(torch.int32) if k != "tri_id" else kv[k],
                           pv[k].view(torch.int32) if k != "tri_id" else pv[k]), k
    assert torch.equal(kept, keep.sum(1).int())
    assert (kv["tri_id"] >= 0).float().mean().item() > 0.2
    clip = torch.tensor(np.random.default_rng(5).uniform(-1.2, 1.2, (600, 4)),
                        dtype=torch.float32)
    clip[:, 3] = clip[:, 3].abs() + 1.0
    idx = torch.tensor(np.random.default_rng(6).integers(0, 600, (400, 3)),
                       dtype=torch.int32)
    valid = torch.ones(400, dtype=torch.bool)
    before = cuda_build.launches["visibility"]
    gpu, _ = raster.render_pass(clip.to(cuda), idx.to(cuda), valid.to(cuda), w, h, 128, 512)
    assert cuda_build.launches["visibility"] == before + 1
    cpu, _ = raster.render_pass(clip, idx, valid, w, h, 128, 512)
    for k in cpu:
        assert torch.equal(gpu[k].cpu(), cpu[k]), k


@pytest.mark.parametrize("foot_y", [8, 4])
@pytest.mark.parametrize("max_active", [12, 40])
def test_split_depth_on_slot_lists_matches_plain_on_card(cuda, foot_y, max_active):
    """K2 and K3 on slot-binned lists (the cascades' y-footprint other than
    2 tiles, bin_triangles(max_active=)) against their plain versions bit
    for bit, with their kept counts against tile_slot_keep (K2 over
    super_lists, K3 per active row)."""
    w, h, th = 512, 256, 16
    setup, atl = _atlas_setup(17, w, h)
    setup = {k: v.to(cuda) for k, v in setup.items()}
    atl = torch.from_numpy(atl).to(cuda)
    bounds = ((0, 256, 0, 256), (256, 512, 0, 256))
    tiles, counts, big, act = raster.bin_triangles(
        setup, w, h, 128, 64, foot=2, tile_h=th, foot_y=foot_y, max_big=256,
        max_active=max_active)
    sup = raster.bin_big_supertiles(setup, big, w, h, 128, th, 4, 8, 64)
    s = raster.depth_args(setup, tiles, counts, big, w, h, 128, bounds, atl, th, sup,
                          max_active=max_active, act_ids=act)
    sa, ga = s["super"], s["grid"]
    keep2 = raster.tile_slot_keep(sa[0], *raster.super_lists(*sa[1:8]), sa[1][0, :0],
                                  *sa[4:9], "edge")
    keep3 = raster.tile_slot_keep(ga[0], ga[3], ga[2], ga[3][0, :0], *ga[5:10], "edge",
                                  ga[1])
    kept2 = torch.full((keep2.shape[0],), -1, dtype=torch.int32, device=cuda)
    kept3 = torch.full((keep3.shape[0],), -1, dtype=torch.int32, device=cuda)
    ks = raster.depth_super_cuda(*sa, kept=kept2)
    ps = raster.depth_super_plain(*sa)
    kg = raster.depth_grid_cuda(ks.clone(), *ga, kept=kept3)
    pg = raster.depth_grid_plain(ps.clone(), *ga)
    torch.cuda.synchronize()
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert torch.equal(kg.view(torch.int32), pg.view(torch.int32))
    assert torch.equal(kept2, keep2.sum(1).int()) and torch.equal(kept3, keep3.sum(1).int())
    assert (kg > 0).float().mean().item() > 0.05


def test_small_feature_and_bench_frames_match_cpu(cuda):
    """The feature frame (slot-binned cascades, textures, environment, HUD)
    and the bench frame (LOD spheres) at a few bodies and 256x128, one
    step on the card against the CPU: the image bar of the flagship."""
    from garden_tpu_torch.core.config import ShadowConfig
    from garden_tpu_torch.entry import build_bench_frame, build_feature_frame
    cut = ShadowConfig(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
                       atlas_foot_y=None, max_active_tiles=24)
    makers = (lambda dev: build_feature_frame(32, 256, 128, grid_dim=8,
                                              cfg_overrides=dict(shadow=cut), device=dev,
                                              env_height=16),
              lambda dev: build_bench_frame(64, 256, 128, cfg_overrides=dict(
                  shadow=ShadowConfig(**{**cut.__dict__, "atlas_foot_y": 2})), device=dev))
    for make in makers:
        out = {}
        for dev in ("cpu", cuda):
            step, state = make(dev)
            state, img = step(state)
            out[str(dev)] = (img.cpu(), state["physics"]["bodies"]["pos"].cpu())
        d = (out["cpu"][0].int() - out["cuda"][0].int()).abs().amax(-1)
        assert (d <= 2).float().mean().item() >= 0.995
        assert (out["cpu"][1] - out["cuda"][1]).abs().max().item() <= 1e-4


def _small_engine(dev):
    from garden_tpu_torch.core.config import ShadowConfig
    from garden_tpu_torch.entry import build_engine_frame
    cut = ShadowConfig(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
                       atlas_foot_y=2, max_active_tiles=24)
    return build_engine_frame(32, 256, 128, grid_dim=8, device=dev, n_characters=2,
                              n_animated=4, cfg_overrides=dict(shadow=cut))


def test_small_engine_matches_cpu(cuda):
    """The engine frame's runtime at 32 bodies, 2 characters and 4 animated
    entities, 30 ticks and one 256x128 frame on the card against the CPU:
    transforms within 1e-4, grounded flags, animation times, tick and time
    in every bit, the image bar of the flagship."""
    from garden_tpu_torch.entry import ENGINE_DT
    out = {}
    for dev in ("cpu", cuda):
        frame, state = _small_engine(dev)
        state = frame.engine.run_ticks(state, 30, ENGINE_DT)
        img = frame.render(frame.instance_matrices(state), state["frame"])["image"]
        out[str(dev)] = ({k: v.cpu() for k, v in state["components"]["transform"].items()},
                         state["components"]["character"]["grounded"].cpu(),
                         state["components"]["animation"]["time"].cpu(),
                         state["tick"].cpu(), state["time"].cpu(), img.cpu())
    cpu, card = out["cpu"], out["cuda"]
    for k in ("position", "rotation", "scale"):
        assert (cpu[0][k] - card[0][k]).abs().max().item() <= 1e-4, k
    for a, b in zip(cpu[1:5], card[1:5]):
        assert torch.equal(a, b)
    d = (cpu[5].int() - card[5].int()).abs().amax(-1)
    assert (d <= 2).float().mean().item() >= 0.995


def test_batched_cast_sphere_on_card(cuda):
    """The batched sphere cast on the card: each cast equal in every bit to
    the single call on the card, and to the CPU's within 1e-4."""
    from garden_tpu_torch.physics import queries, scenes
    rng = np.random.default_rng(5)
    e = 12
    args = (np.c_[rng.uniform(-5, 5, e), rng.uniform(0.3, 4, e), rng.uniform(-3, 3, e)],
            rng.normal(size=(e, 3)), rng.uniform(0.1, 0.5, e), rng.uniform(1, 10, e))
    hits = {}
    for dev in ("cpu", cuda):
        state, _, _ = scenes.mixed_world(dev)
        org, dirs, rad, dist = (torch.tensor(a, dtype=torch.float32, device=dev) for a in args)
        excl = torch.tensor(np.arange(e) % 9 - 1, dtype=torch.int32, device=dev)
        batched = queries.cast_sphere(state, org, dirs, rad, dist, excl)
        for i in range(e):
            one = queries.cast_sphere(state, org[i], dirs[i], float(rad[i]), float(dist[i]),
                                      int(excl[i]))
            for f in one._fields:
                assert torch.equal(getattr(batched, f)[i], getattr(one, f)), (dev, i, f)
        hits[str(dev)] = batched
    assert torch.equal(hits["cpu"].hit, hits["cuda"].hit.cpu())
    assert (hits["cpu"].distance - hits["cuda"].distance.cpu()).abs().max().item() <= 1e-4


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A small engine frame's state saved on the card loads back onto the
    card in every bit, and the next frame from it equals the next frame
    from the state that was saved."""
    from garden_tpu_torch.utils import checkpoint
    frame, state = _small_engine(cuda)
    state, _ = frame(frame(state)[0])
    checkpoint.save(str(tmp_path / "snap.npz"), state)
    loaded = checkpoint.load(str(tmp_path / "snap.npz"), state)
    pairs = list(zip(_tensor_leaves(state), _tensor_leaves(loaded)))
    assert pairs and all(b.is_cuda and torch.equal(a, b) for a, b in pairs)
    a, img_a = frame(state)
    b, img_b = frame(loaded)
    assert torch.equal(img_a, img_b)
    assert all(torch.equal(x, y) for x, y in zip(_tensor_leaves(a), _tensor_leaves(b)))


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensor_leaves(tree[k])]
    return [tree]


def test_world_batch_on_card(cuda):
    """Two worlds of the mixed world (every shape type, a joint, sleep)
    batched by WorldBatch on the card for 5 steps: each world equal in
    every bit to its own unbatched steps on the card, and to the CPU's
    batch within 1e-4 in position."""
    import warnings
    from garden_tpu_torch.parallel.worlds import WorldBatch
    from garden_tpu_torch.physics import scenes, world as pw

    def lift(s, i):
        b = s["bodies"]
        return dict(s, bodies=dict(b, pos=b["pos"] + 0.05 * i.float()))

    out = {}
    for dev in ("cpu", cuda):
        state, cfg, types = scenes.mixed_world(dev)
        step = lambda s: pw.step(s, cfg, 1.0 / 60.0, types)
        wb = WorldBatch(step, 2, devices=[dev])
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            (batched,) = wb.replicate(state, vary_fn=lift)
            for _ in range(5):
                (batched,) = wb.step([batched])
        out[str(dev)] = batched["bodies"]["pos"]
        if dev == cuda:
            for i in range(2):
                s = lift(state, torch.tensor(i, dtype=torch.int32, device=dev))
                for _ in range(5):
                    s = step(s)
                assert torch.equal(s["bodies"]["pos"], batched["bodies"]["pos"][i])
    assert (out["cpu"] - out["cuda"].cpu()).abs().max().item() <= 1e-4


def test_frame_tiles_on_card(cuda):
    """Two bands of a small flagship frame on the card stitch into the
    single renderer's image on the card off the seams (p99 <= 2 levels,
    mean < 0.5), with K1 once a band."""
    from garden_tpu_torch.core.config import ShadowConfig
    from garden_tpu_torch.parallel.frame_tiles import FrameTiles
    cut = ShadowConfig(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
                       atlas_foot_y=2, max_active_tiles=24)
    step, state = build(300, 256, 128, device=cuda, cfg_overrides=dict(shadow=cut))
    mats = step.instance_matrices(state["physics"])
    ref = step.render(mats, state["frame"])["image"].cpu().numpy().astype(int)
    ft = FrameTiles(step.renderer.config, step.renderer.scene_host, n_bands=2, overlap=16,
                    devices=[cuda] * 2)
    before = cuda_build.launches["raster_shade"]
    img, _ = ft.render(step.scene, mats, step.constants, ft.initial_state())
    assert cuda_build.launches["raster_shade"] - before == 2
    img = img.cpu().numpy().astype(int)
    assert img.shape == ref.shape
    seam = set(range(64 - 2, 64 + 2))
    rows = [r for r in range(128) if r not in seam]
    diff = np.abs(img[rows] - ref[rows])
    assert np.percentile(diff, 99) <= 2 and diff.mean() < 0.5


def _cards(n):
    """The first n visible cards, or a skip with the reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards, {torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("layout", ["one card", "two cards"])
def test_world_batch_shards_on_cards(layout):
    """Four worlds of the mixed world as two shards of two, on one card
    (cuda:0 twice) or on two cards, 5 steps: every leaf equal to the
    one-device batch's on cuda:0; the reduce within 1e-6 of it."""
    import warnings
    from garden_tpu_torch.parallel.worlds import WorldBatch
    from garden_tpu_torch.physics import scenes, world as pw
    cards = _cards(1 if layout == "one card" else 2)
    devices = cards * 2 if layout == "one card" else cards

    def lift(s, i):
        b = s["bodies"]
        return dict(s, bodies=dict(b, pos=b["pos"] + 0.05 * i.float()))

    state, cfg, types = scenes.mixed_world(cards[0])
    step = lambda s: pw.step(s, cfg, 1.0 / 60.0, types)
    out = {}
    for name, devs in (("one", [cards[0]]), ("sharded", devices)):
        wb = WorldBatch(step, 4, devices=devs)
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            batched = wb.replicate(state, vary_fn=lift)
            for _ in range(5):
                batched = wb.step(batched)
        y = wb.reduce(batched, lambda s: s["bodies"]["pos"][:, 1].mean())
        out[name] = (batched, y)
    (one,), y_one = out["one"]
    shards, y = out["sharded"]
    assert [s["bodies"]["pos"].device for s in shards] == devices
    for i, leaf in enumerate(_tensor_leaves(one)):
        got = torch.cat([_tensor_leaves(s)[i].to(cards[0]) for s in shards])
        assert torch.equal(got, leaf), i
    assert y.device == devices[0]
    assert abs(y.item() - y_one.item()) <= 1e-6 * abs(y_one.item())


def test_kernels_launch_on_their_tensors_card():
    """With cuda:0 current, K1 and K4 on tensors of cuda:1 run there and
    equal their plain versions there; a tiny combined step on each of two
    cards gives the same image bits."""
    from garden_tpu_torch import entry
    cards = _cards(2)
    torch.cuda.set_device(cards[0])
    w, h = 320, 200
    setup, rec = _scene(3, 60, w, h, False)
    bins = raster.bin_triangles(setup, w, h, 128, 96, max_big=32, tile_h=32, foot=2,
                                foot_y=2)
    to = lambda x: {k: v.to(cards[1]) for k, v in x.items()} if isinstance(x, dict) \
        else x.to(cards[1])
    args = raster.kernel_args(to(setup), to(rec), *[to(b) for b in bins], w, h, 128, 32)
    kvis, kg = raster.raster_shade_cuda(*args)
    pvis, pg = raster.raster_shade_plain(*args)
    assert kvis["tri_id"].device == cards[1]
    for k in ("tri_id", "depth", "b0", "b1"):
        assert torch.equal(kvis[k], pvis[k]), k
    assert (kg - pg).abs().max().item() <= 2e-5
    before = {k: cuda_build.launches[k] for k in ("raster_shade", "depth_dense")}
    states, images = entry.dryrun_multichip(2, devices=cards)
    assert {k: cuda_build.launches[k] - n for k, n in before.items()} == {
        "raster_shade": 2, "depth_dense": 2}
    assert images.device == cards[0] and torch.equal(images[0], images[1])
    assert states[1]["physics"]["bodies"]["pos"].device == cards[1]


def test_tracer_counts_syncs_and_its_counters_add_none_on_card(cuda):
    """On the card a root span counts host synchronizations into the
    innermost open span and restores the sync debug mode on exit; a traced
    physics step and binning count the same syncs with their counters as
    without (the counters add reductions, never a read-back); the
    recorder's times lie within RANGE_SLACK_NS of kineto's events (the
    replayed records, which open no range, aside)."""
    import statistics
    from torch.profiler import ProfilerActivity, profile
    from garden_tpu_torch import entry
    from garden_tpu_torch.utils import profiler
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    mode = torch.cuda.get_sync_debug_mode()
    with profile(activities=acts):
        with profiler.span("root"):
            x = torch.tensor([1.0, 2.0], device=cuda)            # a pageable copy
            with profiler.span("inner"):
                assert x.sum().item() == 3.0                      # a read-back
    root, inner = profiler.recorded()[-2:]
    assert (root["name"], root["counters"]["syncs"]) == ("root", 1)
    assert (inner["name"], inner["counters"]["syncs"]) == ("inner", 1)
    assert root["device"] == inner["device"] == torch.cuda.current_device()
    assert torch.cuda.get_sync_debug_mode() == mode

    world, pcfg, _ = entry.flagship_world(28, grid_dim=8)
    step = entry.CombinedStep(pcfg, world.shapes.present_types(), None, None, None, 28)
    state = world.device_state(cuda)
    for _ in range(8):
        state = step.physics(state)
    setup, _ = _scene(3, 60, 320, 200, False)
    setup = {k: v.to(cuda) for k, v in setup.items()}

    def traced(counting):
        with pytest.MonkeyPatch.context() as mp:
            if not counting:
                mp.setattr(profiler, "recording", lambda: False)
            first = profiler.RECORDER.next_step
            with profile(activities=acts) as prof:
                step.physics(state)
                with profiler.span("bin"):
                    raster.bin_triangles(setup, 320, 200, 128, 96, max_big=32,
                                         tile_h=32, foot=2, foot_y=2)
            torch.cuda.synchronize()
        return [s for s in profiler.recorded() if s["step"] >= first], prof

    with_counters, prof = traced(True)
    without, _ = traced(False)
    assert [s["name"] for s in with_counters] == [s["name"] for s in without]
    assert ([s["counters"]["syncs"] for s in with_counters]
            == [s["counters"]["syncs"] for s in without])
    phys, binned = with_counters[0], with_counters[-1]
    assert phys["name"] == "physics" and phys["counters"]["pair_slots"] > 0
    assert binned["name"] == "bin" and binned["counters"]["tile_pairs"] > 0
    kin = {e.name(): e for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU}
    edges = []
    for s in with_counters:
        if s["attrs"].get("replayed"):                    # no range of its own
            continue
        e = kin[s["name"]]
        edges += [abs(e.start_ns() - s["start_ns"]),
                  abs(e.start_ns() + e.duration_ns() - s["end_ns"])]
    assert statistics.median(edges) <= 20_000, edges
