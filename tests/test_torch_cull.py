"""The exact per-tile slot cull of the sorted_blend (K6) and depth_dense
(K4) kernels, on the CPU.

`raster.tile_slot_keep` marks the scanned slots whose triangle may reach a
pixel centre of the tile, from the kernels' own float expressions at one
corner centre of the tile (rounding is monotone, so each edge takes its
largest value over the tile there). The kernels walk only those slots, and
their `kept` output is the mask's row sums. These tests hold the plain
versions masked by it (`keep=`) equal, bit for bit, to the unmasked ones
in float32, on adversarial triangles (slivers and degenerate ones, edges
through pixel centres and tile corners, every sign of the edge slopes,
casters across cascade-rect borders, far and overflowing vertices), on a
list whose early exit fires after a block that the cull emptied, and on a
real glass frame at 256x128. Colours are finite and the destination holds
no -0.0, the cull's preconditions. On the glass inputs the mask must also
prune: fewer (slot, pixel) pairs than `chip_smoke.raster_work` counts.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from garden_tpu_torch.core.config import ShadowConfig
from garden_tpu_torch.entry import GLASS_BOXES, GLASS_OVERRIDES, build
from garden_tpu_torch.render import csm, raster

W, H = 264, 72                 # ragged: the last tile column and row are partial
BOUNDS = ((0.0, 128.0, 0.0, 48.0), (128.0, 264.0, 0.0, 32.0), (150.0, 230.0, 30.0, 72.0))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _named(lists, counts, big):
    """The (tile, slot) pairs a kernel would walk without the cull: each
    tile's used slots that name a triangle and the big list's triangles."""
    own = (torch.arange(lists.shape[1])[None, :] < counts[:, None]) & (lists >= 0)
    return int(own.sum()) + int((big >= 0).sum()) * lists.shape[0]


def _setup(sx, sy, z):
    """Setup of (3, T) screen-space corners; inv_area from the signed area
    (inf where it is 0), every triangle valid."""
    sx, sy = np.asarray(sx, np.float32), np.asarray(sy, np.float32)
    area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
    with np.errstate(divide="ignore"):
        inv_area = (1.0 / np.abs(area)).astype(np.float32)
    host = {"sx": sx, "sy": sy, "z": np.asarray(z, np.float32), "inv_area": inv_area,
            "xmin": sx.min(0), "xmax": sx.max(0), "ymin": sy.min(0), "ymax": sy.max(0)}
    setup = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
    setup["valid"] = torch.ones(sx.shape[1], dtype=torch.bool)
    return setup


def _slivers(rng, n):
    """Long thin triangles, exactly collinear ones and sub-pixel ones."""
    p0 = rng.uniform([-20, -10], [W + 20, H + 10], (n, 2))
    d = rng.uniform(-200, 200, (n, 2))
    off = rng.choice([0.0, 1e-6, 1e-4, 1e-2, 0.3, 3.0, 8.0], (n, 1)) * rng.choice([-1, 1], (n, 1))
    perp = np.stack([-d[:, 1], d[:, 0]], -1) / (np.linalg.norm(d, axis=1, keepdims=True)
                                                 + 1e-9)
    p1 = p0 + d
    p2 = p0 + rng.uniform(0.1, 0.9, (n, 1)) * d + off * perp
    tiny = rng.random(n) < 0.25                      # between four pixel centres
    p1[tiny] = p0[tiny] + rng.uniform(0.01, 0.4, (int(tiny.sum()), 2))
    p2[tiny] = p0[tiny] + rng.uniform(-0.4, 0.4, (int(tiny.sum()), 2))
    return np.stack([p0, p1, p2], 0)


def _centres(rng, n):
    """Vertices on pixel centres and on the corner centres of tiles, so
    that edges run exactly through them (axis-aligned and diagonal)."""
    xs = np.concatenate([np.arange(0, W + 128, 64) + 0.5, np.arange(63, W + 128, 64) + 0.5,
                         rng.integers(0, W, 8) + 0.5])
    ys = np.concatenate([np.arange(0, H + 32, 16) + 0.5, np.arange(15, H + 32, 16) + 0.5,
                         rng.integers(0, H, 8) + 0.5])
    p0 = np.stack([rng.choice(xs, n), rng.choice(ys, n)], -1)
    step = rng.choice([0.0, 1.0, 16.0, 63.0, 64.0, 127.0], (n, 2)) * rng.choice([-1, 1], (n, 2))
    p1 = p0 + np.where(rng.random((n, 1)) < 0.5, step * [1, 0], step)
    p2 = p0 + np.where(rng.random((n, 1)) < 0.5, step[:, ::-1] * [0, 1], -step[:, ::-1])
    return np.stack([p0, p1, p2], 0)


def _slopes(rng, n):
    """One triangle shape turned through every octant, both windings, so
    every sign combination of every edge's slope occurs."""
    ang = np.repeat(np.linspace(0, 2 * np.pi, 24, endpoint=False), -(-n // 24))[:n]
    c, s = np.cos(ang), np.sin(ang)
    shape = np.array([[0.0, 0.0], [70.0, 10.0], [20.0, 45.0]])
    flip = rng.random(n) < 0.5
    out = []
    for k in range(3):
        v = np.where(flip[:, None], shape[k] * [1, -1], shape[k])
        out.append(np.stack([c * v[:, 0] - s * v[:, 1], s * v[:, 0] + c * v[:, 1]], -1))
    centre = rng.uniform([-30, -30], [W + 30, H + 30], (n, 2))
    return np.stack(out, 0) + centre


def _rects(rng, n):
    """Casters across the cascade rects' borders."""
    bx = rng.choice([128.0, 150.0, 230.0, 264.0], n) + rng.uniform(-20, 20, n)
    by = rng.choice([30.0, 32.0, 48.0, 0.0], n) + rng.uniform(-10, 10, n)
    p0 = np.stack([bx, by], -1)
    return np.stack([p0, p0 + rng.uniform(-40, 40, (n, 2)),
                     p0 + rng.uniform(-40, 40, (n, 2))], 0)


def _far(rng, n):
    """Vertices far outside the frame, some large enough to overflow."""
    t = _slopes(rng, n)
    far = rng.random((3, n)) < 0.3
    t[far] *= rng.choice([1e4, 1e6, 1e20], int(far.sum()))[:, None]
    return t


CASES = {"slivers": _slivers, "centres": _centres, "slopes": _slopes,
         "rect_borders": _rects, "far": _far}


def _inputs(case, seed, n=120, tile=128, tile_h=16, n_big=48, cap=64):
    """A scene of `case` triangles and lists that name triangles whatever
    their bounds: the big list (a hole in it) and every tile's own list
    take triangles at random, so most slots miss most tiles."""
    rng = np.random.default_rng(seed)
    pts = CASES[case](rng, n)
    z = rng.uniform(0.05, 0.95, (3, n))
    setup = _setup(pts[..., 0], pts[..., 1], z)
    tiles_x, _, n_tiles = raster._grid(W, H, tile, tile_h)
    big = np.full(n_big, -1, np.int32)
    nb = rng.integers(n_big // 2, n_big)
    big[:nb] = rng.permutation(n)[:nb]
    big[nb // 2] = -1
    counts = rng.integers(0, cap + 1, n_tiles).astype(np.int32)
    lists = np.full((n_tiles, cap), -1, np.int32)
    for t in range(n_tiles):
        lists[t, :counts[t]] = rng.choice(n, counts[t], replace=False)
    # mostly the rect that holds the first corner, else any index (3: no rect)
    atlas = rng.integers(0, len(BOUNDS) + 1, n).astype(np.int32)
    for ci, (x0, x1, y0, y1) in reversed(list(enumerate(BOUNDS))):
        inside = ((pts[0, :, 0] >= x0) & (pts[0, :, 0] < x1) & (pts[0, :, 1] >= y0)
                  & (pts[0, :, 1] < y1) & (rng.random(n) < 0.85))
        atlas[inside] = ci
    return (setup, torch.from_numpy(big), torch.from_numpy(lists),
            torch.from_numpy(counts), torch.from_numpy(atlas), rng)


@pytest.mark.parametrize("rects", [False, True], ids=["screen", "atlas_rects"])
@pytest.mark.parametrize("case", list(CASES))
def test_blend_cull_is_exact(case, rects):
    """K6's vertex-form cull: the masked plain blend equals the unmasked one
    bit for bit, and the mask culls."""
    setup, big, lists, counts, atlas, rng = _inputs(case, 1)
    n = setup["valid"].shape[0]
    rgba = torch.tensor(rng.uniform(0.05, 0.95, (n, 4)), dtype=torch.float32)
    hdr = torch.tensor(rng.uniform(0.1, 2.0, (H, W, 3)), dtype=torch.float32)
    opaque = torch.tensor(rng.choice([0.0, 0.3, 0.6], (H, W)), dtype=torch.float32)
    bounds = BOUNDS if rects else ()
    args = raster.blend_args(setup, rgba, lists, counts, big, opaque, hdr, W, H, 128,
                             bounds, atlas if rects else None, 16)
    keep = raster.tile_slot_keep(args[0], *args[1:4], W, H, 128, 16, bounds, "vertex")
    ref = raster.blend_plain(*args)
    assert torch.equal(_bits(raster.blend_plain(*args, keep=keep)), _bits(ref))
    assert (ref != hdr).any()                         # something blended
    assert 0 < int(keep.sum()) < _named(*args[1:4])


@pytest.mark.parametrize("rects", [False, True], ids=["screen", "atlas_rects"])
@pytest.mark.parametrize("case", list(CASES))
def test_depth_cull_is_exact(case, rects):
    """K4's edge-form cull: the masked plain dense depth raster, early exit
    included, equals the unmasked one bit for bit, and the mask culls."""
    setup, big, lists, counts, atlas, _ = _inputs(case, 2)
    bounds = BOUNDS if rects else ()
    a = raster.depth_args(setup, lists, counts, big, W, H, 128, bounds,
                          atlas if rects else None, 16)["dense"]
    keep = raster.tile_slot_keep(a[0], *a[1:4], W, H, 128, 16, bounds, "edge")
    ref = raster.depth_dense_plain(*a)
    out = raster.depth_dense_plain(*a, keep=keep)
    assert torch.equal(_bits(out), _bits(ref))
    assert (ref > 0).any()
    assert 0 < int(keep.sum()) < _named(*a[1:4])


@pytest.mark.parametrize("tile,tile_h", [(128, 32), (64, 64)])
def test_cull_is_exact_at_other_tile_shapes(tile, tile_h):
    """Both forms at the main view's 128x32 tiles and a square tile."""
    setup, big, lists, counts, atlas, rng = _inputs("slopes", 3, tile=tile,
                                                   tile_h=tile_h, cap=32)
    n = setup["valid"].shape[0]
    rgba = torch.tensor(rng.uniform(0.05, 0.95, (n, 4)), dtype=torch.float32)
    hdr = torch.tensor(rng.uniform(0.1, 2.0, (H, W, 3)), dtype=torch.float32)
    opaque = torch.zeros((H, W))
    b = raster.blend_args(setup, rgba, lists, counts, big, opaque, hdr, W, H, tile,
                          (), None, tile_h)
    kv = raster.tile_slot_keep(b[0], *b[1:4], W, H, tile, tile_h, (), "vertex")
    assert torch.equal(_bits(raster.blend_plain(*b, keep=kv)),
                       _bits(raster.blend_plain(*b)))
    d = raster.depth_args(setup, lists, counts, big, W, H, tile, (), None, tile_h)["dense"]
    ke = raster.tile_slot_keep(d[0], *d[1:4], W, H, tile, tile_h, (), "edge")
    assert torch.equal(_bits(raster.depth_dense_plain(*d, keep=ke)),
                       _bits(raster.depth_dense_plain(*d)))
    assert int(kv.sum()) < _named(*b[1:4]) and int(ke.sum()) < _named(*d[1:4])


def _flat(x0, y0, x1, y1, z):
    """A front-facing right triangle with constant depth z, as (3,) lists."""
    return [x0, x0, x1], [y0, y1, y0], [z, z, z]


def test_early_exit_after_a_culled_block():
    """Tile 0's list: block 0 covers the whole tile at depth 0.9; block 1
    holds only triangles inside tile 1 (culled for tile 0) with zmax 0.95,
    so the exit cannot fire after block 0 but fires after block 1, the
    block the cull emptied; block 2 (depth 0.5 inside tile 0) is skipped.
    The masked raster keeps that exit and equals the unmasked one."""
    w, h = 256, 16
    tris = [_flat(-300.0, -300.0, 900.0, 900.0, 0.9)]
    tris += [_flat(140.0 + 6 * k, 2.0, 146.0 + 6 * k, 10.0, 0.95) for k in range(16)]
    tris += [_flat(10.0 + 5 * k, 3.0, 14.0 + 5 * k, 9.0, 0.5) for k in range(16)]
    sx, sy, z = (np.array([t[i] for t in tris]).T for i in range(3))
    setup = _setup(sx, sy, z)
    lists = torch.full((2, 48), -1, dtype=torch.int32)
    lists[0, 0] = 0
    lists[0, 16:48] = torch.arange(1, 33)
    lists[1, :16] = torch.arange(1, 17)
    counts = torch.tensor([48, 16], dtype=torch.int32)
    big = torch.full((16,), -1, dtype=torch.int32)
    a = raster.depth_args(setup, lists, counts, big, w, h, 128, (), None, 16)["dense"]
    keep = raster.tile_slot_keep(a[0], *a[1:4], w, h, 128, 16, (), "edge")
    assert not keep[0, 16 + 16:16 + 32].any()          # block 1 of tile 0 culled
    assert keep[0, 16 + 32:].all() and keep[0, 16]      # blocks 0 and 2 kept
    never = torch.full_like(a[4], float("inf"))         # a bound that never exits
    works = {}
    for name, bnd in (("exit", a[4]), ("never", never)):
        args = a[:4] + (bnd,) + a[5:]
        ref, w_ref, w_keep = raster.depth_dense_plain(*args), [0], [0]
        raster.depth_dense_plain(*args, work=w_ref)
        out = raster.depth_dense_plain(*args, work=w_keep, keep=keep)
        assert torch.equal(_bits(out), _bits(ref)), name
        works[name] = w_keep[0]
    # the exit skipped block 2's 16 kept slots on tile 0's 128x16 pixels
    assert works["never"] - works["exit"] == 16 * 128 * 16


@pytest.fixture(scope="module")
def glass():
    """The kernels' inputs on one small glass frame on the CPU: the sorted
    pass and the translucent atlas tint (K6), the translucent atlas and
    trans-depth (K4)."""
    shadow = ShadowConfig(resolve_step=2, cascade_sizes=(256, 128, 128),
                          atlas_tile_h=16, atlas_foot_y=2, max_active_tiles=24)
    step, state = build(32, 256, 128, grid_dim=8, box_materials=GLASS_BOXES,
                        cfg_overrides=dict(GLASS_OVERRIDES, shadow=shadow), device="cpu")
    rend, scene, const = step.renderer, step.scene, step.constants
    mats = step.instance_matrices(step.physics(state["physics"]))
    geo, vis, g = rend.gbuffer_pass(scene, mats, const)
    light, splits = rend.shadow_light(const)
    atlas, _ = rend.shadow_atlas(scene, geo["planes"], light)
    shadow_f = rend.shadow_factor(g, const, atlas, light, splits)
    hdr = rend.shade(g, const, shadow_f, rend.ambient_occlusion(g, const))
    _, tkw = rend.cascade_inputs(scene, geo["planes"], light)
    return {
        "sorted": ("vertex", raster.blend_args(**rend.sorted_inputs(
            scene, geo, const, vis["depth"], hdr))),
        "atlas_tint": ("vertex", raster.blend_args(**csm.translucent_tint_inputs(
            tkw, rend.caster_tint(scene), atlas))),
        "atlas_depth": ("edge", raster.depth_args(**tkw)["dense"]),
        "trans_depth": ("edge", raster.depth_args(**rend.trans_depth_inputs(
            scene, geo, const))["dense"]),
    }


def _shape_args(form, a):
    """(width, height, tile, tile_h, atlas_bounds) of blend or depth args."""
    return a[6:11] if form == "vertex" else a[5:10]


@pytest.mark.parametrize("shape", ["sorted", "atlas_tint", "atlas_depth", "trans_depth"])
def test_cull_on_a_glass_frame(glass, shape):
    form, a = glass[shape]
    plain = raster.blend_plain if form == "vertex" else raster.depth_dense_plain
    keep = raster.tile_slot_keep(*a[:4], *_shape_args(form, a), form)
    assert torch.equal(_bits(plain(*a, keep=keep)), _bits(plain(*a)))


def test_cull_prunes_the_glass_frame(glass):
    """Fewer (slot, pixel) pairs survive than `chip_smoke.raster_work`
    counts, so the kernels' new bound counts less work: the screen passes
    lose a few own-list slots whose bounds, not edges, reach a tile (this
    small frame's atlas has no big caster, so there it keeps every slot)."""
    kept, full = {}, {}
    for shape, (form, a) in glass.items():
        w, h, tile, th, bounds = _shape_args(form, a)
        keep = raster.tile_slot_keep(*a[:4], w, h, tile, th, bounds, form)
        kept[shape] = chip_smoke.kept_pairs(keep, w, h, tile, th)
        full[shape] = chip_smoke.raster_work(a[1], a[2], a[3], w, h, tile, th)[0]
        assert 0 < kept[shape] <= full[shape], shape
    assert kept["sorted"] < full["sorted"] and kept["trans_depth"] < full["trans_depth"]
