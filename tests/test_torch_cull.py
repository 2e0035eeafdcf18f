"""The exact per-tile slot cull of the sorted_blend (K6), depth_dense
(K4), depth_super (K2), depth_grid (K3), raster_shade (K1), visibility
(K5) and OIT (K7, per row band) kernels, on the CPU.

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

K1 and K5 keep the first of equal depths in the bit-reversed scan order;
their tests add exact ties across a culled slot of the same 16-slot block
and edges exactly 0 at a tile's corner centre, and check that the slots K1
scans are those tile_slot_keep scans. Their kernels cull per row band
(`raster.band_args`): the plain rasters on that band grid, masked, equal
the unmasked ones on the tiles. K7's cull works on the OIT kernel's
band grid (`oit.band_keep`): its tests add big-list holes and big triangles
that each lie in a few rows, so most of a tile's bands cull them. K2 culls
each tile's super-tile list (`raster.super_lists`), K3 each active row's
list against the tile that `act_ids` names (`tile_slot_keep(...,
tiles=)`): their tests draw the active rows out of tile order, and add an
early exit after a block that the cull emptied for that row's tile only.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import numpy as np
import pytest
import torch

import chip_smoke
from garden_tpu_torch.core.config import ShadowConfig
from garden_tpu_torch.entry import GLASS_BOXES, GLASS_OVERRIDES, build
from garden_tpu_torch.render import csm, oit, raster

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


def _inputs(case, seed, n=120, tile=128, tile_h=16, n_big=48, cap=64,
            compact_big=False):
    """A scene of `case` triangles and lists that name triangles whatever
    their bounds: the big list (a hole in it, moved to the end with
    `compact_big`, as binning leaves it) and every tile's own list take
    triangles at random, so most slots miss most tiles."""
    rng = np.random.default_rng(seed)
    pts = CASES[case](rng, n)
    z = rng.uniform(0.05, 0.95, (3, n))
    setup = _setup(pts[..., 0], pts[..., 1], z)
    tiles_x, _, n_tiles = raster._grid(W, H, tile, tile_h)
    big = np.full(n_big, -1, np.int32)
    nb = rng.integers(n_big // 2, n_big)
    big[:nb] = rng.permutation(n)[:nb]
    big[nb // 2] = -1
    if compact_big:
        big = np.concatenate([big[big >= 0], big[big < 0]])
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
    included, equals the unmasked one bit for bit, and the mask culls; so
    does the CPU path that walks only the kept pairs (depth_dense_culled)."""
    setup, big, lists, counts, atlas, _ = _inputs(case, 2)
    bounds = BOUNDS if rects else ()
    a = raster.depth_args(setup, lists, counts, big, W, H, 128, bounds,
                          atlas if rects else None, 16)["dense"]
    keep = raster.tile_slot_keep(a[0], *a[1:4], W, H, 128, 16, bounds, "edge")
    ref = raster.depth_dense_plain(*a)
    out = raster.depth_dense_plain(*a, keep=keep)
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(raster.depth_dense_culled(*a)), _bits(ref))
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
        assert torch.equal(_bits(raster.depth_dense_culled(*args)), _bits(ref)), name
        works[name] = w_keep[0]
    # the exit skipped block 2's 16 kept slots on tile 0's 128x16 pixels
    assert works["never"] - works["exit"] == 16 * 128 * 16


# -- K2 and K3: the split atlas raster, super-tile lists and active rows -----

def _split_args(case, seed, rects, n_act=10):
    """depth_super's and depth_grid's arguments on a `case` scene: 2x2-tile
    super-tiles whose lists name triangles at random, and `n_act` active
    rows for tiles drawn out of tile order, each with a random list."""
    setup, _, lists, counts, atlas, rng = _inputs(case, seed)
    tiles_x, tiles_y, n_tiles = raster._grid(W, H, 128, 16)
    sups_x = -(-tiles_x // 2)
    n_sup = sups_x * -(-tiles_y // 2)
    act = torch.from_numpy(rng.permutation(n_tiles)[:n_act].astype(np.int32))
    bounds = BOUNDS if rects else ()
    a = raster.depth_args(setup, lists[:n_act], counts[:n_act], lists[0, :0], W, H, 128,
                          bounds, atlas if rects else None, 16,
                          sup_bins=(lists[-n_sup:], counts[-n_sup:], (2, 2, sups_x)),
                          act_ids=act)
    return a["super"], a["grid"]


@pytest.mark.parametrize("rects", [False, True], ids=["screen", "atlas_rects"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_depth_cull_is_exact(case, rects):
    """K2's cull over each tile's super-tile list and K3's over its active
    rows (corners of tile act_ids[i]): the masked plain versions equal the
    unmasked ones bit for bit, K3's early exit included, and each mask
    culls."""
    sup, grid = _split_args(case, 6, rects)
    ca2, ca3 = chip_smoke.cull_args(sup, "super"), chip_smoke.cull_args(grid, "grid")
    keep2, keep3 = raster.tile_slot_keep(*ca2), raster.tile_slot_keep(*ca3)
    ref2 = raster.depth_super_plain(*sup)
    assert torch.equal(_bits(raster.depth_super_plain(*sup, keep=keep2)), _bits(ref2))
    ref3 = raster.depth_grid_plain(ref2.clone(), *grid)
    out3 = raster.depth_grid_plain(ref2.clone(), *grid, keep=keep3)
    assert torch.equal(_bits(out3), _bits(ref3))
    assert (ref3 > ref2).any()
    for keep, ca in ((keep2, ca2), (keep3, ca3)):
        assert 0 < int(keep.sum()) < _named(*ca[1:4])


def test_grid_early_exit_after_a_culled_block():
    """K3's early exit after a block that the cull emptied, on active rows
    out of tile order: row 0 is tile 1, row 1 tile 0. Row 1's list is that
    of test_early_exit_after_a_culled_block (block 1 holds only triangles
    inside tile 1), so its mask culls block 1 with tile 0's corners, which
    tile 1's would keep; the masked raster keeps the exit after block 1 and
    equals the unmasked one."""
    w, h = 256, 16
    tris = [_flat(-300.0, -300.0, 900.0, 900.0, 0.9)]
    tris += [_flat(140.0 + 6 * k, 2.0, 146.0 + 6 * k, 10.0, 0.95) for k in range(16)]
    tris += [_flat(10.0 + 5 * k, 3.0, 14.0 + 5 * k, 9.0, 0.5) for k in range(16)]
    sx, sy, z = (np.array([t[i] for t in tris]).T for i in range(3))
    setup = _setup(sx, sy, z)
    lists = torch.full((2, 48), -1, dtype=torch.int32)
    lists[0, :16] = torch.arange(1, 17)
    lists[1, 0] = 0
    lists[1, 16:48] = torch.arange(1, 33)
    counts = torch.tensor([16, 48], dtype=torch.int32)
    act = torch.tensor([1, 0], dtype=torch.int32)
    empty = torch.full((1, 16), -1, dtype=torch.int32)
    a = raster.depth_args(setup, lists, counts, lists[0, :0], w, h, 128, (), None, 16,
                          sup_bins=(empty, torch.zeros(1, dtype=torch.int32), (4, 1, 1)),
                          act_ids=act)["grid"]
    ca = chip_smoke.cull_args(a, "grid")
    keep = raster.tile_slot_keep(*ca)
    assert keep[0, :16].all() and keep[1, 0] and keep[1, 32:48].all()
    assert not keep[1, 16:32].any()                     # block 1 culled for tile 0
    assert raster.tile_slot_keep(*ca[:10])[1, 16:32].all()   # tile 1's corners keep it
    never = torch.full_like(a[4], float("inf"))
    works = {}
    for name, bnd in (("exit", a[4]), ("never", never)):
        args = a[:4] + (bnd,) + a[5:]
        ref = raster.depth_grid_plain(torch.zeros(h, w), *args)
        w_keep = [0]
        out = raster.depth_grid_plain(torch.zeros(h, w), *args, work=w_keep, keep=keep)
        assert torch.equal(_bits(out), _bits(ref)), name
        works[name] = w_keep[0]
    # the exit skipped block 2's 16 kept slots on tile 0's 128x16 pixels
    assert works["never"] - works["exit"] == 16 * 128 * 16


def _warp_of_pixels(tile, tile_h):
    """The warp of the depth kernels' 256-thread block that holds each
    pixel of a tile, row-major: a thread holds one column and every
    (256 / tile)-th row of it."""
    pix = torch.arange(tile * tile_h)
    row, col = pix // tile, pix % tile
    return ((row % (raster.DEPTH_THREADS // tile)) * tile + col) // 32


@pytest.mark.parametrize("tile,tile_h", [(128, 16), (128, 32), (64, 64), (16, 64)])
def test_warp_corners_bound_each_warps_pixels(tile, tile_h):
    """_warp_corners, the twin of the kernels' warp_corners, is the bounding
    rect of the pixel centres that each warp holds, for wide tiles (a
    warp's lanes in one row) and narrow ones (16 columns: two rows)."""
    tiles = torch.tensor([0, 5, 3])
    px, py = raster._tile_coords(tiles, 4, tile, tile_h)
    warp = _warp_of_pixels(tile, tile_h)
    got = raster._warp_corners(tiles, 4, tile, tile_h)
    for w in range(raster.DEPTH_WARPS):
        x, y = px[:, warp == w], py[:, warp == w]
        want = (x.amin(1), x.amax(1), y.amin(1), y.amax(1))
        for g, v in zip(got, want):
            assert torch.equal(g.reshape(3, -1)[:, w], v), w


@pytest.mark.parametrize("rects", [False, True], ids=["screen", "atlas_rects"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_warp_cull_is_exact(case, rects):
    """K2's and K3's second cull (raster.warp_keep, the twin of their
    mark_warps): every (slot, warp) pair with a pixel inside the triangle
    and its rect survives it, it keeps no more than the tile cull, and it
    culls some of that; the plain versions' counts of the pairs the two
    culls leave agree with it."""
    sup, grid = _split_args(case, 6, rects)
    warp = _warp_of_pixels(128, 16)
    for args, kind, plain in ((sup, "super", raster.depth_super_plain),
                              (grid, "grid", raster.depth_grid_plain)):
        ca = chip_smoke.cull_args(args, kind)
        keep, warps = raster.tile_slot_keep(*ca), chip_smoke.split_warps(ca)
        assert not (warps & ~keep[:, None, :]).any()
        assert 0 < int((warps & keep[:, None, :]).sum()) < raster.DEPTH_WARPS * int(keep.sum())
        tiles = ca[10].long() if kind == "grid" else torch.arange(keep.shape[0])
        px, py = raster._tile_coords(tiles, raster._grid(W, H, 128, 16)[0], 128, 16)
        ids = ca[1].long()
        d = args[0][torch.where(ids >= 0, ids, args[0].shape[0] - 1)][..., None]
        _, inside = raster._depth_candidates(d, px[:, None, :], py[:, None, :], ca[8])
        inside = inside & keep[..., None]                   # (rows, cap, pixels)
        on_warp = torch.stack([inside[..., warp == w].any(-1)
                               for w in range(raster.DEPTH_WARPS)], 1)
        assert on_warp.any() and not (on_warp & ~warps).any()
        tiles_x, tiles_y, _ = raster._grid(W, H, 128, 16)
        image = lambda: torch.zeros(tiles_y * 16, tiles_x * 128)   # the padded atlas
        work, prior = [0] * 4, ((image(),) if kind == "grid" else ())
        plain(*prior, *args, work=work, keep=keep, warps=warps)
        never = [0] * 4                                     # no early exit
        if kind == "grid":
            a = args[:4] + (torch.full_like(args[4], float("inf")),) + args[5:]
            plain(image(), *a, work=never, keep=keep, warps=warps)
        else:
            never = work
        assert never[1] == int((warps & keep[:, None, :]).sum()) * 16 * 128 // 8
        assert never[3] == int(inside.sum())
        assert work[3] <= work[1] <= work[0] and work[2] <= work[1]
        assert (work[2] > 0) == bool(rects)


def test_supertile_counts_are_the_lists_before_the_cap():
    """raster.supertile_counts gives each super-tile's casters before the
    cap: bin_big_supertiles' counts are them capped, and its lists are the
    uncapped lists' first slots."""
    setup, big, *_ = _inputs("slopes", 7, n_big=48)
    args = (setup, big, W, H, 128, 16, 1, 2)
    full = raster.supertile_counts(*args)
    tris, counts, _ = raster.bin_big_supertiles(*args, cap=4)
    wide, _, _ = raster.bin_big_supertiles(*args, cap=64)
    assert torch.equal(counts.long(), full.clamp(max=4))
    assert 4 < int(full.max()) <= 64
    assert torch.equal(tris, wide[:, :4])


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


# -- K1 and K5: the nearest-hit raster, edge form, bit-reversed tie order ----

def _raster_args(kernel, setup, lists, counts, big, w, h, tile, tile_h, seed=0):
    """(arguments of the plain version, tile_slot_keep's mask) of
    raster_shade (K1) or visibility (K5)."""
    if kernel == "shade":
        n = setup["valid"].shape[0]
        rec = np.random.default_rng(seed).uniform(0, 1, (n, 36)).astype(np.float32)
        rec[:, 32:35] += 0.4
        a = raster.kernel_args(setup, torch.from_numpy(rec), lists, counts, big, w, h,
                               tile, tile_h)
        return a, raster.tile_slot_keep(a[0], *a[2:9], (), "edge")
    a = raster.visibility_args(setup, lists, counts, big, w, h, tile, tile_h)
    return a, raster.tile_slot_keep(*a[:8], (), "edge")


def _raster_plain(kernel, a, keep=None):
    """The plain version's outputs as one dict."""
    if kernel == "shade":
        vis, planes = raster.raster_shade_plain(*a, keep=keep)
        return dict(vis, planes=planes)
    return raster.visibility_plain(*a, keep=keep)


def _assert_same_bits(out, ref):
    assert out.keys() == ref.keys()
    for k in ref:
        assert torch.equal(_bits(out[k]), _bits(ref[k])), k


@pytest.mark.parametrize("kernel", ["shade", "visibility"])
@pytest.mark.parametrize("case", list(CASES))
def test_raster_cull_is_exact(case, kernel):
    """K1's and K5's edge-form cull: the masked plain raster equals the
    unmasked one bit for bit (tri_id, depth, barycentrics and K1's
    G-buffer planes), and the mask culls."""
    setup, big, lists, counts, _, _ = _inputs(case, 4, tile_h=32, n_big=32, cap=96,
                                              compact_big=True)
    a, keep = _raster_args(kernel, setup, lists, counts, big, W, H, 128, 32)
    ref = _raster_plain(kernel, a)
    _assert_same_bits(_raster_plain(kernel, a, keep), ref)
    assert (ref["tri_id"] >= 0).any()
    assert 0 < int(keep.sum()) < _named(lists, counts, big)


def _square_halves(x0, y0, side, z):
    """The two front-facing halves of an axis-aligned square with corners
    on pixel centres, at one depth: their shared diagonal runs through
    pixel centres, where both edges are exactly 0 and the depths tie."""
    x1, y1 = x0 + side, y0 + side
    return [([x0, x0, x1], [y0, y1, y0], [z] * 3),
            ([x1, x1, x0], [y1, y0, y1], [z] * 3)]


@pytest.mark.parametrize("kernel", ["shade", "visibility"])
@pytest.mark.parametrize("order", ["culled_between", "culled_first"])
def test_raster_cull_keeps_ties_and_corner_edges(kernel, order):
    """Tile 0 (128x32 at the origin) lists, in one 16-slot block: the two
    coplanar halves of a square (the cube face's diagonal: exact depth ties
    on its pixel centres), duplicates of one half (ties on every pixel),
    and triangles inside tile 1, which the cull removes for tile 0, at the
    ranks between the halves (or before both). Another triangle has a
    vertex on tile 0's corner centre (127.5, 31.5) and edges through it, so
    its largest edge over tile 0 is exactly 0 and it keeps that one pixel.
    The masked raster equals the unmasked one in every bit."""
    a, keep, slots, n_big = _tie_scene(kernel, order)
    culled = [s for s, t in slots.items() if 2 <= t <= 5]
    assert not keep[0, [n_big + s for s in culled]].any()
    assert keep[0, [n_big + s for s, t in slots.items() if t in (0, 1, 6)]].all()
    ref = _raster_plain(kernel, a)
    _assert_same_bits(_raster_plain(kernel, a, keep), ref)
    tri = ref["tri_id"]
    diag = [(34 - k, 10 + k) for k in range(1, 31)]                  # (row, col)
    assert all(int(tri[r, c]) in (0, 1) for r, c in diag if r < 32)
    assert int(tri[31, 127]) == 6                                    # the corner pixel
    assert int(tri[31, 126]) == -1 and int(tri[30, 127]) == -1


def _tie_scene(kernel, order):
    """The scene of test_raster_cull_keeps_ties_and_corner_edges at 256x64
    -> (plain version's arguments, tile_slot_keep's mask, {slot: triangle}
    of tile 0's list, big-list slots)."""
    w, h = 256, 64
    tris = _square_halves(10.5, 2.5, 32.0, 0.5)                     # 0, 1
    # 2-5 inside tile 1, their edge e1 on x = 130.5 + 8k (the edge form
    # bounds e2 only loosely, so the separating edge is e1)
    tris += [([130.5 + 8 * k, 136.5 + 8 * k, 130.5 + 8 * k], [9.5, 3.5, 3.5],
              [0.9] * 3) for k in range(4)]
    tris += [([127.5, 127.5, 200.5], [31.5, 80.5, 31.5], [0.7] * 3)]  # 6: corner
    sx, sy, z = (np.array([t[i] for t in tris], np.float64).T for i in range(3))
    setup = _setup(sx, sy, z)
    # ranks of the block's slots: 0 -> slot 0, 1 -> 8, 2 -> 4, 3 -> 12, 4 -> 2, ...
    slots = ({0: 1, 8: 2, 4: 3, 12: 0, 2: 0, 10: 6, 6: 4, 14: 5}
             if order == "culled_between" else
             {0: 2, 8: 3, 4: 4, 12: 5, 2: 1, 10: 0, 6: 0, 14: 6})
    lists = torch.full((4, 32), -1, dtype=torch.int32)
    for s, t in slots.items():
        lists[0, s] = t
    counts = torch.tensor([15, 0, 0, 0], dtype=torch.int32)
    big = torch.full((32,), -1, dtype=torch.int32)
    a, keep = _raster_args(kernel, setup, lists, counts, big, w, h, 128, 32)
    n_big = a[4].shape[0] if kernel == "shade" else a[3].shape[0]
    return a, keep, slots, n_big


def _kernel_scan(lists, counts, big):
    """(tiles, big + cap) bool: the slots the raster_shade kernel scans that
    name a triangle (whole 16-slot blocks of the big list then the tile's
    list, up to ceil16(count + n_big), as the kernel computes n_scan)."""
    n_big, cap = big.shape[0], lists.shape[1]
    n_slots = -(-(n_big + cap) // 16) * 16
    n_scan = torch.clamp((counts.long() + n_big + 15) // 16 * 16, max=n_slots)
    ids = torch.cat([big[None, :].expand(lists.shape[0], -1), lists], dim=1)
    slot = torch.arange(n_big + cap)[None, :]
    return (slot < n_scan[:, None]) & (ids >= 0)


def _covering(records):
    """Edge records that put every pixel centre inside (e0 = e1 = 1, S = 3):
    with them tile_slot_keep marks exactly the scanned slots that name a
    triangle."""
    out = records.clone()
    out[:, :9] = 0.0
    out[:, 6:8] = 1.0
    out[:, 9] = 3.0
    return out


# -- small real frames: K1 on the flagship and the glass step, K5 and K7 -----

@pytest.fixture(scope="module")
def frames():
    """The kernels' arguments on one small flagship frame and one small
    glass frame on the CPU: raster_shade (K1) on both, the refraction
    pass's visibility (K5) and the OIT accumulation (K7)."""
    shadow = ShadowConfig(resolve_step=2, cascade_sizes=(256, 128, 128),
                          atlas_tile_h=16, atlas_foot_y=2, max_active_tiles=24)
    out = {}
    for name, kw in (("flagship", {}), ("glass", dict(box_materials=GLASS_BOXES))):
        over = dict(GLASS_OVERRIDES, shadow=shadow) if kw else {"shadow": shadow}
        step, state = build(32, 256, 128, grid_dim=8, cfg_overrides=over, device="cpu",
                            **kw)
        rend, scene, const = step.renderer, step.scene, step.constants
        mats = step.instance_matrices(step.physics(state["physics"]))
        out[f"shade_{name}"] = raster.kernel_args(**rend.raster_inputs(scene, mats, const))
        if kw:
            geo, vis, _ = rend.gbuffer_pass(scene, mats, const)
            out["visibility"] = raster.visibility_args(**rend.refraction_inputs(
                scene, geo, const))
            out["oit"] = oit.oit_args(**rend.oit_inputs(scene, geo, const, vis["depth"]))
    return out


@pytest.mark.parametrize("shape", ["shade_flagship", "shade_glass", "visibility"])
def test_raster_cull_on_small_frames(frames, shape):
    """K1 on the flagship's and the glass step's frames and K5 on the
    refraction pass: masked == unmasked in every bit. The slots the K1
    kernel scans are the ones tile_slot_keep scans (its 32-slot big list
    and 96-slot lists are whole 16-slot blocks, their holes -1 and last)."""
    kernel = "shade" if shape.startswith("shade") else "visibility"
    a = frames[shape]
    lists, counts, big = (a[2:5] if kernel == "shade" else a[1:4])
    w, h, tile, th = a[-4:]
    records = a[0]
    keep = raster.tile_slot_keep(records, lists, counts, big, w, h, tile, th, (), "edge")
    ref = _raster_plain(kernel, a)
    _assert_same_bits(_raster_plain(kernel, a, keep), ref)
    assert (ref["tri_id"] >= 0).any()
    scanned = raster.tile_slot_keep(_covering(records), lists, counts, big, w, h, tile,
                                    th, (), "edge")
    assert torch.equal(scanned, _kernel_scan(lists, counts, big))
    assert int(keep.sum()) < int(scanned.sum())


# -- K1 and K5 as their kernels cull: per row band of RASTER_BAND pixels ------

def _band_keep(kernel, a):
    """(the plain version's arguments on the kernels' band grid,
    `raster.band_args`; the kernels' cull there, tile_slot_keep over
    `chip_smoke.cull_args`)."""
    return raster.band_args(a), raster.tile_slot_keep(*chip_smoke.cull_args(a, kernel))


def _tile_keep_on_bands(a, keep_tile):
    """Each band's row of its tile's mask, on the band grid of `a`."""
    w, h, tile, th = a[-4:]
    n = torch.zeros(keep_tile.shape[0], dtype=torch.int32)
    return raster.band_lists(keep_tile, n, w, h, tile, th, raster.RASTER_BAND // tile)[0]


def _tile_keep(kernel, a):
    return raster.tile_slot_keep(*((a[0], *a[2:9]) if kernel == "shade" else a[:8]), (),
                                 "edge")


@pytest.mark.parametrize("kernel", ["shade", "visibility"])
@pytest.mark.parametrize("case", list(CASES))
def test_raster_band_cull_is_exact(case, kernel):
    """K1's and K5's cull as the kernels run it, per 128x8 row band of the
    128x32 tiles: the plain raster on the band grid, masked by
    tile_slot_keep there, equals the unmasked raster on the tiles bit for
    bit; a band keeps only slots its tile keeps, and the bands fewer in
    all; the grid holds no band below the frame."""
    setup, big, lists, counts, _, _ = _inputs(case, 4, tile_h=32, n_big=32, cap=96,
                                              compact_big=True)
    a, keep_tile = _raster_args(kernel, setup, lists, counts, big, W, H, 128, 32)
    b, keep = _band_keep(kernel, a)
    assert keep.shape[0] == -(-W // 128) * -(-H // 8)
    _assert_same_bits(_raster_plain(kernel, b, keep), _raster_plain(kernel, a))
    tk = _tile_keep_on_bands(a, keep_tile)
    assert not (keep & ~tk).any()
    assert 0 < int(keep.sum()) < int(tk.sum())


@pytest.mark.parametrize("kernel", ["shade", "visibility"])
@pytest.mark.parametrize("order", ["culled_between", "culled_first"])
def test_raster_band_cull_keeps_ties_and_corner_edges(kernel, order):
    """The scene of test_raster_cull_keeps_ties_and_corner_edges on the
    kernels' band grid: tile 0's four bands never keep the triangles inside
    tile 1; the triangle through tile 0's corner centre (127.5, 31.5)
    reaches only the last of them, which alone keeps it; the masked raster on
    the bands equals the unmasked one on the tiles in every bit, ties
    included."""
    a, _, slots, n_big = _tie_scene(kernel, order)
    b, keep = _band_keep(kernel, a)
    bands0 = [2 * r for r in range(4)]            # tiles_x = 2: band rows 0-3, column 0
    culled = [n_big + s for s, t in slots.items() if 2 <= t <= 5]
    corner = [n_big + s for s, t in slots.items() if t == 6]
    assert not keep[bands0][:, culled].any()
    assert keep[bands0[3], corner].all() and not keep[bands0[:3]][:, corner].any()
    _assert_same_bits(_raster_plain(kernel, b, keep), _raster_plain(kernel, a))


@pytest.mark.parametrize("shape", ["shade_flagship", "shade_glass", "visibility"])
def test_raster_band_cull_on_small_frames(frames, shape):
    """K1 on the flagship's and the glass step's frames and K5 on the
    refraction pass, culled per row band as the kernels cull: masked on the
    band grid == unmasked in every bit; the bands keep only what their
    tiles keep, and fewer."""
    kernel = "shade" if shape.startswith("shade") else "visibility"
    a = frames[shape]
    b, keep = _band_keep(kernel, a)
    _assert_same_bits(_raster_plain(kernel, b, keep), _raster_plain(kernel, a))
    tk = _tile_keep_on_bands(a, _tile_keep(kernel, a))
    assert not (keep & ~tk).any()
    assert 0 < int(keep.sum()) < int(tk.sum())


# -- K7: the OIT accumulation on the band grid --------------------------------

def _oit_inputs(case, seed, tile):
    """OIT arguments from `case` triangles on the W x H frame (the lower
    bands of its 128x128 tiles lie below it): merged lists whose 64-slot
    big list has holes inside and at the end and holds wide, short
    triangles (slots 52-59, each within 9 rows), and tile lists drawn at
    random."""
    w, h = W, H
    setup, big, lists, counts, _, rng = _inputs(case, seed, n=120, tile=tile,
                                                tile_h=tile, n_big=64, cap=48)
    n = setup["valid"].shape[0]
    # 8 band-bound big triangles appended to the scene
    y0 = rng.choice([4.5, 36.5, 52.5], 8) + rng.uniform(0, 3, 8)
    x0 = rng.uniform(-20, w - 60, 8)
    band = np.stack([np.stack([x0, x0 + 30, x0 + 200], 0),
                     np.stack([y0, y0 + 8, y0 + 2], 0)], -1)
    pts_x = np.concatenate([setup["sx"].numpy(), band[..., 0]], 1)
    pts_y = np.concatenate([setup["sy"].numpy(), band[..., 1]], 1)
    z = np.concatenate([setup["z"].numpy(), rng.uniform(0.05, 0.95, (3, 8))], 1)
    setup = _setup(pts_x, pts_y, z)
    big = big.clone()
    big[-12:-4] = torch.arange(n, n + 8, dtype=torch.int32)
    big[3] = -1
    rgba = torch.tensor(rng.uniform(0.05, 0.95, (n + 8, 4)), dtype=torch.float32)
    opaque = torch.tensor(rng.choice([0.0, 0.3, 0.6], (h, w)), dtype=torch.float32)
    merged = raster.merge_big_list(lists, counts, big)
    return oit.oit_args(setup, rgba, *merged, opaque, w, h, tile)


@pytest.mark.parametrize("tile", [128, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_oit_cull_is_exact(case, tile):
    """K7's per-band vertex-form cull: oit_plain masked by band_keep equals
    the unmasked one bit for bit; the band-bound big triangles are culled
    from the other bands of their tiles, and the holes are dropped."""
    w, h = W, H
    a = _oit_inputs(case, 5, tile)
    keep = oit.band_keep(a[0], a[1], a[2], w, h, tile)
    ref = oit.oit_plain(*a)
    out = oit.oit_plain(*a, keep=keep)
    assert torch.equal(_bits(out[0]), _bits(ref[0]))
    assert torch.equal(_bits(out[1]), _bits(ref[1]))
    assert (ref[1] < 1).any()
    lists, n = oit.band_lists(a[1], a[2], w, h, tile)
    assert lists.shape[0] == -(-w // tile) * -(-h // oit.band_rows(tile))
    assert 0 < int(keep.sum()) < int((lists >= 0).sum())
    if tile == 128:
        # each band-bound big triangle (slots 52-59, at most 9 rows tall) is
        # kept in at most three bands of a tile
        kb = keep[:, 52:60].reshape(-(-h // oit.band_rows(tile)), -(-w // tile), 8)
        assert (kb.sum(0) <= 3).all() and kb.any()


def test_oit_cull_on_a_small_glass_frame(frames):
    """K7 on the small glass frame's OIT pass: masked == unmasked in every
    bit, and the bands keep fewer slots than their lists name."""
    a = frames["oit"]
    w, h, tile = a[4:7]
    keep = oit.band_keep(a[0], a[1], a[2], w, h, tile)
    ref = oit.oit_plain(*a)
    out = oit.oit_plain(*a, keep=keep)
    assert torch.equal(_bits(out[0]), _bits(ref[0]))
    assert torch.equal(_bits(out[1]), _bits(ref[1]))
    lists, _ = oit.band_lists(a[1], a[2], w, h, tile)
    assert 0 < int(keep.sum()) < int((lists >= 0).sum())


def test_oit_inside_pairs_survive_the_cull(frames):
    """oit_plain's `work`, the (slot, pixel) pairs whose pixel is inside the
    slot's triangle (K7's bound counts its depth, weight and sums only
    there), is the same with band_keep's mask: no culled pair is inside;
    and it is a share of the kept pairs."""
    a = frames["oit"]
    w, h, tile = a[4:7]
    keep = oit.band_keep(a[0], a[1], a[2], w, h, tile)
    full, masked = [0], [0]
    oit.oit_plain(*a, work=full)
    oit.oit_plain(*a, keep=keep, work=masked)
    assert full[0] == masked[0]
    assert 0 < full[0] < chip_smoke.kept_pairs(keep, w, h, tile, oit.band_rows(tile))
