"""Software rasterization: triangle setup, tile binning, the fused
visibility + G-buffer raster and the depth-only raster of the shadow atlas.

Port of `garden_tpu.render.raster`'s main-view and cascade paths:

1. `setup_triangles_planes`: clip-space corners -> screen coordinates,
   reverse-Z depth, 1/w, backface and near culls, screen bounds.
2. `bin_triangles`: each small triangle emits (tile, triangle) pairs for
   its tile footprint; one sort by (tile, depth bucket, triangle) gives
   every tile a contiguous run. Triangles with a larger footprint go to a
   short "big" list that every tile draws first; with `priority`, lists
   come out in exact back-to-front order. `bin_triangles_corner` (one
   sorted entry per caster, lists assembled from four neighbour runs) and
   `bin_big_supertiles` bin the cascade atlas.
3. `rasterize_visibility_shaded`: per tile, scan the big list and then the
   tile's own list, keep the nearest hit per pixel, and finish the
   G-buffer planes from the winner's shading record. On a CUDA tensor this
   launches the hand-written kernel `csrc/raster_shade.cu`; on a CPU tensor
   it runs `raster_shade_plain`, the same computation in PyTorch.
   `rasterize_visibility` is the same scan without the shading (kernel
   visibility, same source; `visibility_plain`).
4. `rasterize_sorted_blend`: source-over blend of one rgba per triangle in
   bin order (kernel sorted_blend in `csrc/blend_raster.cu`;
   `blend_plain`).
5. `rasterize_depth`: the max-reduce depth raster, dense (kernel
   depth_dense) or split (depth_super, then depth_grid), from
   `csrc/depth_raster.cu`, each with its plain version.

Depth is reverse-Z: larger is nearer, 0 is empty.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

FOOT = 4            # default tile footprint edge of bin_triangles (else the big list)
NEAR_EPS = 1e-6
TRI_BLOCK = 16      # list slots per scan block
GBUF_PLANES = 18    # [normal3 | uv2 | base3 metallic roughness emissive3
                    #  reflectance | texture | instance | velocity2]
EDGE_WIDTH = 16     # edge-coefficient record, see _pack_edge_records

# Scan order of the slots inside one block. The reference reduces each
# 16-slot block with a halving tournament (halves of 8, 4, 2, 1) that takes
# the second operand only when it is strictly nearer; among equal depths
# that tournament keeps the first slot met in bit-reversed order. Blocks
# then merge into the running result in list order, again strictly.
BITREV16 = (0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15)


def setup_triangles(clip: Tensor, indices: Tensor, tri_valid: Tensor, width: int,
                    height: int) -> Dict[str, Tensor]:
    """Screen-space setup from a vertex pool: clip (V, 4), indices (T, 3)."""
    return setup_triangles_tv(clip[indices.long()], tri_valid, width, height)


def setup_triangles_tv(v: Tensor, tri_valid: Tensor, width: int, height: int
                       ) -> Dict[str, Tensor]:
    """Screen-space setup from gathered clip-space corners v (T, 3, 4)."""
    return setup_triangles_planes(*(v[..., i].T for i in range(4)), tri_valid,
                                  width, height)


def setup_triangles_planes(cx: Tensor, cy: Tensor, cz: Tensor, cw: Tensor,
                           tri_valid: Tensor, width: int, height: int
                           ) -> Dict[str, Tensor]:
    """Screen-space setup from per-component clip planes, each (3, T) with
    row k holding corner k. Outputs keep that corner-major layout."""
    in_front = torch.all(cw > NEAR_EPS, dim=0)
    inv_w = 1.0 / torch.clamp(cw, min=NEAR_EPS)
    sx = (cx * inv_w * 0.5 + 0.5) * width
    sy = (0.5 - cy * inv_w * 0.5) * height        # y-down screen
    z = cz * inv_w                                # reverse-Z in [0, 1]
    # front faces have negative screen area after the y flip
    area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
    front = area < -1e-8
    xmin, xmax = torch.amin(sx, dim=0), torch.amax(sx, dim=0)
    ymin, ymax = torch.amin(sy, dim=0), torch.amax(sy, dim=0)
    on_screen = (xmax >= 0) & (xmin < width) & (ymax >= 0) & (ymin < height)
    valid = tri_valid & in_front & front & on_screen
    inv_area = torch.where(valid, 1.0 / torch.where(front, -area, torch.ones_like(area)),
                           torch.zeros_like(area))
    return {"sx": sx, "sy": sy, "z": z, "inv_w": inv_w, "inv_area": inv_area,
            "xmin": xmin, "xmax": xmax, "ymin": ymin, "ymax": ymax,
            "valid": valid}


def _grid(width: int, height: int, tile: int, tile_h: int):
    """(tiles_x, tiles_y, tiles) of a width x height frame in tile x tile_h
    tiles."""
    tiles_x = -(-width // tile)
    tiles_y = -(-height // tile_h)
    return tiles_x, tiles_y, tiles_x * tiles_y


def bin_triangles(setup: Dict[str, Tensor], width: int, height: int, tile: int,
                  max_per_tile: int, max_big: int = 64, priority: Tensor = None,
                  bucket_priority: Tensor = None, foot: int = None,
                  tile_h: int = None, foot_y: int = None, max_active: int = None
                  ) -> Tuple[Tensor, ...]:
    """Returns (tile_tris (tiles, max_per_tile) int32 padded with -1,
    counts (tiles,) int32, big_list (max_big,) int32 padded with -1);
    tiles are row-major over (tiles_y, tiles_x) tiles of tile x tile_h.

    Triangles spanning more than foot x foot_y tiles go to the big list.
    priority: optional permutation of [0, T); tile entries and the big
    list come out in ascending priority (the sorted pass's back-to-front
    order). bucket_priority: optional int[T] in [0, 16); tile entries
    come out ordered by (bucket, triangle id), so overflow drops the last
    buckets, and the big list likewise. The two are exclusive. foot
    defaults to FOOT, foot_y to foot.

    max_active: only the max_active tiles with the most entries keep a
    list (largest first, ties to the higher tile index, `_top_tiles`), and
    a fourth output act_ids (max_active,) names them: (tile_tris
    (max_active, C), counts (max_active,), big_list, act_ids). Exclusive
    with priority."""
    if priority is not None and bucket_priority is not None:
        raise ValueError("priority and bucket_priority are exclusive")
    if priority is not None and max_active is not None:
        raise ValueError("priority and max_active are exclusive")
    foot = foot or FOOT
    th = tile_h or tile
    foot_y = foot_y or foot
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile, th)
    t = setup["valid"].shape[0]
    dev = setup["valid"].device
    tx0, nx, ty0, ny = _tile_spans(setup, tile, th, tiles_x, tiles_y)
    small = setup["valid"] & (nx <= foot) & (ny <= foot_y)
    big = setup["valid"] & ~small

    k = torch.arange(foot * foot_y, device=dev)
    kx = (k % foot)[:, None]
    ky = torch.div(k, foot, rounding_mode="floor")[:, None]
    pair_ok = small[None, :] & (kx < nx[None, :]) & (ky < ny[None, :])
    # key classes: tile keys, then one key for every slot of a big triangle
    # (so each big triangle holds foot*foot_y equal consecutive entries),
    # then the sentinel
    key = torch.where(pair_ok, (ty0[None, :] + ky) * tiles_x + tx0[None, :] + kx,
                      torch.where(big[None, :], n_tiles, n_tiles + 1))
    key = key.reshape(-1)
    # the payload is the triangle id, or its priority (mapped back below)
    pay = torch.arange(t, device=dev) if priority is None else priority.long()
    payload = pay.expand(foot * foot_y, t).reshape(-1)
    bkt_bits = 0
    if bucket_priority is not None:
        bkt_bits = 4
        bp = torch.clamp(bucket_priority.long(), 0, 15)
        key = (key << bkt_bits) | bp.expand(foot * foot_y, t).reshape(-1)
    # one sort of (key << tri_bits | triangle), packed in int64: the
    # reference packs int32 while the bits fit (31 of them at 1080p and
    # ~123K triangles), which orders the entries the same way
    tri_bits = max(int(np.ceil(np.log2(max(t, 2)))), 1)
    packed = torch.sort((key << tri_bits) | payload).values
    key_sorted = packed >> (tri_bits + bkt_bits)
    pay_sorted = packed & ((1 << tri_bits) - 1)

    probes = torch.arange(n_tiles + 2, device=dev)
    edges = torch.searchsorted(key_sorted, probes, side="left")
    start = edges[:n_tiles]
    end = edges[1:n_tiles + 1]
    act_ids = None
    if max_active is not None:
        act_ids = _top_tiles(end - start, n_tiles, min(max_active, n_tiles))
        start, end = start[act_ids.long()], end[act_ids.long()]
    last = key_sorted.shape[0] - 1
    gather = start[:, None] + torch.arange(max_per_tile, device=dev)[None, :]
    ok = gather < end[:, None]
    tile_pay = pay_sorted[torch.clamp(gather, 0, last)]
    # big triangles: stride through their run, one entry per triangle
    max_big = min(max_big, t)
    kk = foot * foot_y
    big_cnt = torch.div(edges[n_tiles + 1] - edges[n_tiles], kk, rounding_mode="floor")
    slots = torch.arange(max_big, device=dev)
    big_pay = pay_sorted[torch.clamp(edges[n_tiles] + slots * kk, 0, last)]
    if priority is not None:
        # priorities back to triangle ids through the inverse permutation
        inv = torch.zeros(t, dtype=torch.long, device=dev)
        inv[priority.long()] = torch.arange(t, device=dev)
        tile_pay = inv[torch.clamp(tile_pay, 0, t - 1)]
        big_pay = inv[torch.clamp(big_pay, 0, t - 1)]
    tile_tris = torch.where(ok, tile_pay, -1).int()
    counts = torch.clamp(end - start, max=max_per_tile).int()
    big_list = torch.where(slots < big_cnt, big_pay, -1).int()
    if act_ids is not None:
        return tile_tris, counts, big_list, act_ids
    return tile_tris, counts, big_list


def merge_big_list(tile_tris: Tensor, counts: Tensor, big_list: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """Prepend the shared big list to every tile's row, for consumers that
    walk one flat list per tile (OIT) -> (tile_tris (tiles, B + C), counts).
    A tile with entries counts all B big slots, holes included; a tile
    without counts only the big list's used slots."""
    n_tiles, b = tile_tris.shape[0], big_list.shape[0]
    merged = torch.cat([big_list[None, :].expand(n_tiles, b), tile_tris], dim=1)
    big_n = (big_list >= 0).sum()
    return merged.int(), torch.where(counts > 0, b + counts, big_n).int()


def _tile_spans(setup: Dict[str, Tensor], tile: int, th: int, tiles_x: int,
                tiles_y: int):
    """Per triangle: first tile column and row of its bounds, and how many
    tile columns and rows the bounds span (clamped to the grid)."""
    def span(lo, hi, size, n):
        a = torch.clamp(torch.floor(lo / size).long(), 0, n - 1)
        b = torch.clamp(torch.floor(hi / size).long(), 0, n - 1)
        return a, b - a + 1
    tx0, nx = span(setup["xmin"], setup["xmax"], tile, tiles_x)
    ty0, ny = span(setup["ymin"], setup["ymax"], th, tiles_y)
    return tx0, nx, ty0, ny


def _sort_runs(key: Tensor, payload: Tensor, n_payload: int, n_keys: int):
    """Sort (key, payload) pairs, payloads in [0, n_payload), by key and
    then payload in one packed int64 sort; -> (sorted payloads, run
    edges): edges[k] is the first position whose key is >= k, for k in
    [0, n_keys]."""
    bits = max(int(np.ceil(np.log2(max(n_payload, 2)))), 1)
    packed = torch.sort((key.long() << bits) | payload.long()).values
    probes = torch.arange(n_keys + 1, device=key.device)
    edges = torch.searchsorted(packed >> bits, probes, side="left")
    return packed & ((1 << bits) - 1), edges


INT32_MAX = 2147483647


def _top_tiles(cnt: Tensor, n_tiles: int, a: int) -> Tensor:
    """The `a` tiles with the largest counts, largest first; among equal
    counts the higher tile index comes first (the reference's descending
    order of the packed (count << bits | tile) key, counts clamped so the
    key keeps 30 bits)."""
    bits_t = max(int(np.ceil(np.log2(n_tiles + 1))), 1)
    cnt_c = torch.clamp(cnt.long(), max=(1 << (30 - bits_t)) - 1)
    packed = torch.sort((cnt_c << bits_t)
                        | torch.arange(n_tiles, device=cnt.device)).values
    return (packed.flip(0)[:a] & ((1 << bits_t) - 1)).int()


def bin_triangles_corner(setup: Dict[str, Tensor], width: int, height: int,
                         tile: int, max_per_tile: int, max_big: int = 64,
                         tile_h: int = None, max_active: int = None
                         ) -> Tuple[Tensor, ...]:
    """Binning for order-free consumers (the depth raster's max-reduce):
    each small triangle (bounds within 2x2 tiles) is sorted once by its
    top-left tile, and each tile assembles its list from the four runs
    that can reach it (own, left, up, up-left), keeping only entries whose
    footprint extends into it. Larger triangles go to the big list.

    Returns (tile_tris (tiles, max_per_tile) int32 padded with -1 and
    compacted in ascending id order, counts (tiles,), big_list
    (max_big,)); with max_active, only the max_active tiles with the most
    candidates keep a list, and a fourth output act_ids (max_active,)
    names them."""
    th = tile_h or tile
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile, th)
    t = setup["valid"].shape[0]
    dev = setup["valid"].device
    tx0, nx, ty0, ny = _tile_spans(setup, tile, th, tiles_x, tiles_y)
    small = setup["valid"] & (nx <= 2) & (ny <= 2)
    big = setup["valid"] & ~small
    key = torch.where(small, ty0 * tiles_x + tx0,
                      torch.where(big, n_tiles, n_tiles + 1))
    pay_sorted, edges = _sort_runs(key, torch.arange(t, device=dev), t,
                                   n_tiles + 1)
    start = edges[:n_tiles]
    length = edges[1:n_tiles + 1] - start

    # the runs of the tile itself, its left, upper and upper-left
    # neighbours; runs across the frame's left or top border are empty
    idx = torch.arange(n_tiles, device=dev)
    col0 = (idx % tiles_x) == 0
    row0 = idx < tiles_x
    runs = [(start, length)]
    for shift, dead in ((1, col0), (tiles_x, row0), (tiles_x + 1, row0 | col0)):
        runs.append((torch.roll(start, shift),
                     torch.where(dead, 0, torch.roll(length, shift))))
    act_ids = None
    if max_active is not None:
        act_ids = _top_tiles(sum(l for _, l in runs), n_tiles,
                             min(max_active, n_tiles))
        runs = [(s[act_ids.long()], l[act_ids.long()]) for s, l in runs]

    # slot j of a list walks the concatenation of the four runs
    j = torch.arange(max_per_tile, device=dev)[None, :]
    src = torch.zeros((runs[0][0].shape[0], max_per_tile), dtype=torch.long,
                      device=dev)
    need = torch.zeros_like(src)
    any_run = torch.zeros(src.shape, dtype=torch.bool, device=dev)
    lo = torch.zeros_like(runs[0][1])
    for r, (s, l) in enumerate(runs):
        inr = (j >= lo[:, None]) & (j < (lo + l)[:, None])
        src = torch.where(inr, s[:, None] + (j - lo[:, None]), src)
        need = need | torch.where(inr, r, 0)   # run r needs footprint bits r
        any_run = any_run | inr
        lo = lo + l
    pay = pay_sorted[torch.clamp(src, 0, t - 1)]
    # footprint bits: 1 = reaches the next tile column, 2 = the next row
    fp = (nx > 1).long() | ((ny > 1).long() << 1)
    fpe = fp[torch.clamp(pay, 0, t - 1)]
    covered = any_run & ((fpe & need) == need)
    slot_val = torch.sort(torch.where(covered, pay, INT32_MAX), dim=1).values
    tile_tris = torch.where(slot_val == INT32_MAX, -1, slot_val).int()
    counts = covered.sum(dim=1).int()

    max_big = min(max_big, t)
    big_cnt = edges[n_tiles + 1] - edges[n_tiles]
    slots = torch.arange(max_big, device=dev)
    big_pay = pay_sorted[torch.clamp(edges[n_tiles] + slots, 0, t - 1)]
    big_list = torch.where(slots < big_cnt, big_pay, -1).int()
    if act_ids is not None:
        return tile_tris, counts, big_list, act_ids
    return tile_tris, counts, big_list


def _supertile_runs(setup: Dict[str, Tensor], big_list: Tensor, width: int,
                    height: int, tile: int, tile_h: int, sup_x: int, sup_y: int):
    """Each big triangle of `big_list` binned onto a coarse grid of sup_x x
    sup_y tiles, into every super-tile its bounds overlap (no footprint
    limit) -> (triangle ids sorted by super-tile, then id; run starts
    (n_sup,); run ends (n_sup,); sups_x). Run s holds super-tile s's
    casters, uncapped."""
    th = tile_h or tile
    tiles_x, tiles_y, _ = _grid(width, height, tile, th)
    sups_x = -(-tiles_x // sup_x)
    n_sup = sups_x * -(-tiles_y // sup_y)
    spw = float(tile * sup_x)
    sph = float(th * sup_y)
    t = setup["valid"].shape[0]
    dev = big_list.device
    safe = torch.clamp(big_list.long(), 0, t - 1)
    ok = big_list >= 0
    x0, x1 = setup["xmin"][safe][:, None], setup["xmax"][safe][:, None]
    y0, y1 = setup["ymin"][safe][:, None], setup["ymax"][safe][:, None]
    s = torch.arange(n_sup, device=dev)
    sx0 = (s % sups_x).float()[None, :] * spw
    sy0 = torch.div(s, sups_x, rounding_mode="floor").float()[None, :] * sph
    hit = (ok[:, None] & (x1 >= sx0) & (x0 < sx0 + spw)
           & (y1 >= sy0) & (y0 < sy0 + sph))
    key = torch.where(hit, s[None, :], n_sup).reshape(-1)
    payload = safe[:, None].expand(-1, n_sup).reshape(-1)
    pay_sorted, edges = _sort_runs(key, payload, t, n_sup)
    return pay_sorted, edges[:-1], edges[1:], sups_x


def supertile_counts(setup: Dict[str, Tensor], big_list: Tensor, width: int,
                     height: int, tile: int, tile_h: int, sup_x: int,
                     sup_y: int) -> Tensor:
    """(n_sup,) casters of each super-tile list of `bin_big_supertiles`
    before its cap: where it exceeds the cap, the list drops the rest."""
    _, start, end, _ = _supertile_runs(setup, big_list, width, height, tile, tile_h,
                                       sup_x, sup_y)
    return end - start


def bin_big_supertiles(setup: Dict[str, Tensor], big_list: Tensor, width: int,
                       height: int, tile: int, tile_h: int, sup_x: int,
                       sup_y: int, cap: int
                       ) -> Tuple[Tensor, Tensor, Tuple[int, int, int]]:
    """Per super-tile big lists: each big triangle of `big_list` is binned
    onto a coarse grid of sup_x x sup_y tiles, into every super-tile its
    bounds overlap (no footprint limit). Returns (sup_tris (n_sup, cap)
    int32 padded with -1, sup_counts (n_sup,), (sup_x, sup_y, sups_x))."""
    pay_sorted, start, end, sups_x = _supertile_runs(
        setup, big_list, width, height, tile, tile_h, sup_x, sup_y)
    gather = start[:, None] + torch.arange(cap, device=big_list.device)[None, :]
    in_range = gather < end[:, None]
    gather = torch.clamp(gather, 0, pay_sorted.shape[0] - 1)
    sup_tris = torch.where(in_range, pay_sorted[gather], -1).int()
    sup_counts = torch.clamp(end - start, max=cap).int()
    return sup_tris, sup_counts, (sup_x, sup_y, sups_x)


def _pack_edge_records(setup: Dict[str, Tensor], tri_atlas: Tensor = None) -> Tensor:
    """(T + 1, 16) per-triangle records in edge-coefficient form:
    [a0 a1 a2 | b0 b1 b2 | c0 c1 c2 | S | z2 | dz0 | dz1 | inv_area | id |
    atlas] with e_k = a_k px + b_k py + c_k and e0 + e1 + e2 = S; `atlas`
    is the triangle's cascade index (tri_atlas) or 0. Row T is a sentinel
    (id -1) that empty list slots point at."""
    sx, sy, z = setup["sx"], setup["sy"], setup["z"]
    a, b, c = [], [], []
    for k in range(3):
        x1, y1 = sx[(k + 1) % 3], sy[(k + 1) % 3]
        x2, y2 = sx[(k + 2) % 3], sy[(k + 2) % 3]
        a.append(y2 - y1)
        b.append(-(x2 - x1))
        c.append(y1 * (x2 - x1) - x1 * (y2 - y1))
    s_const = a[0] * sx[0] + b[0] * sy[0] + c[0]
    t_count = sx.shape[1]
    ids = torch.arange(t_count, dtype=torch.float32, device=sx.device)
    atlas = tri_atlas.float() if tri_atlas is not None else torch.zeros_like(ids)
    rec = torch.stack(a + b + c + [s_const, z[2], z[0] - z[2], z[1] - z[2],
                                   setup["inv_area"], ids, atlas], dim=-1)
    sentinel = torch.zeros((1, EDGE_WIDTH), device=sx.device)
    sentinel[0, 14] = -1.0
    return torch.cat([rec, sentinel], dim=0)


def _finish_gbuffer(r, b0: Tensor, b1: Tensor, px: Tensor, py: Tensor,
                    visible: Tensor) -> Tensor:
    """The 18 finished G-buffer planes from the winning shading record
    channels r(i) (see gbuffer.pack_triangle_records) and the screen
    barycentrics; velocity uses screen barycentrics, the rest
    perspective-correct weights."""
    b2 = 1.0 - b0 - b1
    w0 = b0 * r(32)
    w1 = b1 * r(33)
    w2 = b2 * r(34)
    inv_s = 1.0 / torch.clamp(w0 + w1 + w2, min=1e-12)
    w0 = w0 * inv_s
    w1 = w1 * inv_s
    w2 = w2 * inv_s
    nx = r(0) * w0 + r(3) * w1 + r(6) * w2
    ny = r(1) * w0 + r(4) * w1 + r(7) * w2
    nz = r(2) * w0 + r(5) * w1 + r(8) * w2
    inv_len = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-12))
    u = r(9) * w0 + r(11) * w1 + r(13) * w2
    v = r(10) * w0 + r(12) * w1 + r(14) * w2
    vel_x = px - (r(26) * b0 + r(28) * b1 + r(30) * b2)
    vel_y = py - (r(27) * b0 + r(29) * b1 + r(31) * b2)
    zero = torch.zeros_like(u)
    return torch.stack([nx * inv_len, ny * inv_len, nz * inv_len, u, v]
                       + [r(i) for i in range(15, 26)]
                       + [torch.where(visible, vel_x, zero),
                          torch.where(visible, vel_y, zero)])


def _tiles_to_image(x: Tensor, tiles_y: int, tiles_x: int, th: int, tw: int,
                    height: int, width: int) -> Tensor:
    """(..., tiles, th*tw) per-tile pixels -> (..., height, width)."""
    lead = x.shape[:-2]
    x = x.reshape(lead + (tiles_y, tiles_x, th, tw)).transpose(-3, -2)
    return x.reshape(lead + (tiles_y * th, tiles_x * tw))[..., :height, :width]


def _tile_coords(tiles: Tensor, tiles_x: int, tile: int, th: int):
    """Pixel centres (rows, th * tile) of the given tiles, row-major."""
    pix = torch.arange(th * tile, device=tiles.device)
    col = (pix % tile).float()[None, :]
    row = torch.div(pix, tile, rounding_mode="floor").float()[None, :]
    px = ((tiles % tiles_x) * tile).float()[:, None] + 0.5 + col
    py = (torch.div(tiles, tiles_x, rounding_mode="floor") * th).float()[:, None] \
        + 0.5 + row
    return px, py


def _scan_visibility(edge: Tensor, tile_tris: Tensor, big_list: Tensor,
                     width: int, height: int, tile: int, tile_h: int,
                     max_elems: int, keep: Tensor = None):
    """The visibility scan of the raster kernels' plain versions: every
    tile takes the shared big list, then its own list, in 16-slot blocks
    with the BITREV16 tie order. Tiles run in chunks whose (tiles, slots,
    pixels) temporaries stay under `max_elems` elements; yields per chunk
    (tiles, px, py, vis) with vis the (chunk, pixels) depth, tri_id, b0,
    b1 and the winning record row `row` (the sentinel where empty). With
    `keep` (tiles, big + cap) bool, only the slots it marks are
    candidates."""
    dev = edge.device
    tiles_x, _, n_tiles = _grid(width, height, tile, tile_h)
    t_count = edge.shape[0] - 1
    n_px = tile_h * tile
    lists = torch.cat([big_list[None, :].expand(n_tiles, -1), tile_tris], dim=1)
    pad = (-lists.shape[1]) % TRI_BLOCK
    lists = torch.nn.functional.pad(lists, (0, pad), value=-1)
    if keep is not None:
        keep = torch.nn.functional.pad(keep, (0, pad), value=False)
    n_slots = lists.shape[1]
    safe = torch.where(lists >= 0, lists, t_count).long()
    # scan rank of each slot: blocks in order, bit-reversed inside a block
    slot = torch.arange(n_slots, device=dev)
    bitrev = torch.tensor(BITREV16, device=dev)
    rank = slot - slot % TRI_BLOCK + bitrev[slot % TRI_BLOCK]
    slot_of_rank = torch.empty_like(rank)
    slot_of_rank[rank] = slot
    step = max(1, max_elems // (n_slots * n_px))
    for t0 in range(0, n_tiles, step):
        tiles = torch.arange(t0, min(t0 + step, n_tiles), device=dev)
        px, py = _tile_coords(tiles, tiles_x, tile, tile_h)
        sid = safe[tiles]                               # (nt, S)
        d = edge[sid][..., None]                        # (nt, S, 16, 1)
        pxs, pys = px[:, None, :], py[:, None, :]
        e0 = d[:, :, 0] * pxs + d[:, :, 3] * pys + d[:, :, 6]
        e1 = d[:, :, 1] * pxs + d[:, :, 4] * pys + d[:, :, 7]
        e2 = d[:, :, 9] - e0 - e1
        w0 = e0 * d[:, :, 13]
        w1 = e1 * d[:, :, 13]
        z = d[:, :, 10] + w0 * d[:, :, 11] + w1 * d[:, :, 12]
        cand = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z <= 1.0) & (z > 0.0)
                & (d[:, :, 14] >= 0.0))
        if keep is not None:
            cand = cand & keep[tiles][:, :, None]
        zc = torch.where(cand, z, torch.zeros_like(z))
        best = torch.amax(zc, dim=1)                    # (nt, n_px)
        tie = cand & (zc == best[:, None, :])
        first = torch.amin(torch.where(tie, rank[None, :, None], n_slots), dim=1)
        hit = first < n_slots
        win = slot_of_rank[torch.clamp(first, max=n_slots - 1)]  # (nt, n_px)
        pick = lambda x: torch.gather(x, 1, win[:, None, :])[:, 0]
        zero = torch.zeros_like(best)
        row = torch.where(hit, torch.gather(sid, 1, win), t_count)
        yield tiles, px, py, {
            "depth": torch.where(hit, best, zero),
            "tri_id": torch.where(hit, row, -1).int(),
            "b0": torch.where(hit, pick(w0), zero),
            "b1": torch.where(hit, pick(w1), zero), "row": row}


def raster_shade_plain(edge: Tensor, shade: Tensor, tile_tris: Tensor,
                       counts: Tensor, big_list: Tensor, width: int,
                       height: int, tile: int, tile_h: int,
                       max_elems: int = 1 << 23, keep: Tensor = None
                       ) -> Tuple[Dict[str, Tensor], Tensor]:
    """The plain PyTorch version of the raster_shade kernel (same inputs,
    same tie rule); `shade` has a zero sentinel row. With `keep` (tiles,
    big + cap) bool, only the slots it marks are candidates: with
    `tile_slot_keep(..., form="edge")`'s mask the result is the same, on
    these tiles or on the kernel's band grid (`band_args`), which the
    tests hold; the renderer never passes it."""
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile, tile_h)
    n_px = tile_h * tile
    out = _empty_vis(n_tiles, n_px, edge.device)
    planes = torch.zeros((GBUF_PLANES, n_tiles, n_px), device=edge.device)
    for tiles, px, py, vis in _scan_visibility(edge, tile_tris, big_list, width,
                                               height, tile, tile_h, max_elems, keep):
        for k in out:
            out[k][tiles] = vis[k]
        rec = shade[vis["row"]]                         # (nt, n_px, REC)
        planes[:, tiles] = _finish_gbuffer(lambda i: rec[..., i], vis["b0"],
                                           vis["b1"], px, py, vis["tri_id"] >= 0)
    img = lambda x: _tiles_to_image(x, tiles_y, tiles_x, tile_h, tile, height, width)
    return {k: img(v) for k, v in out.items()}, img(planes)


def _empty_vis(n_tiles: int, n_px: int, dev) -> Dict[str, Tensor]:
    return {"depth": torch.zeros((n_tiles, n_px), device=dev),
            "tri_id": torch.full((n_tiles, n_px), -1, dtype=torch.int32, device=dev),
            "b0": torch.zeros((n_tiles, n_px), device=dev),
            "b1": torch.zeros((n_tiles, n_px), device=dev)}


def visibility_plain(edge: Tensor, tile_tris: Tensor, counts: Tensor,
                     big_list: Tensor, width: int, height: int, tile: int,
                     tile_h: int, max_elems: int = 1 << 23,
                     keep: Tensor = None) -> Dict[str, Tensor]:
    """The plain PyTorch version of the visibility kernel: raster_shade's
    scan without the shading; the big list and the tile lists come padded
    to 16-slot blocks (`visibility_args`). `keep` as in
    `raster_shade_plain`."""
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile, tile_h)
    out = _empty_vis(n_tiles, tile_h * tile, edge.device)
    for tiles, _, _, vis in _scan_visibility(edge, tile_tris, big_list, width,
                                             height, tile, tile_h, max_elems, keep):
        for k in out:
            out[k][tiles] = vis[k]
    return {k: _tiles_to_image(v, tiles_y, tiles_x, tile_h, tile, height, width)
            for k, v in out.items()}


def _check(name: str, x: Tensor, dtype: torch.dtype, shape: tuple, device,
           kernel: str = "raster_shade"):
    if x.device != device:
        raise ValueError(f"{kernel}: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{kernel}: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")


_THREADS = 256
_MAX_SMEM = 232448     # per-block shared memory limit on Hopper
# pixels of one block of the raster_shade and visibility kernels (256
# threads of 4, csrc kPixels): a tile runs as row bands of this many
RASTER_BAND = 1024


def _ptr(x: Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _call(fn, argtypes, kernel: str, dev: torch.device, *args) -> None:
    """Launch `fn(*args, stream)` on card `dev`, on its current stream. The
    launch runs under `dev`'s device guard, so the kernel (and the
    shared-memory limit the C entry point sets for it) goes to the card
    that holds the tensors, whatever the current device."""
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def raster_shade_cuda(edge: Tensor, shade: Tensor, tile_tris: Tensor,
                      counts: Tensor, big_list: Tensor, width: int,
                      height: int, tile: int, tile_h: int, kept: Tensor = None
                      ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Launch the raster_shade CUDA kernel (csrc/raster_shade.cu); same
    inputs and outputs as `raster_shade_plain`. With `kept` (bands,) int32
    on the grid of its row bands, the kernel also writes each band's number
    of slots that pass its cull (the row sums of `tile_slot_keep(...,
    form="edge")` over `band_args`)."""
    from garden_tpu_torch import cuda_build

    dev, tiles_x, n_tiles, smem = _raster_checks(
        "raster_shade", edge, tile_tris, counts, big_list, width, height, tile,
        tile_h, kept)
    _check("shade", shade, torch.float32, (edge.shape[0], shade.shape[1]), dev)
    if shade.shape[1] < 36:
        raise ValueError("raster_shade: shading records need >= 36 channels")
    vis = _vis_outputs(height, width, dev)
    planes = torch.empty((GBUF_PLANES, height, width), device=dev)
    _call(cuda_build.load("raster_shade").raster_shade_launch,
          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 6,
          "raster_shade", dev,
          _ptr(edge), _ptr(shade), _ptr(tile_tris), _ptr(counts), _ptr(big_list),
          big_list.shape[0], tile_tris.shape[1], shade.shape[1],
          n_tiles, tiles_x, tile, tile_h, width, height, smem,
          *[_ptr(vis[k]) for k in ("depth", "tri_id", "b0", "b1")], _ptr(planes),
          _kept_ptr(kept))
    rasterize_visibility_shaded.launches += 1
    return vis, planes


def band_lists(tile_tris: Tensor, counts: Tensor, width: int, height: int, tile: int,
               tile_h: int, rows: int) -> Tuple[Tensor, Tensor]:
    """The tile lists on the grid of the row bands, `rows` pixel rows tall,
    that a kernel runs each `tile` x `tile_h` tile as: ceil(height / rows)
    band rows by tiles_x, each band taking its tile's list and count ->
    (lists (bands, C), counts (bands,)). Bands wholly below the frame
    store nothing and are not in the grid."""
    dev = tile_tris.device
    tiles_x, _, _ = _grid(width, height, tile, tile_h)
    _, bands_y, _ = _grid(width, height, tile, rows)
    band_tile = torch.arange(bands_y, device=dev) * rows // tile_h
    idx = (band_tile[:, None] * tiles_x + torch.arange(tiles_x, device=dev)[None, :])
    return tile_tris[idx.reshape(-1)].contiguous(), counts[idx.reshape(-1)].contiguous()


def band_args(args: tuple) -> tuple:
    """The arguments of raster_shade_plain or visibility_plain (`args`, as
    `kernel_args` or `visibility_args` give them) on the grid of their
    kernels' row bands of RASTER_BAND pixels (`band_lists`): the same
    result, each band scanning its tile's slots. `tile_slot_keep(...,
    form="edge")` over them is the kernels' cull, and its row sums their
    `kept`."""
    *head, tile_tris, counts, big_list, width, height, tile, tile_h = args
    rows = RASTER_BAND // tile
    return (*head, *band_lists(tile_tris, counts, width, height, tile, tile_h, rows),
            big_list, width, height, tile, rows)


def _raster_checks(kernel: str, edge: Tensor, tile_tris: Tensor, counts: Tensor,
                   big_list: Tensor, width: int, height: int, tile: int,
                   tile_h: int, kept: Tensor):
    """Checks shared by the raster_shade and visibility wrappers; -> (device,
    tiles_x, n_tiles, shared-memory bytes for the tile's surviving slots:
    the edge record and the triangle id)."""
    dev = edge.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}_cuda needs CUDA tensors, got {dev}")
    tiles_x, _, n_tiles = _grid(width, height, tile, tile_h)
    cap, n_big = tile_tris.shape[1], big_list.shape[0]
    _check("edge", edge, torch.float32, (edge.shape[0], EDGE_WIDTH), dev, kernel)
    _check("tile_tris", tile_tris, torch.int32, (n_tiles, cap), dev, kernel)
    _check("counts", counts, torch.int32, (n_tiles,), dev, kernel)
    _check("big_list", big_list, torch.int32, (n_big,), dev, kernel)
    if _THREADS % tile or (tile * tile_h) % RASTER_BAND:
        raise ValueError(f"{kernel}: a {tile}x{tile_h} tile is not a kernel "
                         f"shape (the width must divide {_THREADS} and the "
                         f"pixels be a multiple of {RASTER_BAND})")
    _check_kept(kept, _grid(width, height, tile, RASTER_BAND // tile)[2], dev, kernel)
    n_slots = -(-(n_big + cap) // TRI_BLOCK) * TRI_BLOCK
    smem = n_slots * (EDGE_WIDTH + 1) * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"{kernel}: {n_slots} list slots need {smem} bytes "
                         "of shared memory")
    return dev, tiles_x, n_tiles, smem


def _vis_outputs(height: int, width: int, dev) -> Dict[str, Tensor]:
    return {"depth": torch.empty((height, width), device=dev),
            "tri_id": torch.empty((height, width), dtype=torch.int32, device=dev),
            "b0": torch.empty((height, width), device=dev),
            "b1": torch.empty((height, width), device=dev)}


def kernel_args(setup: Dict[str, Tensor], shade_records: Tensor,
                tile_tris: Tensor, counts: Tensor, big_list: Tensor,
                width: int, height: int, tile: int, tile_h: int = None) -> tuple:
    """The positional arguments of raster_shade_cuda / raster_shade_plain:
    edge records, shading records with a zero sentinel row (empty slots
    shade to zeros), the int32 lists, and the frame and tile sizes."""
    edge = _pack_edge_records(setup)
    shade = torch.cat([shade_records, torch.zeros_like(shade_records[:1])])
    return (edge, shade, tile_tris.int().contiguous(), counts.int().contiguous(),
            big_list.int().contiguous(), width, height, tile, tile_h or tile)


def rasterize_visibility_shaded(setup: Dict[str, Tensor], shade_records: Tensor,
                                tile_tris: Tensor, counts: Tensor,
                                big_list: Tensor, width: int, height: int,
                                tile: int, tile_h: int = None
                                ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Fused visibility raster and G-buffer finish.

    Returns (vis, gplanes): vis holds depth (H, W) reverse-Z, tri_id (H, W)
    int32 (-1 where empty) and screen barycentrics b0, b1; gplanes is the
    (18, H, W) block of finished G-buffer planes (all zero where empty),
    consumed by gbuffer.shade_gbuffer(gplanes=...).

    Each tile scans the shared big list, then its own list; see BITREV16
    for the order among equal depths. CUDA tensors run the hand-written
    kernel and CPU tensors the plain version; `launches` counts kernel
    launches."""
    args = kernel_args(setup, shade_records, tile_tris, counts, big_list,
                       width, height, tile, tile_h)
    return _on_device("rasterize_visibility_shaded", args[0], raster_shade_cuda,
                      raster_shade_plain)(*args)


rasterize_visibility_shaded.launches = 0


# -- visibility raster without shading (the refraction pass) -------------------

def visibility_cuda(edge: Tensor, tile_tris: Tensor, counts: Tensor,
                    big_list: Tensor, width: int, height: int, tile: int,
                    tile_h: int, kept: Tensor = None) -> Dict[str, Tensor]:
    """Launch the visibility kernel (csrc/raster_shade.cu, raster_shade's
    scan and cull without its shading phase); same inputs and outputs as
    `visibility_plain`; `kept` as in `raster_shade_cuda`."""
    from garden_tpu_torch import cuda_build

    dev, tiles_x, n_tiles, smem = _raster_checks(
        "visibility", edge, tile_tris, counts, big_list, width, height, tile,
        tile_h, kept)
    if big_list.shape[0] % TRI_BLOCK or tile_tris.shape[1] % TRI_BLOCK:
        raise ValueError("visibility: lists must have 16k slots")
    vis = _vis_outputs(height, width, dev)
    _call(cuda_build.load("raster_shade").visibility_launch,
          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 5,
          "visibility", dev,
          _ptr(edge), _ptr(tile_tris), _ptr(counts), _ptr(big_list),
          big_list.shape[0], tile_tris.shape[1], n_tiles,
          tiles_x, tile, tile_h, width, height, smem,
          *[_ptr(vis[k]) for k in ("depth", "tri_id", "b0", "b1")],
          _kept_ptr(kept))
    rasterize_visibility.launches += 1
    return vis


def visibility_args(setup: Dict[str, Tensor], tile_tris: Tensor, counts: Tensor,
                    big_list: Tensor, width: int, height: int, tile: int,
                    tile_h: int = None) -> tuple:
    """The positional arguments of visibility_cuda / visibility_plain: edge
    records, the tile lists and the big list each padded to 16-slot blocks
    (the TPU kernel's big block and tile block), the frame and tile sizes."""
    return (_pack_edge_records(setup), _pad_slots(tile_tris),
            counts.int().contiguous(), _pad_slots(big_list[None, :])[0],
            width, height, tile, tile_h or tile)


def rasterize_visibility(setup: Dict[str, Tensor], tile_tris: Tensor,
                         counts: Tensor, big_list: Tensor, width: int,
                         height: int, tile: int, tile_h: int = None
                         ) -> Dict[str, Tensor]:
    """Visibility buffer: depth (H, W) reverse-Z, tri_id (H, W) int32 (-1
    where empty) and screen barycentrics b0, b1. Each tile scans the shared
    big list, then its own list, with the tie order of BITREV16. CUDA
    tensors launch the visibility kernel, CPU tensors take
    `visibility_plain`; `launches` counts kernel launches."""
    args = visibility_args(setup, tile_tris, counts, big_list, width, height,
                           tile, tile_h)
    return _on_device("rasterize_visibility", args[0], visibility_cuda,
                      visibility_plain)(*args)


rasterize_visibility.launches = 0


def render_pass(clip: Tensor, indices: Tensor, tri_valid: Tensor, width: int,
                height: int, tile: int, max_per_tile: int
                ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """A whole visibility pass from a clip-space vertex pool (V, 4): setup,
    slot binning on square tiles of `tile` pixels (footprint FOOT, the
    default 64-slot big list), then the visibility raster (kernel K5 on a
    CUDA tensor) -> (vis, setup)."""
    setup = setup_triangles(clip, indices, tri_valid, width, height)
    tile_tris, counts, big = bin_triangles(setup, width, height, tile, max_per_tile)
    return rasterize_visibility(setup, tile_tris, counts, big, width, height, tile), setup


# -- ordered alpha blend (the sorted pass and the translucent shadow tint) -----

def pack_blend_records(setup: Dict[str, Tensor], tri_rgba: Tensor,
                       tri_atlas: Tensor = None) -> Tensor:
    """(T + 1, 16) records in vertex form: [x0 y0 x1 y1 x2 y2 | z0 z1 z2 |
    inv_area | id | r g b a | atlas]; row T is a sentinel (id -1, alpha 0)."""
    sx, sy, z = setup["sx"], setup["sy"], setup["z"]
    t = sx.shape[1]
    dev = sx.device
    atlas = (tri_atlas.float() if tri_atlas is not None
             else torch.zeros(t, device=dev))
    rec = torch.cat([torch.stack([sx[0], sy[0], sx[1], sy[1], sx[2], sy[2],
                                  z[0], z[1], z[2], setup["inv_area"],
                                  torch.arange(t, dtype=torch.float32, device=dev)],
                                 dim=-1),
                     tri_rgba.float(), atlas[:, None]], dim=-1)
    sentinel = torch.zeros((1, EDGE_WIDTH), device=dev)
    sentinel[0, 10] = -1.0
    return torch.cat([rec, sentinel], dim=0)


def _pad_image(img: Tensor, h_pad: int, w_pad: int, value: float) -> Tensor:
    """(H, W[, C]) -> (h_pad, w_pad[, C]), the new pixels set to `value`."""
    out = torch.full((h_pad, w_pad) + tuple(img.shape[2:]), value,
                     dtype=img.dtype, device=img.device)
    out[:img.shape[0], :img.shape[1]] = img
    return out


def _edges_vertex(d: Tensor, px: Tensor, py: Tensor):
    """The three edge functions of vertex-form records d (rows, 16) at
    pixel centres (rows, n_px), as the TPU blend and OIT kernels write
    them: e0 = (px - x1)(y2 - y1) - (py - y1)(x2 - x1) and rotations."""
    x0, y0, x1, y1, x2, y2 = (d[:, i:i + 1] for i in range(6))
    e0 = (px - x1) * (y2 - y1) - (py - y1) * (x2 - x1)
    e1 = (px - x2) * (y0 - y2) - (py - y2) * (x0 - x2)
    e2 = (px - x0) * (y1 - y0) - (py - y0) * (x1 - x0)
    return e0, e1, e2


def blend_plain(records: Tensor, tile_tris: Tensor, counts: Tensor,
                big_list: Tensor, opaque_depth: Tensor, hdr: Tensor, width: int,
                height: int, tile: int, tile_h: int, atlas_bounds: tuple = (),
                keep: Tensor = None) -> Tensor:
    """Plain version of the sorted_blend kernel: every tile blends the
    shared big list's used blocks, then its own list's blocks, one
    triangle at a time in list order, source-over onto `hdr` (H, W, 3)
    where z >= opaque_depth (reverse-Z), z <= 1 and, with atlas rects,
    inside the record's rect. Empty slots blend nothing. -> (H, W, 3).
    With `keep` (tiles, big + cap) bool, only the slots it marks blend:
    with `tile_slot_keep`'s mask the result is the same, which the tests
    hold; the renderer never passes it."""
    dev = records.device
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile, tile_h)
    h_pad, w_pad = tiles_y * tile_h, tiles_x * tile
    t_count = records.shape[0] - 1
    n_big = big_list.shape[0]
    img = lambda x: _image_tiles(x, tiles_x, tile, tile_h)
    opaque = img(_pad_image(opaque_depth, h_pad, w_pad, 0.0))
    dst = _pad_image(hdr, h_pad, w_pad, 0.0)
    out = [img(dst[..., c].contiguous()) for c in range(3)]
    px, py = _tile_coords(torch.arange(n_tiles, device=dev), tiles_x, tile, tile_h)
    lists = torch.cat([big_list[None, :].expand(n_tiles, -1), tile_tris], dim=1)
    # the scanned slots: the big list's used blocks, then the tile's blocks
    big_end = _blocks_of((big_list >= 0).sum()) * TRI_BLOCK
    grid_end = n_big + _blocks_of(counts) * TRI_BLOCK
    n_scan = n_big + (int(_blocks_of(counts).max()) * TRI_BLOCK if n_tiles else 0)
    for j in range(n_scan):
        ids = lists[:, j]
        scanned = (j < big_end) if j < n_big else (j < grid_end)
        act = (scanned & (ids >= 0))[:, None]
        if keep is not None:
            act = act & keep[:, j:j + 1]
        d = records[torch.where(ids >= 0, ids, t_count).long()]
        e0, e1, e2 = _edges_vertex(d, px, py)
        b0 = e0 * d[:, 9:10]
        b1 = e1 * d[:, 9:10]
        z = b0 * d[:, 6:7] + b1 * d[:, 7:8] + (1.0 - b0 - b1) * d[:, 8:9]
        hit = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z >= opaque) & (z <= 1.0)
               & (d[:, 10:11] >= 0.0))
        if atlas_bounds:
            hit = hit & _atlas_guard(d[:, 15:16], px, py, atlas_bounds)
        a = torch.where(hit, d[:, 14:15], 0.0)
        for c in range(3):
            out[c] = torch.where(act, out[c] * (1.0 - a) + d[:, 11 + c:12 + c] * a,
                                 out[c])
    return torch.stack([_tiles_to_image(o, tiles_y, tiles_x, tile_h, tile, height,
                                        width) for o in out], dim=-1)


def _blend_pixels(kernel: str, tile: int, tile_h: int, allowed: tuple) -> int:
    """Pixels a thread owns in a tile of the sorted_blend kernel, one of
    `allowed`: the tile's width must divide the block's 256 threads."""
    n_px = tile * tile_h
    p = n_px // _THREADS
    if _THREADS % tile or n_px % _THREADS or p not in allowed:
        raise ValueError(f"{kernel}: a {tile}x{tile_h} tile is not a kernel "
                         f"shape (the width must divide {_THREADS} and each "
                         f"thread takes one of {allowed} pixels)")
    return p


@functools.lru_cache(maxsize=32)
def _rects(atlas_bounds: tuple, dev) -> Tensor:
    """The kernels' (n, 4) float32 rect table, x0 x1 y0 y1 a row (one zero
    row when there is none). Kept per (bounds, device): building it copies
    from the host, which would hold the host until the card has finished
    its queue at every launch. The kernels only read it."""
    if len(atlas_bounds) > MAX_ATLAS_RECTS:
        raise ValueError(f"at most {MAX_ATLAS_RECTS} atlas rects")
    return torch.tensor([list(map(float, b)) for b in atlas_bounds] or [[0.0] * 4],
                        dtype=torch.float32, device=dev)


def blend_cuda(records: Tensor, tile_tris: Tensor, counts: Tensor,
               big_list: Tensor, opaque_depth: Tensor, hdr: Tensor, width: int,
               height: int, tile: int, tile_h: int, atlas_bounds: tuple = (),
               kept: Tensor = None) -> Tensor:
    """Launch the sorted_blend kernel (csrc/blend_raster.cu); same inputs and
    output as `blend_plain`. With `kept` (tiles,) int32, the kernel also
    writes each tile's number of slots that pass its cull (the row sums
    of `tile_slot_keep(..., form="vertex")`)."""
    from garden_tpu_torch import cuda_build

    dev = records.device
    if dev.type != "cuda":
        raise ValueError(f"sorted_blend_cuda needs CUDA tensors, got {dev}")
    tiles_x, _, n_tiles = _grid(width, height, tile, tile_h)
    cap, n_big = tile_tris.shape[1], big_list.shape[0]
    if cap % TRI_BLOCK or n_big % TRI_BLOCK:
        raise ValueError("sorted_blend: lists must have 16k slots")
    _check("records", records, torch.float32, (records.shape[0], EDGE_WIDTH), dev,
           "sorted_blend")
    _check("tile_tris", tile_tris, torch.int32, (n_tiles, cap), dev, "sorted_blend")
    _check("counts", counts, torch.int32, (n_tiles,), dev, "sorted_blend")
    _check("big_list", big_list, torch.int32, (n_big,), dev, "sorted_blend")
    _check("opaque_depth", opaque_depth, torch.float32, (height, width), dev,
           "sorted_blend")
    _check("hdr", hdr, torch.float32, (height, width, 3), dev, "sorted_blend")
    _check_kept(kept, n_tiles, dev, "sorted_blend")
    if n_big + cap > MAX_SLOTS:
        raise ValueError(f"sorted_blend: {n_big + cap} list slots, at most {MAX_SLOTS}")
    # row bands of 2048 pixels, one block each, 8 pixels a thread
    bands = _blend_pixels("sorted_blend", tile, tile_h, (8, 16)) // 8
    rects = _rects(atlas_bounds, dev)
    out = torch.empty_like(hdr)
    # shared memory: the band's hdr rows and opaque depth, then the records
    smem = _smem_bytes("sorted_blend", n_big + cap, tile * tile_h // bands * 4 * 4)
    _call(cuda_build.load("blend_raster").sorted_blend_launch,
          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
          + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int],
          "sorted_blend", dev,
          _ptr(records), _ptr(tile_tris), _ptr(counts), _ptr(big_list),
          _ptr(opaque_depth), _ptr(hdr), cap, n_big, n_tiles, tiles_x, tile, tile_h,
          width, height, bands, _ptr(rects), len(atlas_bounds), _ptr(out),
          _kept_ptr(kept), smem)
    rasterize_sorted_blend.launches += 1
    return out


def blend_args(setup: Dict[str, Tensor], tri_rgba: Tensor, tile_tris: Tensor,
               counts: Tensor, big_list: Tensor, opaque_depth: Tensor, hdr: Tensor,
               width: int, height: int, tile: int, atlas_bounds: tuple = (),
               tri_atlas: Tensor = None, tile_h: int = None) -> tuple:
    """The positional arguments of blend_cuda / blend_plain."""
    return (pack_blend_records(setup, tri_rgba, tri_atlas), _pad_slots(tile_tris),
            counts.int().contiguous(), _pad_slots(big_list[None, :])[0],
            opaque_depth.float().contiguous(), hdr.float().contiguous(), width,
            height, tile, tile_h or tile, tuple(tuple(b) for b in atlas_bounds))


def rasterize_sorted_blend(setup: Dict[str, Tensor], tri_rgba: Tensor,
                           tile_tris: Tensor, counts: Tensor, big_list: Tensor,
                           opaque_depth: Tensor, hdr: Tensor, width: int,
                           height: int, tile: int, atlas_bounds: tuple = (),
                           tri_atlas: Tensor = None, tile_h: int = None) -> Tensor:
    """Alpha-blend binned triangles (T, 4) rgba over the HDR (H, W, 3) in bin
    order: the big list first, then each tile's list (back-to-front when
    binned with a depth priority), z-tested against the opaque reverse-Z
    depth. `atlas_bounds` + `tri_atlas` clip each triangle to its
    cascade's rect. CUDA tensors launch the sorted_blend kernel, CPU
    tensors take `blend_plain`; `launches` counts kernel launches."""
    args = blend_args(setup, tri_rgba, tile_tris, counts, big_list, opaque_depth,
                      hdr, width, height, tile, atlas_bounds, tri_atlas, tile_h)
    return _on_device("rasterize_sorted_blend", args[0], blend_cuda,
                      blend_plain)(*args)


rasterize_sorted_blend.launches = 0


# -- depth-only raster (the shadow cascades) ----------------------------------
#
# Three kernels share one inner loop: per list slot and pixel, the edge test,
# the interpolated reverse-Z and a max-reduce. `depth_dense` (one pass: the
# shared big list, then each tile's list) and the split pair `depth_super`
# (every tile draws its super-tile's big list) + `depth_grid` (the active
# tiles merge their lists onto that result in place). Each has a plain
# PyTorch version, which CPU tensors take, and a CUDA kernel in
# csrc/depth_raster.cu, which CUDA tensors launch.

DEPTH_THREADS = 256
DEPTH_WARPS = DEPTH_THREADS // 32
MAX_ATLAS_RECTS = 8
MAX_SLOTS = 1024       # list slots of one sorted_blend / depth_dense / depth_grid tile


def _pad_slots(lists: Tensor) -> Tensor:
    """(rows, C) int32 lists padded with -1 to a multiple of TRI_BLOCK."""
    pad = (-lists.shape[-1]) % TRI_BLOCK
    return torch.nn.functional.pad(lists.int(), (0, pad), value=-1).contiguous()


def _bound_table(records: Tensor, lists: Tensor) -> Tensor:
    """(rows, nb + 1) early-exit bounds of (rows, nb * 16) lists: column cb
    is the largest zmax = z2 + max(dz0, dz1, 0) of any record in blocks
    cb.. of the row's list (a suffix max over 16-slot blocks), and the
    last column is -1. A tile whose every pixel is already at depth >=
    bound[cb + 1] after block cb cannot gain from the rest."""
    t_count = records.shape[0] - 1
    zmax = records[:, 10] + torch.clamp(
        torch.maximum(records[:, 11], records[:, 12]), min=0.0)
    rz = torch.where(lists >= 0, zmax[torch.where(lists >= 0, lists, t_count).long()],
                     -1.0)
    rows = lists.shape[0]
    blk = rz.reshape(rows, -1, TRI_BLOCK).amax(dim=2)
    suffix = torch.cummax(blk.flip(1), dim=1).values.flip(1)
    return torch.cat([suffix, torch.full((rows, 1), -1.0, device=lists.device)],
                     dim=1).contiguous()


def _image_tiles(img: Tensor, tiles_x: int, tile: int, th: int) -> Tensor:
    """A padded (tiles_y * th, tiles_x * tile) image -> (tiles, th * tile)."""
    tiles_y = img.shape[0] // th
    return img.reshape(tiles_y, th, tiles_x, tile).transpose(1, 2) \
        .reshape(tiles_y * tiles_x, th * tile)


def _rect_of(idx: Tensor, atlas_bounds: tuple) -> Tuple[Tensor, ...]:
    """(x0, x1, y0, y1) of the rect that each cascade index names (record
    lane 15; the last match wins, as in the kernels), all zero where none
    does."""
    x0a = torch.zeros_like(idx)
    x1a = torch.zeros_like(idx)
    y0a = torch.zeros_like(idx)
    y1a = torch.zeros_like(idx)
    for ci, (x0, x1, y0, y1) in enumerate(atlas_bounds):
        m = idx == float(ci)
        x0a = torch.where(m, float(x0), x0a)
        x1a = torch.where(m, float(x1), x1a)
        y0a = torch.where(m, float(y0), y0a)
        y1a = torch.where(m, float(y1), y1a)
    return x0a, x1a, y0a, y1a


def _atlas_guard(idx: Tensor, px: Tensor, py: Tensor, atlas_bounds: tuple) -> Tensor:
    """Cascade-atlas clip: a record counts only inside the (x0, x1, y0, y1)
    rect of its cascade (record lane 15); an index that names no rect
    covers nothing."""
    x0a, x1a, y0a, y1a = _rect_of(idx, atlas_bounds)
    return (px >= x0a) & (px < x1a) & (py >= y0a) & (py < y1a)


def _depth_candidates(d: Tensor, px: Tensor, py: Tensor, atlas_bounds: tuple
                      ) -> Tuple[Tensor, Tensor]:
    """(depth, inside) of each record d (rows, S, 16, 1) at pixel centres
    (rows, 1, n_px): the reverse-Z depth where the pixel is a candidate, 0
    elsewhere; inside, where its edges and rect hold the pixel."""
    e0 = d[:, :, 0] * px + d[:, :, 3] * py + d[:, :, 6]
    e1 = d[:, :, 1] * px + d[:, :, 4] * py + d[:, :, 7]
    e2 = d[:, :, 9] - e0 - e1
    inv_area = d[:, :, 13]
    z = d[:, :, 10] + e0 * inv_area * d[:, :, 11] + e1 * inv_area * d[:, :, 12]
    inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
    if atlas_bounds:
        inside = inside & _atlas_guard(d[:, :, 15], px, py, atlas_bounds)
    cand = inside & (z <= 1.0) & (z > 0.0) & (d[:, :, 14] >= 0.0)
    return torch.where(cand, z, torch.zeros_like(z)), inside


def _depth_blocks(records: Tensor, lists: Tensor, n_blocks: Tensor,
                  depth: Tensor, px: Tensor, py: Tensor, atlas_bounds: tuple,
                  bound: Tensor = None, work: list = None,
                  keep: Tensor = None, warps: Tensor = None) -> Tensor:
    """Max-merge the 16-slot blocks 0 .. n_blocks - 1 of each row's list
    into depth (rows, n_px). With `bound`, a row stops after block cb once
    its smallest depth is >= bound[:, cb + 1] (the kernels' early exit).
    With `keep` (rows, slots) bool, the slots it does not mark count as
    empty. With `work` (a list), adds to work[0] the (slot, pixel) pairs
    of the non-empty slots the kernels test: a measurement for the
    kernels' bound in chip_smoke.py, which syncs with the host once a
    block; the renderer passes neither. With `warps` (rows, DEPTH_WARPS,
    slots) bool, `warp_keep`'s mask, `work` has four counts, of those pairs
    the ones that depth_super and depth_grid test after their warp cull:
    work[1] those whose warp keeps the slot, work[2] those of them whose
    tile straddles the slot's rect (the kernels test the rect per pixel
    only there) and work[3] those whose pixel is inside."""
    t_count = records.shape[0] - 1
    n_blocks = torch.clamp(n_blocks.long(), max=lists.shape[1] // TRI_BLOCK)
    done = torch.zeros(lists.shape[0], dtype=torch.bool, device=lists.device)
    px, py = px[:, None, :], py[:, None, :]
    for cb in range(int(n_blocks.max()) if n_blocks.numel() else 0):
        blk = slice(cb * TRI_BLOCK, (cb + 1) * TRI_BLOCK)
        ids = lists[:, blk]
        if keep is not None:
            ids = torch.where(keep[:, blk], ids, -1)
        d = records[torch.where(ids >= 0, ids, t_count).long()][..., None]
        zs, inside = _depth_candidates(d, px, py, atlas_bounds)
        zs = torch.amax(zs, dim=1)
        act = (cb < n_blocks) & ~done
        if work is not None:
            walked = (ids >= 0) & act[:, None]
            work[0] += int(walked.sum()) * px.shape[-1]
        if work is not None and warps is not None:
            per_warp = px.shape[-1] // DEPTH_WARPS
            on_warps = (warps[:, :, blk] & walked[:, None, :]).sum(1)     # (rows, 16)
            straddle = (~_atlas_guard(d[:, :, 15], px, py, atlas_bounds).all(-1)
                        if atlas_bounds else torch.zeros_like(walked))
            work[1] += int(on_warps.sum()) * per_warp
            work[2] += int(on_warps[straddle].sum()) * per_warp
            work[3] += int((inside & walked[..., None]).sum())
        depth = torch.where(act[:, None], torch.maximum(depth, zs), depth)
        if bound is not None:
            done = done | (act & (torch.amin(depth, dim=1) >= bound[:, cb + 1]))
    return depth


def _depth_kept(records: Tensor, lists: Tensor, n_blocks: Tensor, keep: Tensor,
                depth: Tensor, px: Tensor, py: Tensor, atlas_bounds: tuple,
                bound: Tensor = None, max_elems: int = 1 << 23) -> Tensor:
    """`_depth_blocks` (without `work`) walking only the (row, slot) pairs
    that `keep` marks, `tile_slot_keep`'s exact cull: a pair it drops
    leaves every pixel's candidate depth 0, and a depth never falls below
    +0.0, so the result is the same in every bit, at the cost of the pairs
    that can reach a pixel."""
    n_blocks = torch.clamp(n_blocks.long(), max=lists.shape[1] // TRI_BLOCK)
    done = torch.zeros(lists.shape[0], dtype=torch.bool, device=lists.device)
    step = max(1, max_elems // px.shape[-1])
    for cb in range(int(n_blocks.max()) if n_blocks.numel() else 0):
        blk = slice(cb * TRI_BLOCK, (cb + 1) * TRI_BLOCK)
        act = (cb < n_blocks) & ~done
        ids = lists[:, blk]
        pairs = torch.nonzero(keep[:, blk] & (ids >= 0) & act[:, None])
        zmax = torch.zeros_like(depth)
        for p0 in range(0, pairs.shape[0], step):
            r, sl = pairs[p0:p0 + step, 0], pairs[p0:p0 + step, 1]
            d = records[ids[r, sl].long()]
            zs, _ = _depth_candidates(d[:, None, :, None], px[r][:, None, :],
                                      py[r][:, None, :], atlas_bounds)
            zmax.scatter_reduce_(0, r[:, None].expand(-1, zs.shape[-1]), zs[:, 0], "amax")
        depth = torch.where(act[:, None], torch.maximum(depth, zmax), depth)
        if bound is not None:
            done = done | (act & (torch.amin(depth, dim=1) >= bound[:, cb + 1]))
    return depth


def _blocks_of(counts: Tensor) -> Tensor:
    return torch.div(counts.long() + TRI_BLOCK - 1, TRI_BLOCK, rounding_mode="floor")


def super_lists(sup_tris: Tensor, sup_counts: Tensor, sup_grid: tuple, width: int,
                height: int, tile: int, tile_h: int) -> Tuple[Tensor, Tensor]:
    """The super-tile lists on the tile grid: row t is the list and count of
    tile t's super-tile, as depth_super walks it -> (lists (tiles, cap),
    counts (tiles,)). `tile_slot_keep(..., form="edge")` over them (no big
    list) is depth_super's cull."""
    sup_x, sup_y, sups_x = sup_grid
    tiles_x, _, n_tiles = _grid(width, height, tile, tile_h)
    t = torch.arange(n_tiles, device=sup_tris.device)
    sup = (torch.div(t, tiles_x * sup_y, rounding_mode="floor") * sups_x
           + torch.div(t % tiles_x, sup_x, rounding_mode="floor"))
    return sup_tris[sup], sup_counts[sup]


def depth_super_plain(records: Tensor, sup_tris: Tensor, sup_counts: Tensor,
                      sup_grid: tuple, width: int, height: int, tile: int,
                      tile_h: int, atlas_bounds: tuple = (),
                      max_elems: int = 1 << 23, work: list = None,
                      keep: Tensor = None, warps: Tensor = None) -> Tensor:
    """Split pass 1, plain version of the depth_super kernel: every tile
    max-reduces its super-tile's big list. -> the padded depth image
    (tiles_y * tile_h, tiles_x * tile). Tiles run in chunks whose
    (tiles, 16, pixels) temporaries stay under `max_elems` elements;
    `work` and `warps` count as in `_depth_blocks`. With `keep` (tiles,
    cap) bool over `super_lists`, only the slots it marks are drawn
    (`tile_slot_keep`'s mask gives the same result; the renderer never
    passes it)."""
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile, tile_h)
    lists, counts = super_lists(sup_tris, sup_counts, sup_grid, width, height, tile,
                                tile_h)
    n_px = tile * tile_h
    dev = records.device
    out = torch.zeros((n_tiles, n_px), device=dev)
    step = max(1, max_elems // (TRI_BLOCK * n_px))
    for t0 in range(0, n_tiles, step):
        tiles = torch.arange(t0, min(t0 + step, n_tiles), device=dev)
        px, py = _tile_coords(tiles, tiles_x, tile, tile_h)
        out[tiles] = _depth_blocks(records, lists[tiles], _blocks_of(counts[tiles]),
                                   out[tiles], px, py, atlas_bounds, work=work,
                                   keep=None if keep is None else keep[tiles],
                                   warps=None if warps is None else warps[tiles])
    return _tiles_to_image(out, tiles_y, tiles_x, tile_h, tile, tiles_y * tile_h,
                           tiles_x * tile)


def depth_grid_plain(depth: Tensor, records: Tensor, act_ids: Tensor,
                     act_cnt: Tensor, tile_tris: Tensor, bound: Tensor,
                     width: int, height: int, tile: int, tile_h: int,
                     atlas_bounds: tuple = (), max_elems: int = 1 << 23,
                     work: list = None, keep: Tensor = None,
                     warps: Tensor = None) -> Tensor:
    """Split pass 2, plain version of the depth_grid kernel: row i of the
    compacted lists belongs to tile act_ids[i], whose pixels of the padded
    `depth` image it max-merges its list onto, with the early exit. Updates
    `depth` in place and returns it; other tiles keep their values. `work`
    and `warps` count as in `_depth_blocks`. With `keep` (rows, cap) bool, only the
    slots it marks are drawn (`tile_slot_keep(..., tiles=act_ids)` gives
    the same result; the renderer never passes it)."""
    tiles_x, _, _ = _grid(width, height, tile, tile_h)
    n_px = tile * tile_h
    img = _image_tiles(depth, tiles_x, tile, tile_h).clone()
    rows = act_ids.shape[0]
    step = max(1, max_elems // (TRI_BLOCK * n_px))
    for r0 in range(0, rows, step):
        r = torch.arange(r0, min(r0 + step, rows), device=depth.device)
        tiles = act_ids[r].long()
        px, py = _tile_coords(tiles, tiles_x, tile, tile_h)
        img[tiles] = _depth_blocks(records, tile_tris[r], _blocks_of(act_cnt[r]),
                                   img[tiles], px, py, atlas_bounds, bound[r], work,
                                   None if keep is None else keep[r],
                                   None if warps is None else warps[r])
    depth.copy_(_tiles_to_image(img, depth.shape[0] // tile_h, tiles_x, tile_h,
                                tile, depth.shape[0], depth.shape[1]))
    return depth


def depth_dense_plain(records: Tensor, tile_tris: Tensor, counts: Tensor,
                      big_list: Tensor, bound: Tensor, width: int, height: int,
                      tile: int, tile_h: int, atlas_bounds: tuple = (),
                      max_elems: int = 1 << 23, work: list = None,
                      keep: Tensor = None) -> Tensor:
    """Plain version of the depth_dense kernel: every tile max-reduces the
    shared big list, then its own list with the early exit. -> the padded
    depth image; `work` counts as in `_depth_blocks`. With `keep` (tiles,
    big + cap) bool, only the slots it marks are drawn: with
    `tile_slot_keep`'s mask the result is the same, which the tests hold;
    the renderer never passes it."""
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile, tile_h)
    n_px = tile * tile_h
    n_big = big_list.shape[0]
    dev = records.device
    out = torch.zeros((n_tiles, n_px), device=dev)
    big_blocks = _blocks_of((big_list >= 0).sum())
    step = max(1, max_elems // (TRI_BLOCK * n_px))
    for t0 in range(0, n_tiles, step):
        tiles = torch.arange(t0, min(t0 + step, n_tiles), device=dev)
        px, py = _tile_coords(tiles, tiles_x, tile, tile_h)
        kb, kg = (None, None) if keep is None else (keep[tiles, :n_big],
                                                      keep[tiles, n_big:])
        d = _depth_blocks(records, big_list[None, :].expand(len(tiles), -1),
                          big_blocks.expand(len(tiles)), out[tiles], px, py,
                          atlas_bounds, work=work, keep=kb)
        out[tiles] = _depth_blocks(records, tile_tris[tiles], _blocks_of(counts[tiles]),
                                   d, px, py, atlas_bounds, bound[tiles], work, kg)
    return _tiles_to_image(out, tiles_y, tiles_x, tile_h, tile, tiles_y * tile_h,
                           tiles_x * tile)


def depth_dense_culled(records: Tensor, tile_tris: Tensor, counts: Tensor,
                       big_list: Tensor, bound: Tensor, width: int, height: int,
                       tile: int, tile_h: int, atlas_bounds: tuple = (),
                       max_elems: int = 1 << 23) -> Tensor:
    """`depth_dense_plain`'s result, walking only the (tile, slot) pairs
    that `tile_slot_keep` keeps, as the kernel does (`_depth_kept`): the
    CPU path of `depth_dense`, which a frame with a few large casters over
    a big atlas would otherwise spend on pairs that cannot reach a pixel."""
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile, tile_h)
    n_big = big_list.shape[0]
    dev = records.device
    kept = tile_slot_keep(records, tile_tris, counts, big_list, width, height, tile,
                          tile_h, atlas_bounds, form="edge")
    px, py = _tile_coords(torch.arange(n_tiles, device=dev), tiles_x, tile, tile_h)
    out = torch.zeros((n_tiles, tile * tile_h), device=dev)
    out = _depth_kept(records, big_list[None, :].expand(n_tiles, -1),
                      _blocks_of((big_list >= 0).sum()).expand(n_tiles), kept[:, :n_big],
                      out, px, py, atlas_bounds, max_elems=max_elems)
    out = _depth_kept(records, tile_tris, _blocks_of(counts), kept[:, n_big:], out, px, py,
                      atlas_bounds, bound, max_elems)
    return _tiles_to_image(out, tiles_y, tiles_x, tile_h, tile, tiles_y * tile_h,
                           tiles_x * tile)


# -- the exact per-tile slot cull of the raster kernels ------------------------
#
# Rounding to nearest is monotone, so each edge function, evaluated with the
# kernels' own float operations in their order, is monotone in px and in py
# separately, in the directions that the signs of its coefficients give.
# Its largest value over a tile's pixel centres is that same expression at
# one corner centre: where it is < 0, the slot covers no pixel of the tile
# and cannot change it (the blend adds c * 0 to o * 1, the depth max takes
# max(d, 0) with d >= 0, the OIT adds c * 0 to sums that are never -0.0 and
# multiplies reveal by 1, and the nearest-hit raster never makes the slot a
# candidate, so no winner changes, ties included). A NaN corner value keeps
# the slot.


def _tile_corners(tiles: Tensor, tiles_x: int, tile: int, tile_h: int):
    """(x_lo, x_hi, y_lo, y_hi), each (rows, 1): the first and last pixel
    centres of each of `tiles`, formed as `_tile_coords` forms them."""
    x = ((tiles % tiles_x) * tile).float()[:, None] + 0.5
    y = (torch.div(tiles, tiles_x, rounding_mode="floor") * tile_h).float()[:, None] \
        + 0.5
    return x, x + float(tile - 1), y, y + float(tile_h - 1)


def _warp_corners(tiles: Tensor, tiles_x: int, tile: int, tile_h: int):
    """(x_lo, x_hi, y_lo, y_hi), each (rows * DEPTH_WARPS, 1): the bounding
    rect of the pixel centres of each warp of the depth kernels' 256-thread
    block in each of `tiles`, a tile's warps consecutive, formed as the
    kernels' `warp_corners` forms them (a thread holds one column and
    every (256 / tile)-th row of it)."""
    rstep = DEPTH_THREADS // tile
    t0 = torch.arange(DEPTH_WARPS, device=tiles.device) * 32
    t1 = t0 + 31
    wide = tile >= 32                     # a warp's lanes share one first row
    x0, x1 = (t0 % tile, t1 % tile) if wide else (t0 * 0, t0 * 0 + tile - 1)
    y0 = torch.div(t0, tile, rounding_mode="floor")
    y1 = (torch.div(t1, tile, rounding_mode="floor")
          + (tile * tile_h // DEPTH_THREADS - 1) * rstep)
    tx = ((tiles.long() % tiles_x) * tile)[:, None]
    ty = (torch.div(tiles.long(), tiles_x, rounding_mode="floor") * tile_h)[:, None]
    return tuple((o + c[None, :]).reshape(-1, 1).float() + 0.5
                 for o, c in ((tx, x0), (tx, x1), (ty, y0), (ty, y1)))


def _vertex_edge_max(xa, ya, xb, yb, x_lo, x_hi, y_lo, y_hi) -> Tensor:
    """Largest value over the tile of the vertex-form edge (px - xa)(yb -
    ya) - (py - ya)(xb - xa), as the blend kernel evaluates it."""
    a = yb - ya
    b = xb - xa
    px = torch.where(a >= 0, x_hi, x_lo)
    py = torch.where(b >= 0, y_lo, y_hi)
    return (px - xa) * a - (py - ya) * b


def _edge_extreme(a, b, c, x_lo, x_hi, y_lo, y_hi, largest: bool) -> Tensor:
    """Largest (or smallest) value over the tile of the edge-form edge a px
    + b py + c, as the depth kernels evaluate it."""
    px = torch.where((a >= 0) == largest, x_hi, x_lo)
    py = torch.where((b >= 0) == largest, y_hi, y_lo)
    return a * px + b * py + c


def tile_slot_keep(records: Tensor, lists: Tensor, counts: Tensor, big_list: Tensor,
                   width: int, height: int, tile: int, tile_h: int,
                   atlas_bounds: tuple = (), form: str = "vertex",
                   tiles: Tensor = None, corners: tuple = None) -> Tensor:
    """The kernels' exact slot cull: (rows, big + cap) bool over the scanned
    slots of each row of `lists` (the big list's used 16-slot blocks, then
    the row's own blocks), True where the slot names a triangle that may
    reach a pixel centre of the row's tile: no edge's largest value over
    the tile is < 0 (for e2 of the edge form, S - min e0 - min e1 bounds
    it) and, with atlas rects, the tile meets the record's rect. Row i
    belongs to tile tiles[i] of the tile x tile_h grid (default: tile i).
    Form "vertex" (`pack_blend_records`, `oit.pack_oit_records`):
    sorted_blend, and oit on its band grid (`oit.band_keep`). Form "edge"
    (`_pack_edge_records`): depth_dense; depth_super over `super_lists`
    with no big list; depth_grid over its active rows, tiles = act_ids;
    raster_shade and visibility on their band grid (`band_args`;
    raster_shade scans the whole big list, whose holes are -1 and come
    last, so with a 16k-slot big list the named slots are the same). The
    kernels' `kept` output is its row sums; their plain versions take it
    as `keep`. With `corners` ((x_lo, x_hi, y_lo, y_hi), each (rows, 1)),
    row i is culled against that rect of pixel centres instead of its
    tile (`warp_keep`)."""
    tiles_x, _, _ = _grid(width, height, tile, tile_h)
    dev = records.device
    t_count = records.shape[0] - 1
    rows, (n_big, cap) = lists.shape[0], (big_list.shape[0], lists.shape[1])
    if tiles is None:
        tiles = torch.arange(rows, device=dev)
    ids = torch.cat([big_list[None, :].expand(rows, -1), lists], dim=1)
    slot = torch.arange(n_big + cap, device=dev)[None, :]
    big_end = torch.clamp(_blocks_of((big_list >= 0).sum()), max=n_big // TRI_BLOCK)
    grid_end = torch.clamp(_blocks_of(counts), max=cap // TRI_BLOCK)[:, None]
    scanned = torch.where(slot < n_big, slot < big_end * TRI_BLOCK,
                          slot - n_big < grid_end * TRI_BLOCK)
    d = records[torch.where(ids >= 0, ids, t_count).long()]      # (rows, S, 16)
    lane = lambda i: d[..., i]
    if corners is None:
        corners = _tile_corners(tiles.long(), tiles_x, tile, tile_h)
    if form == "vertex":
        x0, y0, x1, y1, x2, y2 = (lane(i) for i in range(6))
        e_max = [_vertex_edge_max(x1, y1, x2, y2, *corners),
                 _vertex_edge_max(x2, y2, x0, y0, *corners),
                 _vertex_edge_max(x0, y0, x1, y1, *corners)]
    elif form == "edge":
        ext = lambda k, largest: _edge_extreme(lane(k), lane(3 + k), lane(6 + k),
                                               *corners, largest)
        e_max = [ext(0, True), ext(1, True),
                 lane(9) - ext(0, False) - ext(1, False)]
    else:
        raise ValueError(f"tile_slot_keep: form must be 'vertex' or 'edge', got {form!r}")
    keep = scanned & (ids >= 0)
    for e in e_max:
        keep = keep & ~(e < 0)
    if atlas_bounds:
        x_lo, x_hi, y_lo, y_hi = corners
        rx0, rx1, ry0, ry1 = _rect_of(lane(15), atlas_bounds)
        keep = keep & (x_hi >= rx0) & (x_lo < rx1) & (y_hi >= ry0) & (y_lo < ry1)
    return keep


def warp_keep(records: Tensor, lists: Tensor, counts: Tensor, width: int,
              height: int, tile: int, tile_h: int, atlas_bounds: tuple = (),
              tiles: Tensor = None) -> Tensor:
    """The second cull of depth_super and depth_grid (their `mark_warps`):
    (rows, DEPTH_WARPS, cap) bool, True where slot s of row i's list may
    reach a pixel centre of warp w of its tile (tiles[i], default tile i),
    by `tile_slot_keep`'s edge-form test over that warp's bounding rect
    (`_warp_corners`). A warp inside its tile keeps at most what the tile
    keeps; the kernels skip a survivor on every warp that does not."""
    tiles_x, _, _ = _grid(width, height, tile, tile_h)
    if tiles is None:
        tiles = torch.arange(lists.shape[0], device=lists.device)
    keep = tile_slot_keep(records, lists.repeat_interleave(DEPTH_WARPS, 0),
                          counts.repeat_interleave(DEPTH_WARPS), lists[0, :0], width,
                          height, tile, tile_h, atlas_bounds, "edge",
                          corners=_warp_corners(tiles, tiles_x, tile, tile_h))
    return keep.reshape(lists.shape[0], DEPTH_WARPS, -1)


def _depth_kernel_setup(kernel: str, records: Tensor, tile: int, tile_h: int,
                        atlas_bounds: tuple):
    """Checks shared by the depth kernels' wrappers; -> (library, rects
    tensor (n, 4) as x0 x1 y0 y1, number of rects)."""
    from garden_tpu_torch import cuda_build

    dev = records.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}_cuda needs CUDA tensors, got {dev}")
    _check("records", records, torch.float32, (records.shape[0], EDGE_WIDTH), dev,
           kernel)
    n_px = tile * tile_h
    if (DEPTH_THREADS % tile or n_px % DEPTH_THREADS
            or n_px // DEPTH_THREADS not in (4, 8, 16, 32, 64)):
        raise ValueError(f"{kernel}: a {tile}x{tile_h} tile is not a kernel shape "
                         f"(the width must divide {DEPTH_THREADS} and each thread "
                         "takes 4..64 pixels)")
    return (cuda_build.load("depth_raster"), _rects(atlas_bounds, dev),
            len(atlas_bounds))


def _smem_bytes(kernel: str, slots: int, extra: int = 0) -> int:
    """Dynamic shared memory of a kernel staging `slots` records, plus
    `extra` bytes."""
    smem = slots * EDGE_WIDTH * 4 + extra
    if smem > _MAX_SMEM:
        raise ValueError(f"{kernel}: {slots} list slots need {smem} bytes of "
                         "shared memory")
    return smem


def _check_kept(kept: Tensor, n_tiles: int, dev, kernel: str) -> None:
    if kept is not None:
        _check("kept", kept, torch.int32, (n_tiles,), dev, kernel)


def _kept_ptr(kept: Tensor):
    return ctypes.c_void_p(None if kept is None else kept.data_ptr())


def depth_super_cuda(records: Tensor, sup_tris: Tensor, sup_counts: Tensor,
                     sup_grid: tuple, width: int, height: int, tile: int,
                     tile_h: int, atlas_bounds: tuple = (),
                     kept: Tensor = None) -> Tensor:
    """Launch the depth_super kernel (csrc/depth_raster.cu); same inputs and
    output as `depth_super_plain`. With `kept` (tiles,) int32, the kernel
    also writes each tile's number of slots that pass its cull (the row
    sums of `tile_slot_keep(..., form="edge")` over `super_lists`)."""
    lib, rects, n_rects = _depth_kernel_setup(
        "depth_super", records, tile, tile_h, atlas_bounds)
    sup_x, sup_y, sups_x = sup_grid
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile, tile_h)
    n_sup, cap = sup_tris.shape
    dev = records.device
    if cap % TRI_BLOCK or n_sup != sups_x * -(-tiles_y // sup_y):
        raise ValueError("depth_super: sup_tris must be (n_sup, 16k)")
    _check("sup_tris", sup_tris, torch.int32, (n_sup, cap), dev, "depth_super")
    _check("sup_counts", sup_counts, torch.int32, (n_sup,), dev, "depth_super")
    _check_kept(kept, n_tiles, dev, "depth_super")
    depth = torch.empty((tiles_y * tile_h, tiles_x * tile), device=dev)
    _call(lib.depth_super_launch, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
          + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int], "depth_super", dev,
          _ptr(records), _ptr(sup_tris), _ptr(sup_counts), cap, n_tiles, tiles_x,
          tile, tile_h, sup_x, sup_y, sups_x, _ptr(rects), n_rects, _ptr(depth),
          _kept_ptr(kept), _smem_bytes("depth_super", cap))
    depth_super.launches += 1
    return depth


def depth_grid_cuda(depth: Tensor, records: Tensor, act_ids: Tensor,
                    act_cnt: Tensor, tile_tris: Tensor, bound: Tensor,
                    width: int, height: int, tile: int, tile_h: int,
                    atlas_bounds: tuple = (), kept: Tensor = None) -> Tensor:
    """Launch the depth_grid kernel (csrc/depth_raster.cu), which updates
    `depth` in place; same inputs and result as `depth_grid_plain`. With
    `kept` (rows,) int32, the kernel also writes each active row's number
    of slots that pass its cull (the row sums of `tile_slot_keep(...,
    form="edge", tiles=act_ids)`)."""
    lib, rects, n_rects = _depth_kernel_setup(
        "depth_grid", records, tile, tile_h, atlas_bounds)
    tiles_x, tiles_y, _ = _grid(width, height, tile, tile_h)
    rows, cap = tile_tris.shape
    dev = records.device
    if cap % TRI_BLOCK:
        raise ValueError("depth_grid: tile_tris must have 16k columns")
    if cap > MAX_SLOTS:
        raise ValueError(f"depth_grid: {cap} list slots, at most {MAX_SLOTS}")
    _check("depth", depth, torch.float32, (tiles_y * tile_h, tiles_x * tile), dev,
           "depth_grid")
    _check("act_ids", act_ids, torch.int32, (rows,), dev, "depth_grid")
    _check("act_cnt", act_cnt, torch.int32, (rows,), dev, "depth_grid")
    _check("tile_tris", tile_tris, torch.int32, (rows, cap), dev, "depth_grid")
    _check("bound", bound, torch.float32, (rows, cap // TRI_BLOCK + 1), dev,
           "depth_grid")
    _check_kept(kept, rows, dev, "depth_grid")
    _call(lib.depth_grid_launch, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
          + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int], "depth_grid", dev,
          _ptr(records), _ptr(act_ids), _ptr(act_cnt), _ptr(tile_tris), _ptr(bound),
          cap, rows, tiles_x, tile, tile_h, _ptr(rects), n_rects, _ptr(depth),
          _kept_ptr(kept), _smem_bytes("depth_grid", cap))
    depth_grid.launches += 1
    return depth


def depth_dense_cuda(records: Tensor, tile_tris: Tensor, counts: Tensor,
                     big_list: Tensor, bound: Tensor, width: int, height: int,
                     tile: int, tile_h: int, atlas_bounds: tuple = (),
                     kept: Tensor = None) -> Tensor:
    """Launch the depth_dense kernel (csrc/depth_raster.cu); same inputs and
    output as `depth_dense_plain`. With `kept` (tiles,) int32, the kernel
    also writes each tile's number of slots that pass its cull (the row
    sums of `tile_slot_keep(..., form="edge")`)."""
    lib, rects, n_rects = _depth_kernel_setup(
        "depth_dense", records, tile, tile_h, atlas_bounds)
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile, tile_h)
    cap = tile_tris.shape[1]
    n_big = big_list.shape[0]
    dev = records.device
    if cap % TRI_BLOCK or n_big % TRI_BLOCK:
        raise ValueError("depth_dense: lists must have 16k slots")
    _check("tile_tris", tile_tris, torch.int32, (n_tiles, cap), dev, "depth_dense")
    _check("counts", counts, torch.int32, (n_tiles,), dev, "depth_dense")
    _check("big_list", big_list, torch.int32, (n_big,), dev, "depth_dense")
    _check("bound", bound, torch.float32, (n_tiles, cap // TRI_BLOCK + 1), dev,
           "depth_dense")
    _check_kept(kept, n_tiles, dev, "depth_dense")
    if n_big + cap > MAX_SLOTS:
        raise ValueError(f"depth_dense: {n_big + cap} list slots, at most {MAX_SLOTS}")
    depth = torch.empty((tiles_y * tile_h, tiles_x * tile), device=dev)
    _call(lib.depth_dense_launch, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
          + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int], "depth_dense", dev,
          _ptr(records), _ptr(tile_tris), _ptr(counts), _ptr(big_list), _ptr(bound),
          cap, n_big, n_tiles, tiles_x, tile, tile_h,
          _ptr(rects), n_rects, _ptr(depth), _kept_ptr(kept),
          _smem_bytes("depth_dense", n_big + cap))
    depth_dense.launches += 1
    return depth


def _on_device(name: str, x: Tensor, cuda_fn, plain_fn):
    if x.device.type == "cuda":
        return cuda_fn
    if x.device.type == "cpu":
        return plain_fn
    raise ValueError(f"{name}: no path for device {x.device}")


def depth_super(records: Tensor, *args) -> Tensor:
    """Split pass 1 (`depth_super_plain`): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors; `launches` counts kernel launches."""
    return _on_device("depth_super", records, depth_super_cuda,
                      depth_super_plain)(records, *args)


def depth_grid(depth: Tensor, *args) -> Tensor:
    """Split pass 2 (`depth_grid_plain`), in place on `depth`: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    return _on_device("depth_grid", depth, depth_grid_cuda,
                      depth_grid_plain)(depth, *args)


def depth_dense(records: Tensor, *args) -> Tensor:
    """The one-pass depth raster (`depth_dense_plain`): the CUDA kernel for
    CUDA tensors; for CPU tensors the plain version over the kernel's own
    cull (`depth_dense_culled`, the same bits)."""
    return _on_device("depth_dense", records, depth_dense_cuda,
                      depth_dense_culled)(records, *args)


depth_super.launches = 0
depth_grid.launches = 0
depth_dense.launches = 0


def depth_args(setup: Dict[str, Tensor], tile_tris: Tensor, counts: Tensor,
               big_list: Tensor, width: int, height: int, tile: int,
               atlas_bounds: tuple = (), tri_atlas: Tensor = None,
               tile_h: int = None, sup_bins: tuple = None,
               max_active: int = None, act_ids: Tensor = None) -> Dict[str, tuple]:
    """The kernel arguments of `rasterize_depth`: {"dense": the arguments of
    depth_dense} without sup_bins; otherwise {"super": the arguments of
    depth_super, "grid": those of depth_grid after its depth image}."""
    th = tile_h or tile
    _, _, n_tiles = _grid(width, height, tile, th)
    geo = (width, height, tile, th, tuple(tuple(b) for b in atlas_bounds))
    records = _pack_edge_records(setup, tri_atlas)
    tile_tris = _pad_slots(tile_tris)
    if sup_bins is None:
        return {"dense": (records, tile_tris, counts.int().contiguous(),
                          _pad_slots(big_list[None, :])[0],
                          _bound_table(records, tile_tris)) + geo}
    sup_tris, sup_counts, sup_grid = sup_bins
    if act_ids is None:
        # the most populated tiles, ties to the lower index (lax.top_k)
        a = min(max_active or max(n_tiles // 4, 1), n_tiles)
        act_ids = torch.sort(counts, descending=True, stable=True).indices[:a]
        counts = counts[act_ids]
        tile_tris = tile_tris[act_ids].contiguous()
    return {"super": (records, _pad_slots(sup_tris), sup_counts.int().contiguous(),
                      tuple(sup_grid)) + geo,
            "grid": (records, act_ids.int().contiguous(), counts.int().contiguous(),
                     tile_tris, _bound_table(records, tile_tris)) + geo}


def rasterize_depth(setup: Dict[str, Tensor], tile_tris: Tensor, counts: Tensor,
                    big_list: Tensor, width: int, height: int, tile: int,
                    atlas_bounds: tuple = (), tri_atlas: Tensor = None,
                    tile_h: int = None, sup_bins: tuple = None,
                    max_active: int = None, act_ids: Tensor = None) -> Tensor:
    """Depth-only raster (H, W) of reverse-Z depth, 0 where empty.

    Dense path: every tile draws the shared big list, then its own list.
    With `sup_bins` (bin_big_supertiles), the split path: pass 1 draws each
    tile's super-tile big list, pass 2 merges the lists of the active
    tiles (`act_ids` from the binning's max_active form, or the
    `max_active` most populated) onto it; other tiles lose their list.
    `atlas_bounds` + `tri_atlas` clip each caster to its cascade's rect."""
    a = depth_args(setup, tile_tris, counts, big_list, width, height, tile,
                   atlas_bounds, tri_atlas, tile_h, sup_bins, max_active, act_ids)
    if "dense" in a:
        depth = depth_dense(*a["dense"])
    else:
        depth = depth_grid(depth_super(*a["super"]), *a["grid"])
    return depth[:height, :width]
