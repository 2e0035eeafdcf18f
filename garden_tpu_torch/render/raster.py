"""Software rasterization: triangle setup, tile binning and the fused
visibility + G-buffer raster.

Port of the main-view path of `garden_tpu.render.raster`:

1. `setup_triangles_planes`: clip-space corners -> screen coordinates,
   reverse-Z depth, 1/w, backface and near culls, screen bounds.
2. `bin_triangles`: each small triangle emits (tile, triangle) pairs for
   its tile footprint; one sort by (tile, depth bucket, triangle) gives
   every tile a contiguous run. Triangles with a larger footprint go to a
   short "big" list that every tile draws first.
3. `rasterize_visibility_shaded`: per tile, scan the big list and then the
   tile's own list, keep the nearest hit per pixel, and finish the
   G-buffer planes from the winner's shading record. On a CUDA tensor this
   launches the hand-written kernel `csrc/raster_shade.cu`; on a CPU tensor
   it runs `raster_shade_plain`, the same computation in PyTorch.

Depth is reverse-Z: larger is nearer, 0 is empty.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

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


def bin_triangles(setup: Dict[str, Tensor], width: int, height: int, tile: int,
                  max_per_tile: int, max_big: int = 64,
                  bucket_priority: Tensor = None, foot: int = 4,
                  tile_h: int = None, foot_y: int = None
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (tile_tris (tiles, max_per_tile) int32 padded with -1,
    counts (tiles,) int32, big_list (max_big,) int32 padded with -1);
    tiles are row-major over (tiles_y, tiles_x) tiles of tile x tile_h.

    Triangles spanning more than foot x foot_y tiles go to the big list.
    bucket_priority: optional int[T] in [0, 16); tile entries come out
    ordered by (bucket, triangle id), so overflow drops the last buckets.
    The big list is ordered the same way."""
    th = tile_h or tile
    foot_y = foot_y or foot
    tiles_x = -(-width // tile)
    tiles_y = -(-height // th)
    n_tiles = tiles_x * tiles_y
    t = setup["valid"].shape[0]
    dev = setup["valid"].device

    def span(lo, hi, size, n):
        a = torch.clamp(torch.floor(lo / size).long(), 0, n - 1)
        b = torch.clamp(torch.floor(hi / size).long(), 0, n - 1)
        return a, b - a + 1
    tx0, nx = span(setup["xmin"], setup["xmax"], tile, tiles_x)
    ty0, ny = span(setup["ymin"], setup["ymax"], th, tiles_y)
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
    payload = torch.arange(t, device=dev).expand(foot * foot_y, t).reshape(-1)
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
    last = key_sorted.shape[0] - 1
    gather = start[:, None] + torch.arange(max_per_tile, device=dev)[None, :]
    ok = gather < end[:, None]
    tile_pay = pay_sorted[torch.clamp(gather, 0, last)]
    tile_tris = torch.where(ok, tile_pay, -1).int()
    counts = torch.clamp(end - start, max=max_per_tile).int()

    # big triangles: stride through their run, one entry per triangle
    max_big = min(max_big, t)
    kk = foot * foot_y
    big_cnt = torch.div(edges[n_tiles + 1] - edges[n_tiles], kk, rounding_mode="floor")
    slots = torch.arange(max_big, device=dev)
    big_pay = pay_sorted[torch.clamp(edges[n_tiles] + slots * kk, 0, last)]
    big_list = torch.where(slots < big_cnt, big_pay, -1).int()
    return tile_tris, counts, big_list


def _pack_edge_records(setup: Dict[str, Tensor]) -> Tensor:
    """(T + 1, 16) per-triangle records in edge-coefficient form:
    [a0 a1 a2 | b0 b1 b2 | c0 c1 c2 | S | z2 | dz0 | dz1 | inv_area | id | 0]
    with e_k = a_k px + b_k py + c_k and e0 + e1 + e2 = S. Row T is a
    sentinel (id -1) that empty list slots point at."""
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
    rec = torch.stack(a + b + c + [s_const, z[2], z[0] - z[2], z[1] - z[2],
                                   setup["inv_area"], ids, torch.zeros_like(ids)],
                      dim=-1)
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


def raster_shade_plain(edge: Tensor, shade: Tensor, tile_tris: Tensor,
                       counts: Tensor, big_list: Tensor, width: int,
                       height: int, tile: int, tile_h: int,
                       max_elems: int = 1 << 23
                       ) -> Tuple[Dict[str, Tensor], Tensor]:
    """The plain PyTorch version of the raster_shade kernel (same inputs,
    same tie rule). Tiles are processed in chunks so the (tiles, slots,
    pixels) temporaries stay under `max_elems` elements each."""
    dev = edge.device
    th = tile_h
    tiles_x = -(-width // tile)
    tiles_y = -(-height // th)
    n_tiles = tiles_x * tiles_y
    t_count = edge.shape[0] - 1
    n_px = th * tile
    lists = torch.cat([big_list[None, :].expand(n_tiles, -1), tile_tris], dim=1)
    pad = (-lists.shape[1]) % TRI_BLOCK
    lists = torch.nn.functional.pad(lists, (0, pad), value=-1)
    n_slots = lists.shape[1]
    safe = torch.where(lists >= 0, lists, t_count).long()
    # scan rank of each slot: blocks in order, bit-reversed inside a block
    slot = torch.arange(n_slots, device=dev)
    bitrev = torch.tensor(BITREV16, device=dev)
    rank = slot - slot % TRI_BLOCK + bitrev[slot % TRI_BLOCK]
    slot_of_rank = torch.empty_like(rank)
    slot_of_rank[rank] = slot
    pix = torch.arange(n_px, device=dev)
    col = (pix % tile).float()
    row = torch.div(pix, tile, rounding_mode="floor").float()

    depth = torch.zeros((n_tiles, n_px), device=dev)
    tri_id = torch.full((n_tiles, n_px), -1, dtype=torch.int32, device=dev)
    b0_out = torch.zeros((n_tiles, n_px), device=dev)
    b1_out = torch.zeros((n_tiles, n_px), device=dev)
    planes = torch.zeros((GBUF_PLANES, n_tiles, n_px), device=dev)
    step = max(1, max_elems // (n_slots * n_px))
    for t0 in range(0, n_tiles, step):
        tiles = torch.arange(t0, min(t0 + step, n_tiles), device=dev)
        px = ((tiles % tiles_x) * tile).float()[:, None] + 0.5 + col[None, :]
        py = (torch.div(tiles, tiles_x, rounding_mode="floor") * th).float()[:, None] \
            + 0.5 + row[None, :]
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
        zc = torch.where(cand, z, torch.zeros_like(z))
        best = torch.amax(zc, dim=1)                    # (nt, n_px)
        tie = cand & (zc == best[:, None, :])
        first = torch.amin(torch.where(tie, rank[None, :, None], n_slots), dim=1)
        hit = first < n_slots
        win = slot_of_rank[torch.clamp(first, max=n_slots - 1)]  # (nt, n_px)
        pick = lambda x: torch.gather(x, 1, win[:, None, :])[:, 0]
        zero = torch.zeros_like(best)
        b0w = torch.where(hit, pick(w0), zero)
        b1w = torch.where(hit, pick(w1), zero)
        depth[tiles] = torch.where(hit, best, zero)
        tri_id[tiles] = torch.where(hit, torch.gather(sid, 1, win).int(), -1)
        b0_out[tiles] = b0w
        b1_out[tiles] = b1w
        rec = shade[torch.gather(sid, 1, win)]          # (nt, n_px, REC)
        rec = torch.where(hit[..., None], rec, torch.zeros_like(rec))
        planes[:, tiles] = _finish_gbuffer(lambda i: rec[..., i], b0w, b1w,
                                           px, py, hit)
    img = lambda x: _tiles_to_image(x, tiles_y, tiles_x, th, tile, height, width)
    vis = {"depth": img(depth), "tri_id": img(tri_id), "b0": img(b0_out),
           "b1": img(b1_out)}
    return vis, img(planes)


def _check(name: str, x: Tensor, dtype: torch.dtype, shape: tuple, device):
    if x.device != device:
        raise ValueError(f"raster_shade: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"raster_shade: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"raster_shade: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"raster_shade: {name} is not contiguous")


_THREADS = 256
_MAX_SMEM = 232448     # per-block shared memory limit on Hopper


def raster_shade_cuda(edge: Tensor, shade: Tensor, tile_tris: Tensor,
                      counts: Tensor, big_list: Tensor, width: int,
                      height: int, tile: int, tile_h: int
                      ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Launch the raster_shade CUDA kernel (csrc/raster_shade.cu); same
    inputs and outputs as `raster_shade_plain`."""
    from garden_tpu_torch import cuda_build

    dev = edge.device
    if dev.type != "cuda":
        raise ValueError(f"raster_shade_cuda needs CUDA tensors, got {dev}")
    th = tile_h
    tiles_x = -(-width // tile)
    tiles_y = -(-height // th)
    n_tiles = tiles_x * tiles_y
    t1 = edge.shape[0]
    cap = tile_tris.shape[1]
    n_big = big_list.shape[0]
    _check("edge", edge, torch.float32, (t1, EDGE_WIDTH), dev)
    _check("shade", shade, torch.float32, (t1, shade.shape[1]), dev)
    if shade.shape[1] < 36:
        raise ValueError("raster_shade: shading records need >= 36 channels")
    _check("tile_tris", tile_tris, torch.int32, (n_tiles, cap), dev)
    _check("counts", counts, torch.int32, (n_tiles,), dev)
    _check("big_list", big_list, torch.int32, (n_big,), dev)
    n_px = tile * th
    if n_px % _THREADS or (n_px // _THREADS) not in (4, 8, 16, 32, 64):
        raise ValueError(f"raster_shade: a {tile}x{th} tile is not a kernel "
                         f"shape (pixels per thread must be 4..64)")
    n_slots = -(-(n_big + cap) // TRI_BLOCK) * TRI_BLOCK
    smem = n_slots * (EDGE_WIDTH + 36 + 1) * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"raster_shade: {n_slots} list slots need {smem} bytes "
                         "of shared memory")

    depth = torch.empty((height, width), device=dev)
    tri_id = torch.empty((height, width), dtype=torch.int32, device=dev)
    b0 = torch.empty((height, width), device=dev)
    b1 = torch.empty((height, width), device=dev)
    planes = torch.empty((GBUF_PLANES, height, width), device=dev)
    lib = cuda_build.load("raster_shade")
    fn = lib.raster_shade_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p] * 6)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ptr(edge), ptr(shade), ptr(tile_tris), ptr(counts), ptr(big_list),
             n_big, cap, t1 - 1, shade.shape[1], n_tiles, tiles_x, tile, th,
             width, height, smem,
             ptr(depth), ptr(tri_id), ptr(b0), ptr(b1), ptr(planes),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"raster_shade kernel launch failed: CUDA error {err}")
    rasterize_visibility_shaded.launches += 1
    return {"depth": depth, "tri_id": tri_id, "b0": b0, "b1": b1}, planes


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
    edge = args[0]
    if edge.device.type == "cuda":
        return raster_shade_cuda(*args)
    if edge.device.type == "cpu":
        return raster_shade_plain(*args)
    raise ValueError(f"rasterize_visibility_shaded: no path for device {edge.device}")


rasterize_visibility_shaded.launches = 0
