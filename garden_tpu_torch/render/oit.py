"""Weighted-blended order-independent transparency.

Port of `garden_tpu.render.oit`: translucent triangles accumulate into a
colour-times-weight buffer, a weight sum and a reveal buffer (the product
of 1 - alpha) in front of the opaque depth, with McGuire's depth weight;
a fullscreen composite blends the average colour over the opaque HDR.

`rasterize_oit` walks one flat list per square tile (the big list merged
in front, `raster.merge_big_list`). CUDA tensors launch the hand-written
kernel in `csrc/blend_raster.cu`; CPU tensors take `oit_plain`, the same
computation in PyTorch. The kernel runs each tile as row bands of
`OIT_PIXELS` pixels a thread and culls each band's slots exactly;
`band_keep` is that cull's plain twin.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from garden_tpu_torch.render import raster

Tensor = torch.Tensor

OIT_PIXELS = 4      # pixels a thread of the OIT kernel (csrc kOitPixels)


def pack_oit_records(setup: Dict[str, Tensor], tri_colors: Tensor) -> Tensor:
    """(T + 1, 16) records [x0 y0 x1 y1 x2 y2 | z0 z1 z2 | inv_area | r g b
    a | 0 0]; row T is an all-zero sentinel (alpha 0 accumulates nothing)."""
    sx, sy, z = setup["sx"], setup["sy"], setup["z"]
    t = sx.shape[1]
    rec = torch.cat([torch.stack([sx[0], sy[0], sx[1], sy[1], sx[2], sy[2],
                                  z[0], z[1], z[2], setup["inv_area"]], dim=-1),
                     tri_colors.float(), torch.zeros((t, 2), device=sx.device)],
                    dim=-1)
    return torch.cat([rec, torch.zeros((1, raster.EDGE_WIDTH), device=sx.device)])


def band_rows(tile: int) -> int:
    """Rows of one row band of the OIT kernel's square tiles (a band is
    one thread block: 256 threads of OIT_PIXELS pixels of one column)."""
    band = raster._THREADS * OIT_PIXELS
    if raster._THREADS % tile or (tile * tile) % band:
        raise ValueError(f"oit: a {tile}x{tile} tile is not a kernel shape (the "
                         f"width must divide {raster._THREADS} and the pixels be a "
                         f"multiple of {band})")
    return band // tile


def band_lists(tile_tris: Tensor, counts: Tensor, width: int, height: int,
               tile: int) -> Tuple[Tensor, Tensor]:
    """The merged lists on the OIT kernel's band grid: ceil(height / rows)
    rows of band_rows(tile) pixel rows by tiles_x, each band taking its
    tile's list with the slots from `count` on set to -1 (the kernel walks
    slots [0, count)), padded to 16-slot blocks -> (lists (bands, C16),
    counts (bands,)). Bands wholly below the frame store nothing and are
    not in the grid (`raster.band_lists`)."""
    slot = torch.arange(tile_tris.shape[1], device=tile_tris.device)
    lists = torch.where(slot[None, :] < counts[:, None], tile_tris, -1)
    lists, n = raster.band_lists(lists, torch.clamp(counts, max=tile_tris.shape[1]),
                                 width, height, tile, tile, band_rows(tile))
    return raster._pad_slots(lists), n.int().contiguous()


def band_keep(records: Tensor, tile_tris: Tensor, counts: Tensor, width: int,
              height: int, tile: int) -> Tensor:
    """The OIT kernel's cull: `raster.tile_slot_keep(..., form="vertex")`
    over the band grid's lists (`band_lists`), with an empty big list ->
    (bands, C16) bool; the kernel's `kept` is its row sums."""
    lists, n = band_lists(tile_tris, counts, width, height, tile)
    empty = torch.zeros((0,), dtype=torch.int32, device=lists.device)
    return raster.tile_slot_keep(records, lists, n, empty, width, height, tile,
                                 band_rows(tile), (), "vertex")


def oit_plain(records: Tensor, tile_tris: Tensor, counts: Tensor,
              opaque_depth: Tensor, width: int, height: int, tile: int,
              keep: Tensor = None, work: list = None) -> Tuple[Tensor, Tensor]:
    """Plain version of the OIT kernel: each square tile walks its merged
    list, slots [0, count), one triangle at a time (sentinel slots
    included), accumulating in front of the opaque depth (padded past the
    frame with 2.0). -> (accum (H, W, 4), reveal (H, W)). With `keep`
    (bands, C16) bool on the band grid, a band takes only the slots it
    marks: with `band_keep`'s mask the result is the same, which the tests
    hold; the renderer never passes it. With `work` (a one-element list),
    adds to work[0] the (slot, pixel) pairs inside the frame whose pixel
    lies inside the triangle the slot names: the only pairs whose depth,
    weight and sums can change a pixel. Measurement only."""
    dev = records.device
    tiles_x, tiles_y, n_tiles = raster._grid(width, height, tile, tile)
    t_count = records.shape[0] - 1
    opaque = raster._image_tiles(raster._pad_image(
        opaque_depth, tiles_y * tile, tiles_x * tile, 2.0), tiles_x, tile, tile)
    px, py = raster._tile_coords(torch.arange(n_tiles, device=dev), tiles_x, tile, tile)
    in_frame = (px < width) & (py < height)
    acc = [torch.zeros_like(px) for _ in range(4)]
    reveal = torch.ones_like(px)
    n_scan = int(counts.max()) if n_tiles else 0
    if keep is not None:
        # (tiles, bands of the tile, slots); bands past the grid take nothing
        rows = band_rows(tile)
        n_sub = tile // rows
        kb = torch.zeros((tiles_y * n_sub, tiles_x, keep.shape[1]), dtype=torch.bool,
                         device=dev)
        kb[:keep.shape[0] // tiles_x] = keep.reshape(-1, tiles_x, keep.shape[1])
        kb = kb.reshape(tiles_y, n_sub, tiles_x, -1).transpose(1, 2) \
            .reshape(n_tiles, n_sub, -1)
    for j in range(n_scan):
        ids = tile_tris[:, j]
        act = (j < counts)[:, None]
        if keep is not None:
            act = act & kb[:, :, j, None].expand(-1, -1, rows * tile).reshape(n_tiles, -1)
        d = records[torch.where(ids >= 0, ids, t_count).long()]
        e0, e1, e2 = raster._edges_vertex(d, px, py)
        inv_area = d[:, 9:10]
        z = (e0 * inv_area * d[:, 6:7] + e1 * inv_area * d[:, 7:8]
             + e2 * inv_area * d[:, 8:9])
        inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
        vis = inside & (z >= opaque) & (z <= 1.0)
        if work is not None:
            work[0] += int((inside & act & in_frame & (ids >= 0)[:, None]).sum())
        alpha = d[:, 13:14]
        wv = torch.where(vis, torch.clamp(z * z * 10.0 + 0.01, 0.01, 30.0) * alpha,
                         0.0)
        for c in range(3):
            acc[c] = torch.where(act, acc[c] + d[:, 10 + c:11 + c] * wv, acc[c])
        acc[3] = torch.where(act, acc[3] + wv, acc[3])
        reveal = torch.where(act, reveal * torch.where(vis, 1.0 - alpha, 1.0), reveal)
    img = lambda x: raster._tiles_to_image(x, tiles_y, tiles_x, tile, tile, height,
                                           width)
    return torch.stack([img(a) for a in acc], dim=-1), img(reveal)


def oit_cuda(records: Tensor, tile_tris: Tensor, counts: Tensor,
             opaque_depth: Tensor, width: int, height: int, tile: int,
             kept: Tensor = None) -> Tuple[Tensor, Tensor]:
    """Launch the OIT kernel (csrc/blend_raster.cu); same inputs and outputs
    as `oit_plain`. With `kept` (bands,) int32 on the band grid, the kernel
    also writes each band's number of slots that pass its cull (the row
    sums of `band_keep`)."""
    from garden_tpu_torch import cuda_build

    dev = records.device
    if dev.type != "cuda":
        raise ValueError(f"oit_cuda needs CUDA tensors, got {dev}")
    tiles_x, _, n_tiles = raster._grid(width, height, tile, tile)
    cap = tile_tris.shape[1]
    raster._check("records", records, torch.float32,
                  (records.shape[0], raster.EDGE_WIDTH), dev, "oit")
    raster._check("tile_tris", tile_tris, torch.int32, (n_tiles, cap), dev, "oit")
    raster._check("counts", counts, torch.int32, (n_tiles,), dev, "oit")
    raster._check("opaque_depth", opaque_depth, torch.float32, (height, width),
                  dev, "oit")
    # OIT_PIXELS a thread: a 128x128 tile runs as sixteen 128x8 bands
    rows = band_rows(tile)
    raster._check_kept(kept, tiles_x * raster._grid(width, height, tile, rows)[1],
                       dev, "oit")
    accum = torch.empty((height, width, 4), device=dev)
    reveal = torch.empty((height, width), device=dev)
    # shared memory: the band's opaque depth, then the surviving records
    smem = raster._smem_bytes("oit", cap, tile * rows * 4)
    raster._call(cuda_build.load("blend_raster").oit_launch,
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                 + [ctypes.c_void_p] * 3 + [ctypes.c_int],
                 "oit", dev,
                 raster._ptr(records), raster._ptr(tile_tris), raster._ptr(counts),
                 raster._ptr(opaque_depth), cap, n_tiles, tiles_x, tile, width,
                 height, tile // rows, raster._ptr(accum), raster._ptr(reveal),
                 raster._kept_ptr(kept), smem)
    rasterize_oit.launches += 1
    return accum, reveal


def oit_args(setup: Dict[str, Tensor], tri_colors: Tensor, tile_tris: Tensor,
             counts: Tensor, opaque_depth: Tensor, width: int, height: int,
             tile: int) -> tuple:
    """The positional arguments of oit_cuda / oit_plain."""
    return (pack_oit_records(setup, tri_colors), tile_tris.int().contiguous(),
            counts.int().contiguous(), opaque_depth.float().contiguous(), width,
            height, tile)


def rasterize_oit(setup: Dict[str, Tensor], tri_colors: Tensor, tile_tris: Tensor,
                  counts: Tensor, opaque_depth: Tensor, width: int, height: int,
                  tile: int) -> Tuple[Tensor, Tensor]:
    """OIT accumulation of (T, 4) rgba triangles over merged per-tile lists
    (square tiles) -> (accum (H, W, 4) = [sum rgb w | sum w], reveal (H, W)).
    CUDA tensors launch the OIT kernel, CPU tensors take `oit_plain`;
    `launches` counts kernel launches."""
    args = oit_args(setup, tri_colors, tile_tris, counts, opaque_depth, width,
                    height, tile)
    return raster._on_device("rasterize_oit", args[0], oit_cuda, oit_plain)(*args)


rasterize_oit.launches = 0


def composite(hdr_opaque: Tensor, accum: Tensor, reveal: Tensor) -> Tensor:
    """Fullscreen OIT composite over the opaque HDR (H, W, 3)."""
    avg_color = accum[..., :3] / torch.clamp(accum[..., 3:4], min=1e-5)
    any_frag = accum[..., 3] > 0.0
    out = avg_color * (1.0 - reveal[..., None]) + hdr_opaque * reveal[..., None]
    return torch.where(any_frag[..., None], out, hdr_opaque)
