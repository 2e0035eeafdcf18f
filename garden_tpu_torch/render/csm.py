"""Cascaded shadow maps: cascade fit, the atlas depth raster and the resolve.

Port of `garden_tpu.render.csm`. The cascades share one light view; each
is an orthographic crop of it, and all of them raster side by side into
one mixed-resolution atlas (`cascade_layout`). Opaque casters are set up
once for every cascade in atlas pixel coordinates, binned and drawn by the
depth raster: the split path of `raster.rasterize_depth` (kernels
depth_super and depth_grid) when `ShadowConfig.max_active_tiles` is set,
its dense path (kernel depth_dense) otherwise. A caster's footprint is 2
tiles wide and foot_y tall (`atlas_tiling`): with foot_y 2 each caster is
sorted once by its corner tile (`raster.bin_triangles_corner`), otherwise
into every tile of its footprint (`raster.bin_triangles`, slot binning).
Translucent casters, when given, make a second map: slot-binned, their
nearest depth drawn by depth_dense and their tint blended in bin order
over white by the sorted_blend kernel.
The resolve projects each pixel into its cascade, takes one lenient
reverse-Z compare, smooths the binary factor with a screen-space PCF and
multiplies in the tint of the translucent casters in front.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import ShadowConfig
from garden_tpu_torch.ops.blur import bilateral_upsample_to, decimate2x
from garden_tpu_torch.ops.shifts import Shifter
from garden_tpu_torch.render import raster

Tensor = torch.Tensor

NEAR_EPS = 1e-6


def cascade_splits(cfg: ShadowConfig, near: float) -> List[float]:
    """View-space split depths [near, s1, ..., far]; the last cascade always
    reaches the shadow distance."""
    d = cfg.distance
    ratios = list(cfg.split_ratios)[:max(cfg.cascade_count - 1, 0)]
    return [near] + [r * d for r in ratios] + [d]


def cascade_layout(cfg: ShadowConfig) -> Tuple[Tuple[int, ...],
                                               Tuple[Tuple[int, int], ...],
                                               int, int]:
    """(sizes, (x0, y0) offsets, atlas_width, atlas_height): cascade 0 at the
    origin, smaller cascades stacked in columns to its right while they fit
    under its height."""
    sizes = cfg.cascade_sizes or (cfg.map_size,) * cfg.cascade_count
    h0 = max(sizes)
    offs = [(0, 0)]
    col_x, col_w, cur_y = sizes[0], 0, 0
    for s in sizes[1:]:
        if cur_y + s > h0:
            col_x, cur_y = col_x + col_w, 0
            col_w = 0
        offs.append((col_x, cur_y))
        cur_y += s
        col_w = max(col_w, s)
    atlas_w = col_x + col_w if len(sizes) > 1 else sizes[0]
    return sizes, tuple(offs), int(atlas_w), int(h0)


def fit_cascades(inv_view_proj: Tensor, light_dir: Tensor, cam_near: float,
                 splits: List[float], near_clip_proj: float) -> Dict[str, Tensor]:
    """One shared light view and an orthographic crop of it per cascade,
    fitted to the light-space bounds of the cascade's frustum slice.
    Returns {"view" (4, 4), "projs" (C, 4, 4), "lvps" (C, 4, 4)}."""
    dev = inv_view_proj.device
    vec = lambda *c: torch.tensor(c, dtype=torch.float32, device=dev)
    light_dir = m3.normalize(light_dir)
    up = torch.where(torch.abs(light_dir[1]) > 0.95, vec(1.0, 0.0, 0.0),
                     vec(0.0, 1.0, 0.0))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)

    def slice_corners(split_near, split_far):
        # reverse-Z infinite projection: ndc_z = near / dist
        z0 = near_clip_proj / torch.clamp(split_near, min=near_clip_proj)
        z1 = near_clip_proj / torch.clamp(split_far, min=near_clip_proj)
        corners = []
        for x in (-1.0, 1.0):
            for y in (-1.0, 1.0):
                for z in (z0, z1):
                    h = inv_view_proj @ torch.stack([f32(x), f32(y), z, f32(1.0)])
                    corners.append(h[:3] / h[3])
        return torch.stack(corners)

    all_corners = [slice_corners(f32(splits[i]), f32(splits[i + 1]))
                   for i in range(len(splits) - 1)]
    center = torch.mean(torch.cat(all_corners), dim=0)
    eye = center - light_dir * 200.0
    view = m3.look_at(eye, center, up)
    projs = []
    for corners in all_corners:
        lc = m3.apply_mat4(view, corners)
        lo = torch.amin(lc, dim=0)
        hi = torch.amax(lc, dim=0)
        # the near plane extends backwards to catch casters off the slice
        projs.append(m3.orthographic(lo[0], hi[0], lo[1], hi[1],
                                     -hi[2] - 100.0, -lo[2], reverse_z=True))
    projs = torch.stack(projs)
    return {"view": view, "projs": projs,
            "lvps": torch.einsum("cij,jk->cik", projs, view)}


def _setup_cascades(lx: Tensor, ly: Tensor, lz: Tensor, tri_valid: Tensor,
                    sizes: Tuple[int, ...], offsets: Tuple[Tuple[int, int], ...],
                    projs: Tensor) -> Dict[str, Tensor]:
    """Triangle setup for every cascade at once, in atlas pixel coordinates,
    from shared light-space corner planes (3, T). Each cascade's pixel
    coordinates are an affine map of the light-space position read off its
    orthographic matrix. Fields come out flattened cascade-major: (3, C*T)
    and (C*T,)."""
    c = projs.shape[0]
    t = lx.shape[1]
    dev = lx.device
    col = lambda v: torch.tensor(v, dtype=torch.float32, device=dev).reshape(1, c, 1)
    size = col(list(sizes))
    xoff = col([o[0] for o in offsets])
    yoff = col([o[1] for o in offsets])
    p = lambda i, j: projs[:, i, j].reshape(1, c, 1)
    x, y, zl = lx[:, None, :], ly[:, None, :], lz[:, None, :]      # (3, 1, T)
    # ndc = diag(p00, p11, p22) * ls + (p03, p13, p23), viewport folded in
    sx = x * (p(0, 0) * 0.5 * size) + (p(0, 3) * 0.5 + 0.5) * size + xoff
    sy = y * (-p(1, 1) * 0.5 * size) + (0.5 - p(1, 3) * 0.5) * size + yoff
    z = zl * p(2, 2) + p(2, 3)                                     # (3, C, T)
    area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
    front = area < -1e-8
    xmin, xmax = torch.amin(sx, dim=0), torch.amax(sx, dim=0)      # (C, T)
    ymin, ymax = torch.amin(sy, dim=0), torch.amax(sy, dim=0)
    x0, y0, s2 = xoff[0], yoff[0], size[0]
    # the per-cascade viewport cull is the per-cascade caster cull
    on_screen = (xmax >= x0) & (xmin < x0 + s2) & (ymax >= y0) & (ymin < y0 + s2)
    valid = tri_valid[None, :] & front & on_screen
    flat = lambda a: a.reshape(c * t)
    inv_area = torch.where(valid, 1.0 / torch.where(front, -area, torch.ones_like(area)),
                           torch.zeros_like(area))
    return {"sx": sx.reshape(3, c * t), "sy": sy.reshape(3, c * t),
            "z": z.reshape(3, c * t), "inv_area": flat(inv_area),
            "xmin": flat(xmin), "xmax": flat(xmax), "ymin": flat(ymin),
            "ymax": flat(ymax), "valid": flat(valid)}


def atlas_tiling(cfg: ShadowConfig, max_per_tile: int = 256) -> Tuple[int, int, int]:
    """(atlas tile height, per-tile list cap, y-footprint in tiles) of the
    cascade atlas: atlas_foot_y, or by default the footprint whose height
    is 256 pixels, within 2 to 8 tiles."""
    th = cfg.atlas_tile_h or 128
    fy = cfg.atlas_foot_y or max(2, min(8, 256 // th))
    return th, max(64, (max_per_tile * th // 128) // 16 * 16), fy


def cascade_raster_inputs(pos_planes: Tuple[Tensor, Tensor, Tensor],
                          tri_valid: Tensor, light: Dict[str, Tensor],
                          cfg: ShadowConfig, max_per_tile: int = 256,
                          binning: bool = True) -> Dict[str, object]:
    """Everything up to the atlas depth raster, as the keyword arguments of
    raster.rasterize_depth: the shared-view transform of the world corner
    planes (3, T) each, the cascade setup and the binning (corner binning
    with a y-footprint of 2 tiles, else slot binning; with the super-tile
    big lists on the split path); without `binning`, all but the lists."""
    sizes, offsets, atlas_w, atlas_h = cascade_layout(cfg)
    px, py, pz = pos_planes
    t = px.shape[1]
    c_count = light["projs"].shape[0]
    v = light["view"]
    lx = v[0, 0] * px + v[0, 1] * py + v[0, 2] * pz + v[0, 3]
    ly = v[1, 0] * px + v[1, 1] * py + v[1, 2] * pz + v[1, 3]
    lz = v[2, 0] * px + v[2, 1] * py + v[2, 2] * pz + v[2, 3]
    bounds = tuple((offsets[ci][0], offsets[ci][0] + sizes[ci],
                    offsets[ci][1], offsets[ci][1] + sizes[ci])
                   for ci in range(c_count))
    tri_atlas = torch.arange(c_count, dtype=torch.int32,
                             device=px.device).repeat_interleave(t)
    setup = _setup_cascades(lx, ly, lz, tri_valid, sizes, offsets, light["projs"])
    th, cap, fy = atlas_tiling(cfg, max_per_tile)
    kw = dict(setup=setup, width=atlas_w, height=atlas_h, tile=128,
              atlas_bounds=bounds, tri_atlas=tri_atlas, tile_h=th)
    if not binning:
        return kw
    max_active = cfg.max_active_tiles
    split = dict(max_big=256, max_active=max_active) if max_active else {}
    if fy == 2:
        binned = raster.bin_triangles_corner(setup, atlas_w, atlas_h, 128, cap,
                                             tile_h=th, **split)
    else:
        binned = raster.bin_triangles(setup, atlas_w, atlas_h, 128, cap, foot=2,
                                      tile_h=th, foot_y=fy, **split)
    tiles, counts, big = binned[:3]
    if max_active:
        # super-tiles of 512 x (8 tile_h) px for the big-caster lists
        sup = raster.bin_big_supertiles(setup, big, atlas_w, atlas_h, 128, th,
                                        sup_x=4, sup_y=max(128 // th, 1), cap=64)
        kw.update(sup_bins=sup, max_active=max_active, act_ids=binned[3])
    kw.update(tile_tris=tiles, counts=counts, big_list=big)
    return kw


def translucent_raster_inputs(pos_planes: Tuple[Tensor, Tensor, Tensor],
                              tri_valid: Tensor, light: Dict[str, Tensor],
                              cfg: ShadowConfig, max_per_tile: int = 256
                              ) -> Dict[str, object]:
    """The translucent casters' atlas inputs, as the keyword arguments of
    raster.rasterize_depth: the shared-view setup of the casters in
    `tri_valid` and their slot binning (foot 2 x foot_y, half the opaque
    list cap, the dense depth path)."""
    kw = cascade_raster_inputs(pos_planes, tri_valid, light, cfg, max_per_tile,
                               binning=False)
    th, cap, fy = atlas_tiling(cfg, max_per_tile)
    tiles, counts, big = raster.bin_triangles(
        kw["setup"], kw["width"], kw["height"], 128, max(32, cap // 2), foot=2,
        tile_h=th, foot_y=fy)
    kw.update(tile_tris=tiles, counts=counts, big_list=big)
    return kw


def caster_inputs(pos_planes: Tuple[Tensor, Tensor, Tensor], tri_valid: Tensor,
                  light: Dict[str, Tensor], cfg: ShadowConfig,
                  max_per_tile: int = 256, tri_translucent: Tensor = None
                  ) -> Tuple[Dict[str, object], Optional[Dict[str, object]]]:
    """(opaque, translucent): the keyword arguments of raster.rasterize_depth
    for the opaque casters' atlas (cascade_raster_inputs) and, with
    `tri_translucent` (T,), for the translucent casters' atlas
    (translucent_raster_inputs), else None. The opaque casters exclude the
    translucent ones."""
    if tri_translucent is None:
        return cascade_raster_inputs(pos_planes, tri_valid, light, cfg,
                                     max_per_tile), None
    return (cascade_raster_inputs(pos_planes, tri_valid & ~tri_translucent, light,
                                  cfg, max_per_tile),
            translucent_raster_inputs(pos_planes, tri_valid & tri_translucent, light,
                                      cfg, max_per_tile))


def draw_cascades(opaque_kw: Dict[str, object],
                  translucent_kw: Optional[Dict[str, object]] = None,
                  tri_tint: Tensor = None) -> Tuple[Tensor, Optional[Tensor]]:
    """The atlases of `caster_inputs`' two input sets -> (depth_atlas,
    trans_atlas): depth_atlas (H, W) is the opaque casters' reverse-Z
    depth; with `translucent_kw` and `tri_tint` (T, 4) rgba, trans_atlas
    (H, W, 4) is the transmitted tint rgb of the translucent casters
    (blended in bin order over white, z-tested against the opaque depth)
    and their nearest depth, else None."""
    depth_atlas = raster.rasterize_depth(**opaque_kw)
    if translucent_kw is None or tri_tint is None:
        return depth_atlas, None
    tdepth = raster.rasterize_depth(**translucent_kw)
    tint = raster.rasterize_sorted_blend(**translucent_tint_inputs(
        translucent_kw, tri_tint, depth_atlas))
    return depth_atlas, torch.cat([tint, tdepth[..., None]], dim=-1)


def render_cascades(pos_planes: Tuple[Tensor, Tensor, Tensor], tri_valid: Tensor,
                    light: Dict[str, Tensor], cfg: ShadowConfig,
                    max_per_tile: int = 256, tri_translucent: Tensor = None,
                    tri_tint: Tensor = None) -> Tuple[Tensor, Optional[Tensor]]:
    """Shadow raster of all cascades -> (depth_atlas, trans_atlas) in the
    layout of `cascade_layout` (see draw_cascades); the translucent map is
    drawn when both `tri_translucent` and `tri_tint` are given."""
    with_trans = tri_translucent is not None and tri_tint is not None
    return draw_cascades(*caster_inputs(pos_planes, tri_valid, light, cfg, max_per_tile,
                                        tri_translucent if with_trans else None),
                         tri_tint)


def translucent_tint_inputs(kw: Dict[str, object], tri_tint: Tensor,
                            depth_atlas: Tensor) -> Dict[str, object]:
    """The keyword arguments of raster.rasterize_sorted_blend for the
    translucent map's tint: the casters of `kw` (translucent_raster_inputs)
    with their (T, 4) rgba, blended in bin order over an all-ones atlas and
    z-tested against the opaque `depth_atlas`, clipped to their cascade."""
    atlas_h, atlas_w = depth_atlas.shape
    c_count = len(kw["atlas_bounds"])
    return dict(setup=kw["setup"], tri_rgba=tri_tint.repeat(c_count, 1),
                tile_tris=kw["tile_tris"], counts=kw["counts"], big_list=kw["big_list"],
                opaque_depth=depth_atlas,
                hdr=torch.ones((atlas_h, atlas_w, 3), device=depth_atlas.device),
                width=atlas_w, height=atlas_h, tile=128,
                atlas_bounds=kw["atlas_bounds"], tri_atlas=kw["tri_atlas"],
                tile_h=kw["tile_h"])


def _project_cascades(position: Tensor, view_depth: Tensor,
                      light: Dict[str, Tensor], cfg: ShadowConfig,
                      splits: List[float]):
    """Per-pixel atlas (u, v), biased reverse-Z compare depth z, and
    validity, each cascade an affine map of the shared light view."""
    sizes, offsets, _, _ = cascade_layout(cfg)
    projs = light["projs"]
    cascade = torch.zeros_like(view_depth, dtype=torch.int32)
    for i in range(1, len(sizes)):
        cascade = torch.where(view_depth > splits[i], i, cascade)
    ls = torch.einsum("ij,hwj->hwi", light["view"][:3, :3], position) \
        + light["view"][:3, 3]
    u = torch.zeros_like(view_depth)
    v = torch.zeros_like(view_depth)
    z = torch.zeros_like(view_depth)
    inside = torch.zeros_like(view_depth, dtype=torch.bool)
    for i in range(len(sizes)):
        s_i, x_i, y_i = float(sizes[i]), float(offsets[i][0]), float(offsets[i][1])
        u_i = (ls[..., 0] * projs[i, 0, 0] + projs[i, 0, 3]) * (0.5 * s_i) \
            + (0.5 * s_i + x_i)
        v_i = (ls[..., 1] * projs[i, 1, 1] + projs[i, 1, 3]) * (-0.5 * s_i) \
            + (0.5 * s_i + y_i)
        z_i = ls[..., 2] * projs[i, 2, 2] + projs[i, 2, 3]
        sel = cascade == i
        u = torch.where(sel, u_i, u)
        v = torch.where(sel, v_i, v)
        z = torch.where(sel, z_i, z)
        inside = inside | (sel & (u_i >= x_i + 1) & (u_i < x_i + s_i - 1)
                           & (v_i >= y_i + 1) & (v_i < y_i + s_i - 1))
    ok = inside & (view_depth < splits[-1])
    return u, v, z + cfg.bias_constant, ok


def resolve_shadow(position: Tensor, normal: Tensor, view_depth: Tensor,
                   depth_atlas: Tensor, light: Dict[str, Tensor],
                   cfg: ShadowConfig, splits: List[float],
                   trans_atlas: Optional[Tensor] = None) -> Tensor:
    """PCF shadow factor, 1 = fully lit: (H, W, 1), or with `trans_atlas`
    (render_cascades) (H, W, 3), the factor times the tint of the
    translucent casters between the surface and the light. With
    resolve_step > 1 the compare runs on a decimated grid and the factor
    comes back to full size through the depth-guided upsample; the tint
    is looked up at quarter density (every 4th pixel each way, counting
    the decimation) and repeated."""
    atlas_h, atlas_w = depth_atlas.shape
    step = max(int(cfg.resolve_step), 1)
    full_shape = position.shape[:2]
    view_depth_full = view_depth
    for _ in range(int(np.log2(step))):
        position = decimate2x(position)
        normal = decimate2x(normal)
        view_depth = decimate2x(view_depth)

    # normal-offset bias, then one tap of the atlas: the lenient reverse-Z
    # compare z + bias >= occluder keeps surfaces from shadowing themselves
    def tap(position, normal, view_depth):
        u, v, z, ok = _project_cascades(position + normal * cfg.bias_normal,
                                        view_depth, light, cfg, splits)
        flat = (torch.clamp(v.int(), 0, atlas_h - 1) * atlas_w
                + torch.clamp(u.int(), 0, atlas_w - 1))
        return flat.long(), z, ok

    flat, z, ok = tap(position, normal, view_depth)
    occ = depth_atlas.reshape(-1)[flat]
    lit = torch.where(z >= occ, 1.0, 0.0)
    lit = torch.where(ok, lit, 1.0)
    tint = None
    if trans_atlas is not None:
        tsub = max(4 // step, 1)
        if tsub > 1:
            pos_t, nrm_t, vd_t = position, normal, view_depth
            for _ in range(int(np.log2(tsub))):
                pos_t, nrm_t, vd_t = decimate2x(pos_t), decimate2x(nrm_t), decimate2x(vd_t)
            flat_t, z_t, ok_t = tap(pos_t, nrm_t, vd_t)
        else:
            flat_t, z_t, ok_t = flat, z, ok
        trow = trans_atlas.reshape(-1, 4)[flat_t]
        # tinted where the surface lies beyond the nearest translucent caster
        tint = torch.where(((z_t < trow[..., 3]) & ok_t)[..., None], trow[..., 0:3],
                           1.0)
        if tsub > 1:
            tint = tint.repeat_interleave(tsub, dim=0).repeat_interleave(tsub, dim=1)
            tint = tint[:lit.shape[0], :lit.shape[1]]
    r = cfg.pcf_radius
    if r > 0:
        lit_at = Shifter(lit, r, r)
        acc = torch.zeros_like(lit)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                acc = acc + lit_at(dy, dx)
        lit = acc / (2 * r + 1) ** 2
    # (h, w, 1): the opaque-only factor broadcasts over rgb
    lit = lit[..., None] if tint is None else lit[..., None] * tint
    if step > 1:
        lit = bilateral_upsample_to(lit, view_depth, view_depth_full,
                                    full_shape[0], full_shape[1])
    return lit
