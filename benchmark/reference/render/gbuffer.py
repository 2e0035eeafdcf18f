"""G-buffer assembly from the raster's output.

Port of `garden_tpu.render.gbuffer`: the per-triangle shading records the
raster kernels read, and the G-buffer dict built from the fused raster's
finished planes (`gplanes`), from per-pixel records (`attrs`), or from one
per-pixel gather of the winning triangle's record (the visibility raster's
path); then the base-colour texture sample, world positions (from depth,
or interpolated from the vertex pool without constants) and visibility
gating.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference.core import math3d as m3

Tensor = torch.Tensor

# record layout: [n0 n1 n2 (9) | uv x3 (6) | material (9) | base-texture (1)
# | instance (1) | prev-screen x3 (6) | inv_w (3) | pad]
REC_WIDTH = 36


def pack_triangle_records(scene: Dict[str, Tensor], tri_normals: Tensor = None,
                          inv_w: Tensor = None,
                          prev_screen_tri: Optional[Tensor] = None,
                          world_normals: Tensor = None) -> Tensor:
    """(T, 36) per-triangle shading records.

    tri_normals: (T, 3, 3) world normals per corner, or else world_normals
    (V, 3) of the vertex pool, gathered by scene["indices"]; inv_w:
    corner-major (3, T) 1/w (zeros when absent); prev_screen_tri: optional
    (T, 3, 2) previous-frame screen positions (zeros when absent)."""
    ti = scene["tri_instance"]
    t = ti.shape[0]
    dev = ti.device
    if tri_normals is None:
        tri_normals = world_normals[scene["indices"].long()]
    has = (ti >= 0)[:, None]
    mat = scene["materials"][scene["inst_material"][torch.clamp(ti, min=0).long()].long()]
    mat = torch.where(has, mat, torch.zeros_like(mat))
    prev = (prev_screen_tri.reshape(t, 6) if prev_screen_tri is not None
            else torch.zeros((t, 6), device=dev))
    rec = torch.cat([
        tri_normals.reshape(t, 9),
        scene["tri_uvs"].reshape(t, 6),
        mat[:, :9],                              # props (alpha is OIT-only)
        mat[:, 10:11],                           # base-texture index
        ti.float()[:, None],
        prev,
        inv_w.T if inv_w is not None else torch.zeros((t, 3), device=dev),
    ], dim=-1)
    return torch.nn.functional.pad(rec, (0, REC_WIDTH - rec.shape[-1]))


def reconstruct_position(depth: Tensor, constants: Dict[str, Tensor]) -> Tensor:
    """World position from reverse-Z depth and the inverse view-projection."""
    h, w = depth.shape
    dev = depth.device
    x = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0)[None, :]
    y = (1.0 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2.0)[:, None]
    d = torch.clamp(depth, min=1e-9)
    m = constants["inv_view_proj"]
    comps = [m[i, 0] * x + m[i, 1] * y + m[i, 2] * d + m[i, 3] for i in range(4)]
    inv_w4 = 1.0 / torch.clamp(comps[3], min=1e-9)
    return torch.stack([comps[0] * inv_w4, comps[1] * inv_w4, comps[2] * inv_w4],
                       dim=-1)


def shade_gbuffer(vis: Dict[str, Tensor], setup: Optional[Dict[str, Tensor]],
                  scene: Optional[Dict[str, Tensor]], world_positions: Optional[Tensor],
                  world_normals: Optional[Tensor],
                  constants: Optional[Dict[str, Tensor]] = None,
                  records: Optional[Tensor] = None, with_velocity: bool = False,
                  textures: Optional[Tensor] = None, attrs: Optional[Tensor] = None,
                  gplanes: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """The G-buffer dict (H, W, C planes), with the reference's arguments.

    gplanes: the fused raster's (18, H, W) finished planes [normal3 | uv2 |
    base3 metallic roughness emissive3 reflectance | texture | instance |
    velocity2]. Otherwise the planes come from the (T, 36) records
    (`pack_triangle_records`) of the winning triangles: `attrs`, (36, H, W)
    per-pixel records already gathered, or one per-pixel gather of
    `records`, which are packed from the vertex pool's world_normals (V, 3)
    and setup["inv_w"] when None; barycentrics are perspective-corrected
    through the record's 1/w. Positions come from depth and the inverse
    view-projection with `constants` (0 where no triangle covers the
    pixel), else they interpolate world_positions (V, 3) of the winner's
    corners. `textures` (N, S, S, 4) multiply the base colour where the
    texture index is >= 0: the nearest texel at the wrapped uv.
    `with_velocity` adds "velocity" (H, W, 2), the screen motion in pixels
    since the previous frame, 0 where no triangle covers the pixel."""
    visible = vis["tri_id"] >= 0
    if gplanes is not None:
        gp = lambda a, b: torch.movedim(gplanes[a:b], 0, -1)
        uv = gp(3, 5)
        g = {
            "visible": visible,
            "depth": vis["depth"],
            "position": _position(vis, constants),
            "normal": gp(0, 3),
            "uv": uv,
            "base_color": _textured(gp(5, 8), uv, gplanes[14].int(), textures),
            "metallic": gplanes[8],
            "roughness": gplanes[9],
            "emissive": gp(10, 13),
            "reflectance": gplanes[13],
            "instance": torch.where(visible, gplanes[15].int(), -1),
        }
        if with_velocity:
            g["velocity"] = torch.where(visible[..., None], gp(16, 18), 0.0)
        return g

    if attrs is not None:
        ch = lambda a, b: torch.movedim(attrs[a:b], 0, -1)
        chs = lambda a: attrs[a]
    else:
        if records is None:
            records = pack_triangle_records(scene, inv_w=setup["inv_w"],
                                            world_normals=world_normals)
        rec = records[torch.clamp(vis["tri_id"], min=0).long()]   # (H, W, 36)
        ch = lambda a, b: rec[..., a:b]
        chs = lambda a: rec[..., a]
    b0, b1 = vis["b0"], vis["b1"]
    b2 = 1.0 - b0 - b1
    pw = torch.stack([b0, b1, b2], dim=-1) * ch(32, 35)
    pw = pw / torch.clamp(torch.sum(pw, dim=-1, keepdim=True), min=1e-12)
    normal = m3.normalize(ch(0, 3) * pw[..., 0:1] + ch(3, 6) * pw[..., 1:2]
                          + ch(6, 9) * pw[..., 2:3])
    uv = ch(9, 11) * pw[..., 0:1] + ch(11, 13) * pw[..., 1:2] + ch(13, 15) * pw[..., 2:3]
    if constants is not None:
        position = _position(vis, constants)
    else:    # the winner's corners from the vertex pool
        corners = scene["indices"][torch.clamp(vis["tri_id"], min=0).long()].long()
        position = torch.sum(world_positions[corners] * pw[..., None], dim=-2)
    g = {
        "visible": visible,
        "depth": vis["depth"],
        "position": position,
        "normal": normal,
        "uv": uv,
        "base_color": _textured(ch(15, 18), uv, chs(24).int(), textures),
        "metallic": chs(18),
        "roughness": chs(19),
        "emissive": ch(20, 23),
        "reflectance": chs(23),
        "instance": torch.where(visible, chs(25).int(), -1),
    }
    if with_velocity:
        # screen positions are affine in screen space: screen barycentrics
        prev_xy = (ch(26, 28) * b0[..., None] + ch(28, 30) * b1[..., None]
                   + ch(30, 32) * b2[..., None])
        h, w = vis["depth"].shape
        dev = b0.device
        cur_x = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
        cur_y = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
        vel = torch.stack([cur_x.expand(h, w) - prev_xy[..., 0],
                           cur_y.expand(h, w) - prev_xy[..., 1]], dim=-1)
        g["velocity"] = torch.where(visible[..., None], vel, 0.0)
    return g


def _textured(base_color: Tensor, uv: Tensor, tex_id: Tensor,
              textures: Optional[Tensor]) -> Tensor:
    """base_color times the nearest texel of texture tex_id at the wrapped
    uv where tex_id >= 0; base_color unchanged without textures."""
    if textures is None or textures.shape[0] == 0:
        return base_color
    s = textures.shape[1]
    uvw = uv - torch.floor(uv)
    tx = torch.clamp((uvw[..., 0] * s).int(), 0, s - 1)
    ty = torch.clamp((uvw[..., 1] * s).int(), 0, s - 1)
    flat = torch.clamp(tex_id, 0, textures.shape[0] - 1) * (s * s) + ty * s + tx
    texel = textures.reshape(-1, 4)[flat.long()]
    return torch.where((tex_id >= 0)[..., None], base_color * texel[..., :3], base_color)


def _position(vis: Dict[str, Tensor], constants) -> Tensor:
    """World positions from depth where a triangle covers the pixel, zeros
    elsewhere (and everywhere without constants)."""
    depth = vis["depth"]
    if constants is None:
        return torch.zeros(depth.shape + (3,), device=depth.device)
    position = reconstruct_position(depth, constants)
    return torch.where((vis["tri_id"] >= 0)[..., None], position,
                       torch.zeros_like(position))
