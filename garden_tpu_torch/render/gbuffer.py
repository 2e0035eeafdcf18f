"""G-buffer assembly from the fused raster's output.

Port of the `gplanes` path of `garden_tpu.render.gbuffer`: the per-triangle
shading records the raster kernel reads, and the G-buffer dict built from
its finished planes (texture sampling, world-position reconstruction from
depth, visibility gating).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from garden_tpu_torch.core import math3d as m3

Tensor = torch.Tensor

# record layout: [n0 n1 n2 (9) | uv x3 (6) | material (9) | base-texture (1)
# | instance (1) | prev-screen x3 (6) | inv_w (3) | pad]
REC_WIDTH = 36


def pack_triangle_records(scene: Dict[str, Tensor], tri_normals: Tensor,
                          inv_w: Tensor,
                          prev_screen_tri: Optional[Tensor] = None) -> Tensor:
    """(T, 36) per-triangle shading records.

    tri_normals: (T, 3, 3) world normals per corner; inv_w: corner-major
    (3, T) 1/w; prev_screen_tri: optional (T, 3, 2) previous-frame screen
    positions (zeros when absent)."""
    ti = scene["tri_instance"]
    t = ti.shape[0]
    has = (ti >= 0)[:, None]
    mat = scene["materials"][scene["inst_material"][torch.clamp(ti, min=0).long()].long()]
    mat = torch.where(has, mat, torch.zeros_like(mat))
    prev = (prev_screen_tri.reshape(t, 6) if prev_screen_tri is not None
            else torch.zeros((t, 6), device=ti.device))
    rec = torch.cat([
        tri_normals.reshape(t, 9),
        scene["tri_uvs"].reshape(t, 6),
        mat[:, :9],                              # props (alpha is OIT-only)
        mat[:, 10:11],                           # base-texture index
        ti.float()[:, None],
        prev,
        inv_w.T,
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


def shade_gbuffer(vis: Dict[str, Tensor], gplanes: Optional[Tensor] = None,
                  constants: Optional[Dict[str, Tensor]] = None,
                  records: Optional[Tensor] = None,
                  with_velocity: bool = False) -> Dict[str, Tensor]:
    """G-buffer dict (H, W, C planes), from the raster's (18, H, W) finished
    planes [normal3 | uv2 | base3 metallic roughness emissive3 reflectance |
    texture | instance | velocity2], or with `records` (T, 36) from one
    per-pixel gather of the winning triangle's shading record (the
    visibility raster's path). `with_velocity` adds "velocity" (H, W, 2),
    the planes' screen motion in pixels since the previous frame, 0 where
    no triangle covers the pixel. Texture sampling belongs to a pass not
    ported yet."""
    if records is not None:
        return _gbuffer_from_records(vis, records, constants)
    visible = vis["tri_id"] >= 0
    gp = lambda a, b: torch.movedim(gplanes[a:b], 0, -1)
    position = _position(vis, constants)
    g = {
        "visible": visible,
        "depth": vis["depth"],
        "position": position,
        "normal": gp(0, 3),
        "uv": gp(3, 5),
        "base_color": gp(5, 8),
        "metallic": gplanes[8],
        "roughness": gplanes[9],
        "emissive": gp(10, 13),
        "reflectance": gplanes[13],
        "instance": torch.where(visible, gplanes[15].int(), -1),
    }
    if with_velocity:
        g["velocity"] = torch.where(visible[..., None], gp(16, 18), 0.0)
    return g


def _position(vis: Dict[str, Tensor], constants) -> Tensor:
    """World positions from depth where a triangle covers the pixel, zeros
    elsewhere (and everywhere without constants)."""
    depth = vis["depth"]
    if constants is None:
        return torch.zeros(depth.shape + (3,), device=depth.device)
    position = reconstruct_position(depth, constants)
    return torch.where((vis["tri_id"] >= 0)[..., None], position,
                       torch.zeros_like(position))


def _gbuffer_from_records(vis: Dict[str, Tensor], records: Tensor,
                          constants) -> Dict[str, Tensor]:
    """The G-buffer from the winning triangle's record: perspective-correct
    barycentrics through the record's inv_w, then normal, uv, material and
    instance; position from depth."""
    if constants is None:
        raise NotImplementedError(
            "shade_gbuffer(records=...) without constants interpolates vertex "
            "positions, which is not ported (ROADMAP Queue 1 item 13)")
    visible = vis["tri_id"] >= 0
    rec = records[torch.clamp(vis["tri_id"], min=0).long()]   # (H, W, 36)
    ch = lambda a, b: rec[..., a:b]
    b0, b1 = vis["b0"], vis["b1"]
    pw = torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1) * ch(32, 35)
    pw = pw / torch.clamp(torch.sum(pw, dim=-1, keepdim=True), min=1e-12)
    normal = m3.normalize(ch(0, 3) * pw[..., 0:1] + ch(3, 6) * pw[..., 1:2]
                          + ch(6, 9) * pw[..., 2:3])
    uv = ch(9, 11) * pw[..., 0:1] + ch(11, 13) * pw[..., 1:2] + ch(13, 15) * pw[..., 2:3]
    return {
        "visible": visible,
        "depth": vis["depth"],
        "position": _position(vis, constants),
        "normal": normal,
        "uv": uv,
        "base_color": ch(15, 18),
        "metallic": rec[..., 18],
        "roughness": rec[..., 19],
        "emissive": ch(20, 23),
        "reflectance": rec[..., 23],
        "instance": torch.where(visible, rec[..., 25].int(), -1),
    }
