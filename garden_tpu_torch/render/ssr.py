"""Screen-space reflections: the lighting resolve's reflection input.

Port of `garden_tpu.render.ssr`. The march runs at a reduced resolution
(`SSRConfig.trace_step`) with the step axis dense: K depth taps along
each pixel's reflection ray at a fixed geometric schedule, a (K, h, w)
evaluation, then the first hit along the ray as a cumulative mask. The
hit's colour is the previous frame's HDR at the hit point reprojected with
the previous camera (reflections lag one frame); the confidence fades at
screen edges and with roughness, and the resolve mixes the environment
specular in where it is low. A reduced-resolution result returns to full
size through the depth-guided upsample.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import SSRConfig
from garden_tpu_torch.ops.blur import bilateral_upsample_to, decimate2x

Tensor = torch.Tensor


def step_schedule(cfg: SSRConfig, device) -> Tensor:
    """(K,) march distances: cfg.max_distance x a geometric series from
    cfg.first_step to 1 (fine near the surface, coarse far out), built once
    per device."""
    ts = cfg.max_distance * np.geomspace(cfg.first_step, 1.0, cfg.steps).astype(np.float32)
    return m3.constant(tuple(float(t) for t in ts), device)


def _project(m: Tensor, p: Tensor) -> Tensor:
    """(..., 4) clip coordinates of points (..., 3) under one 4x4 matrix."""
    return torch.einsum("ij,...j->...i", m, torch.cat([p, torch.ones_like(p[..., :1])], -1))


def trace(g: Dict[str, Tensor], depth: Tensor, prev_hdr: Tensor, prev_view_proj: Tensor,
          constants: Dict[str, Tensor], cfg: SSRConfig) -> Tuple[Tensor, Tensor]:
    """-> (reflection rgb (H, W, 3), confidence (H, W) in [0, 1]) from the
    full-res G-buffer, the current reverse-Z depth, the previous frame's
    HDR (H, W, 3) and camera. Confidence 0 means "use the environment"."""
    full_h, full_w = depth.shape
    step = max(int(cfg.trace_step), 1)
    levels = int(np.log2(step)) if step > 1 else 0
    pos, nrm, dep, rough = g["position"], g["normal"], depth, g["roughness"]
    for _ in range(levels):
        pos, nrm, dep, rough = (decimate2x(pos), decimate2x(nrm), decimate2x(dep),
                                decimate2x(rough))
    h, w = dep.shape

    v = m3.normalize(constants["camera_pos"] - pos)       # surface -> camera
    r = m3.reflect(-v, m3.normalize(nrm))                 # the reflection ray

    # the march, step axis dense: (K, h, w, 3) sample points
    ts = step_schedule(cfg, depth.device)
    p = pos[None] + r[None] * ts[:, None, None, None]
    clip = _project(constants["view_proj"], p)
    behind_cam = clip[..., 3] < 1e-6
    ndc = clip[..., :3] / torch.clamp(clip[..., 3:4], min=1e-6)
    u = (ndc[..., 0] * 0.5 + 0.5) * w                      # reduced-res texels
    vv = (0.5 - ndc[..., 1] * 0.5) * h
    ray_z = ndc[..., 2]                                    # reverse-Z

    on_screen = (u >= 0) & (u < w) & (vv >= 0) & (vv < h) & ~behind_cam
    ui = torch.clamp(u.int(), 0, w - 1)
    vi = torch.clamp(vv.int(), 0, h - 1)
    scene_z = dep.reshape(-1)[(vi * w + ui).long()]        # (K, h, w)

    # a hit: the ray went behind the depth surface (reverse-Z: smaller is
    # farther) by no more than the thickness band, where a surface exists
    z_scale = torch.clamp(scene_z, min=1e-4)
    hit = (on_screen & (scene_z > 0.0) & (ray_z <= scene_z)
           & (ray_z >= scene_z - cfg.thickness * z_scale))

    # the first hit along the ray as a mask (ties resolve as the reference's)
    first_mask = (hit & (torch.cumsum(hit.float(), dim=0) <= 1.0)).float()
    any_hit = torch.any(hit, dim=0)
    hit_p = torch.sum(p * first_mask[..., None], dim=0)
    hit_u = torch.sum(u * first_mask, dim=0)
    hit_v = torch.sum(vv * first_mask, dim=0)

    # reproject the hit point into the previous frame to fetch its colour
    pclip = _project(prev_view_proj, hit_p)
    pndc = pclip[..., :2] / torch.clamp(pclip[..., 3:4], min=1e-6)
    pu = (pndc[..., 0] * 0.5 + 0.5) * full_w
    pv = (0.5 - pndc[..., 1] * 0.5) * full_h
    prev_ok = (pu >= 0) & (pu < full_w) & (pv >= 0) & (pv < full_h)
    pui = torch.clamp(pu.int(), 0, full_w - 1)
    pvi = torch.clamp(pv.int(), 0, full_h - 1)
    color = prev_hdr.reshape(-1, 3)[(pvi * full_w + pui).long()]      # (h, w, 3)

    # confidence: a hit, reprojectable, a ray that leaves the surface; it
    # fades at the screen edges and with roughness
    edge_x = torch.minimum(hit_u, (w - 1) - hit_u) / (0.1 * w)
    edge_y = torch.minimum(hit_v, (h - 1) - hit_v) / (0.1 * h)
    edge_fade = torch.clamp(torch.minimum(edge_x, edge_y), 0.0, 1.0)
    rough_fade = torch.clamp(1.0 - rough / max(cfg.max_roughness, 1e-3), 0.0, 1.0)
    facing = m3.dot(r, nrm) > 1e-4
    conf = (any_hit & prev_ok & facing).float() * edge_fade * rough_fade
    color = torch.where(conf[..., None] > 0.0, color, 0.0)

    if step > 1:
        # the depth-guided upsample keeps reflection silhouettes on edges
        packed = torch.cat([color, conf[..., None]], -1)
        packed = bilateral_upsample_to(packed, dep, depth, full_h, full_w)
        color, conf = packed[..., :3], torch.clamp(packed[..., 3], 0.0, 1.0)
    return color, conf
