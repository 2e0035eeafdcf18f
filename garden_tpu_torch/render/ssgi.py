"""Screen-space global illumination: the lighting resolve's GI input.

Port of `garden_tpu.render.ssgi`: one-bounce diffuse irradiance gathered in
screen space from the previous frame's lit HDR (bounced light lags one
frame). One reprojection gather samples the previous HDR at this frame's
surface points; every tap after it is a fixed screen offset of the
(radiance, position, normal, visibility) planes (`ops/shifts.Shifter`), 8
directions x 3 radii, weighted by Lambert at the receiver and the sender
and a world-space range falloff. At half resolution the result returns to
full size through the depth-guided upsample.
"""

from __future__ import annotations

import math

import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.ops.blur import bilateral_upsample_to, decimate2x
from garden_tpu_torch.ops.shifts import Shifter

Tensor = torch.Tensor

N_DIRS = 8
STEP_RADII = (2, 5, 10)      # tap radii per direction, in march-resolution pixels
_MAX_RADIUS = 10


def tap_offsets():
    """The (dy, dx) screen offsets of the taps, in order. int(round(...))
    is Python's, which rounds halves to even, as the reference's."""
    taps = []
    for d in range(N_DIRS):
        ang = 2.0 * math.pi * (d + 0.5) / N_DIRS
        ux, uy = math.cos(ang), math.sin(ang)
        for r in STEP_RADII:
            dy, dx = int(round(uy * r)), int(round(ux * r))
            if dy != 0 or dx != 0:
                taps.append((dy, dx))
    return taps


def compute_ssgi(position: Tensor, normal: Tensor, visible: Tensor, depth: Tensor,
                 prev_hdr: Tensor, prev_view_proj: Tensor, *, intensity: float = 1.0,
                 world_radius: float = 4.0, half_res: bool = True) -> Tensor:
    """One-bounce diffuse GI irradiance (H, W, 3), 0 where nothing bounces,
    from world positions and normals (H, W, 3), visibility and reverse-Z
    depth (H, W), and the previous frame's HDR (H, W, 3) and camera."""
    full_h, full_w = depth.shape
    pos, nrm, dep, vis = position, normal, depth, visible
    if half_res:
        pos = decimate2x(pos)
        nrm = decimate2x(nrm)
        dep = decimate2x(dep)
        vis = decimate2x(visible.float()) > 0.5

    # the one reprojection gather: the previous frame's radiance at this
    # frame's surface points, a bounce source plane in current screen space
    m = prev_view_proj
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    cw = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
    inv_w = 1.0 / torch.clamp(cw, min=1e-6)
    pu = ((m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]) * inv_w
          * 0.5 + 0.5) * full_w
    pv = (0.5 - (m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]) * inv_w
          * 0.5) * full_h
    prev_ok = (cw > 1e-6) & (pu >= 0) & (pu < full_w) & (pv >= 0) & (pv < full_h)
    pui = torch.clamp(pu.int(), 0, full_w - 1)
    pvi = torch.clamp(pv.int(), 0, full_h - 1)
    radiance = prev_hdr.reshape(-1, 3)[(pvi * full_w + pui).long()]   # (h, w, 3)
    radiance = torch.where((prev_ok & vis)[..., None], radiance.float(), 0.0)

    rad_at = Shifter(radiance, _MAX_RADIUS, _MAX_RADIUS)
    pos_at = Shifter(pos, _MAX_RADIUS, _MAX_RADIUS)
    nrm_at = Shifter(nrm, _MAX_RADIUS, _MAX_RADIUS)
    vis_at = Shifter(vis.float(), _MAX_RADIUS, _MAX_RADIUS)

    gi = torch.zeros_like(radiance)
    taps = tap_offsets()
    for dy, dx in taps:
        to_s = pos_at(dy, dx) - pos                    # receiver -> sender
        dist = torch.sqrt(torch.clamp(m3.dot(to_s, to_s), min=1e-8))
        dir_s = to_s / dist[..., None]
        cos_r = torch.clamp(m3.dot(nrm, dir_s), min=0.0)
        cos_s = torch.clamp(m3.dot(nrm_at(dy, dx), -dir_s), min=0.0)
        fall = torch.clamp(1.0 - dist / world_radius, 0.0, 1.0)
        wgt = cos_r * cos_s * fall * vis_at(dy, dx)
        gi = gi + rad_at(dy, dx) * wgt[..., None]

    # each tap stands for an equal share of the hemisphere band
    gi = gi * (intensity * 2.0 * math.pi / max(len(taps), 1))
    gi = torch.where(vis[..., None], gi, 0.0)
    if half_res:
        gi = bilateral_upsample_to(gi, dep, depth, full_h, full_w)
    return gi
