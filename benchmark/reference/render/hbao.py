"""Horizon-based ambient occlusion from world positions and normals.

Port of `garden_tpu.render.hbao`. For each of N_DIRS screen directions the
pass marches fixed pixel radii (STEP_RADII), each tap one shifted read of
the position buffer, and keeps the largest elevation of a visible sample
above the surface's tangent plane, weighted by a world-space falloff; the
directions' horizons average into the occlusion. `half_res=True` marches
a 2x-decimated G-buffer and upsamples depth-guided.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.core import math3d as m3
from benchmark.reference.ops.blur import bilateral_upsample_to, decimate2x
from benchmark.reference.ops.shifts import Shifter

Tensor = torch.Tensor

N_DIRS = 8
STEP_RADII = (2, 4, 7, 11, 16)  # fixed pixel radii marched per direction
ANGLE_BIAS = 0.1                # sin of the tangent bias
_MAX_RADIUS = max(STEP_RADII)   # the pad size


def compute_hbao(position: Tensor, normal: Tensor, visible: Tensor,
                 camera_pos: Tensor, radius: float = 1.0,
                 intensity: float = 1.0, half_res: bool = False) -> Tensor:
    """AO factor (H, W), 1 = unoccluded; 1 where nothing was drawn."""
    if half_res:
        h, w = visible.shape
        depth_full = m3.length(position - camera_pos)
        pos_lo = decimate2x(position)
        ao_lo = compute_hbao(pos_lo, decimate2x(normal),
                             decimate2x(visible.float()) > 0.5, camera_pos,
                             radius=radius, intensity=intensity)
        depth_lo = m3.length(pos_lo - camera_pos)
        ao = bilateral_upsample_to(ao_lo[..., None], depth_lo, depth_full,
                                   h, w)[..., 0]
        return torch.where(visible, torch.clamp(ao, 0.0, 1.0), 1.0)

    pos_at = Shifter(position, _MAX_RADIUS, _MAX_RADIUS)
    vis_at = Shifter(visible, _MAX_RADIUS, _MAX_RADIUS)
    occlusion = torch.zeros(visible.shape, device=position.device)
    for d in range(N_DIRS):
        ang = 2.0 * math.pi * (d + 0.5) / N_DIRS
        ux, uy = math.cos(ang), math.sin(ang)
        horizon = torch.zeros(visible.shape, device=position.device)
        for r_px in STEP_RADII:
            # Python's round: halves go to even, as in the reference
            dy = int(round(uy * r_px))
            dx = int(round(ux * r_px))
            delta = pos_at(-dy, -dx) - position
            dlen = m3.length(delta)
            sin_h = m3.dot(delta, normal) / torch.clamp(dlen, min=1e-6)
            falloff = torch.clamp(1.0 - dlen / radius, 0.0, 1.0)
            cand = torch.clamp(sin_h - ANGLE_BIAS, 0.0, 1.0) * falloff
            horizon = torch.maximum(horizon, torch.where(vis_at(-dy, -dx), cand, 0.0))
        occlusion = occlusion + horizon
    ao = 1.0 - torch.clamp(occlusion / N_DIRS * intensity, 0.0, 1.0)
    return torch.where(visible, ao, 1.0)
