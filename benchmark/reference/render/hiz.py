"""Hierarchical-Z pyramid and occlusion culling.

Port of `garden_tpu.render.hiz`: a list of reverse-Z depth mips, each
holding the farthest (minimum) depth of its 2x2 block of the level below
(an odd level is edge-padded first), and a test of instance AABBs against
it: a box is hidden when even its nearest point is farther than the
farthest stored depth over the 2x2 texels of the level where its screen
rect spans at most 2 texels.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from benchmark.reference.core import math3d as m3
from benchmark.reference.ops.shifts import edge_pad

Tensor = torch.Tensor


def full_levels(height: int, width: int) -> int:
    """Levels needed for the coarsest mip to cover the whole frame."""
    return max(int(math.ceil(math.log2(max(height, width)))), 0) + 1


def build_pyramid(depth: Tensor, levels: Optional[int] = None) -> List[Tensor]:
    """Reverse-Z min-pyramid, level 0 = `depth`; by default enough levels
    to cover the whole frame."""
    if levels is None:
        levels = full_levels(*depth.shape)
    mips = [depth]
    d = depth
    for _ in range(levels - 1):
        h, w = d.shape
        ph, pw = h % 2, w % 2
        if ph or pw:
            d = edge_pad(d, (0, ph), (0, pw))
            h, w = h + ph, w + pw
        d = torch.amin(d.reshape(h // 2, 2, w // 2, 2), dim=(1, 3))
        mips.append(d)
    return mips


def box_corners(aabb_min: Tensor, aabb_max: Tensor) -> Tensor:
    """(I, 8, 3) corners of boxes (I, 3); corner k takes the max along axis
    i where bit i of k is set."""
    return torch.stack([
        torch.stack([(aabb_max if (k >> i) & 1 else aabb_min)[:, i] for i in range(3)], -1)
        for k in range(8)], dim=-2)


def occlusion_cull(aabb_min: Tensor, aabb_max: Tensor, view_proj: Tensor,
                   pyramid: List[Tensor], width: int, height: int) -> Tensor:
    """(I,) bool: True where the world AABB is certainly hidden behind the
    pyramid. A rect wider than the coarsest level's 2x2 footprint, or a box
    reaching behind the camera, is never culled."""
    hc = m3.apply_mat4_h(view_proj, box_corners(aabb_min, aabb_max))    # (I, 8, 4)
    behind = torch.any(hc[..., 3] < 1e-6, dim=-1)
    ndc = hc[..., :3] / torch.clamp(hc[..., 3:4], min=1e-6)
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    z_near = torch.amax(ndc[..., 2], dim=-1)       # nearest point (reverse-Z max)

    x0 = torch.clamp(torch.amin(sx, dim=-1), 0, width - 1)
    x1 = torch.clamp(torch.amax(sx, dim=-1), 0, width - 1)
    y0 = torch.clamp(torch.amin(sy, dim=-1), 0, height - 1)
    y1 = torch.clamp(torch.amax(sy, dim=-1), 0, height - 1)

    # the level where the rect spans <= 2 texels; past the coarsest level
    # interior texels could hide a farther depth, so never cull there
    span = torch.maximum(x1 - x0, y1 - y0)
    n_levels = len(pyramid)
    want = torch.ceil(torch.log2(torch.clamp(span, min=1.0))).int()
    level = torch.clamp(want, 0, n_levels - 1)
    samplable = want <= n_levels - 1

    occluded = torch.zeros(aabb_min.shape[0], dtype=torch.bool, device=aabb_min.device)
    for lv, mip in enumerate(pyramid):
        scale = 2 ** lv
        mh, mw = mip.shape
        tx0 = torch.clamp((x0 / scale).int(), 0, mw - 1).long()
        tx1 = torch.clamp((x1 / scale).int(), 0, mw - 1).long()
        ty0 = torch.clamp((y0 / scale).int(), 0, mh - 1).long()
        ty1 = torch.clamp((y1 / scale).int(), 0, mh - 1).long()
        far = torch.minimum(torch.minimum(mip[ty0, tx0], mip[ty0, tx1]),
                            torch.minimum(mip[ty1, tx0], mip[ty1, tx1]))
        # a margin so that an occluder never culls itself
        occ_lv = z_near * 1.02 + 1e-4 < far
        occluded = torch.where(level == lv, occ_lv, occluded)
    return occluded & samplable & ~behind
