"""Bloom: a 2x box downsample chain, then a tent upsample-accumulate.

Port of `garden_tpu.render.bloom`. The HDR image is halved `mip_count`
times (odd sizes are edge-padded to even first: 1080 -> 540 -> 270 -> 135
-> 68 -> 34), the mips are summed back up the chain through a repeat and
3x3 tent, and the average blends in at a small mix. The arithmetic runs
in the input's dtype (bfloat16 under `post_bf16`).
"""

from __future__ import annotations

from typing import List

import torch

from benchmark.reference.ops.blur import decimate2x, upsample2x_to
from benchmark.reference.ops.shifts import edge_pad

Tensor = torch.Tensor


def _downsample2x(x: Tensor) -> Tensor:
    """(H, W, 3) -> (ceil(H/2), ceil(W/2), 3) 2x2 box; odd sizes edge-pad."""
    h, w = x.shape[0], x.shape[1]
    if h % 2 or w % 2:
        x = edge_pad(x, (0, h % 2), (0, w % 2))
    return decimate2x(x)


def apply_bloom(hdr: Tensor, mip_count: int = 5, mix: float = 0.04) -> Tensor:
    """HDR (H, W, 3) -> HDR with bloom blended in."""
    mips: List[Tensor] = [hdr]
    for _ in range(mip_count):
        mips.append(_downsample2x(mips[-1]))
    acc = mips[-1]
    for i in range(mip_count - 1, -1, -1):
        # each mip is at least half its parent (rounded up), so the
        # repeated mip covers the parent and is only cropped
        acc = mips[i] + upsample2x_to(acc, mips[i].shape[0], mips[i].shape[1])
    bloom = acc / (mip_count + 1)
    return hdr * (1.0 - mix) + bloom * mix
