"""Equirectangular maps to cubemaps, and cubemap lookups.

Port of `garden_tpu.ops.cubemap`: `equi_to_cube` samples an equirect
panorama bilinearly (wrapping in longitude, clamped in latitude) into six
faces in the order +x, -x, +y, -y, +z, -z; `sample_cubemap` takes the
nearest texel of the face a direction's major axis selects.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor

# (right, up, forward) of each face: +x, -x, +y, -y, +z, -z
_FACE_AXES = [
    ((0, 0, -1), (0, -1, 0), (1, 0, 0)),
    ((0, 0, 1), (0, -1, 0), (-1, 0, 0)),
    ((1, 0, 0), (0, 0, 1), (0, 1, 0)),
    ((1, 0, 0), (0, 0, -1), (0, -1, 0)),
    ((1, 0, 0), (0, -1, 0), (0, 0, 1)),
    ((-1, 0, 0), (0, -1, 0), (0, 0, -1)),
]


def _axes(i: int, device) -> Tuple[Tensor, Tensor, Tensor]:
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in _FACE_AXES[i])


def equi_to_cube(equi: Tensor, face_size: int) -> Tensor:
    """(H, W, C) equirect -> (6, face_size, face_size, C) cubemap."""
    h, w = equi.shape[:2]
    dev = equi.device
    uv = (torch.arange(face_size, dtype=torch.float32, device=dev) + 0.5) / face_size \
        * 2.0 - 1.0
    v_grid, u_grid = torch.meshgrid(uv, uv, indexing="ij")
    faces = []
    for i in range(6):
        r, u, f = _axes(i, dev)
        d = f + u_grid[..., None] * r + v_grid[..., None] * u
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        lon = torch.atan2(d[..., 0], d[..., 2])
        lat = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0))
        x = (lon / (2.0 * math.pi) + 0.5) * w - 0.5
        y = (0.5 - lat / math.pi) * h - 0.5
        x0 = torch.floor(x).int()
        y0 = torch.floor(y).int()
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0w = torch.remainder(x0, w).long()
        x1w = torch.remainder(x0 + 1, w).long()
        y0c = torch.clamp(y0, 0, h - 1).long()
        y1c = torch.clamp(y0 + 1, 0, h - 1).long()
        c00, c10 = equi[y0c, x0w], equi[y0c, x1w]
        c01, c11 = equi[y1c, x0w], equi[y1c, x1w]
        faces.append((c00 * (1 - fx) + c10 * fx) * (1 - fy)
                     + (c01 * (1 - fx) + c11 * fx) * fy)
    return torch.stack(faces)


def sample_cubemap(cube: Tensor, directions: Tensor) -> Tensor:
    """The nearest texel of cube (6, S, S, C) in each direction (..., 3)
    -> (..., C)."""
    d = directions
    ax, ay, az = torch.abs(d[..., 0]), torch.abs(d[..., 1]), torch.abs(d[..., 2])
    size = cube.shape[1]
    pick = lambda c, a, b: torch.where(c, torch.full_like(ax, a, dtype=torch.int64),
                                       torch.full_like(ax, b, dtype=torch.int64))
    face = torch.where((ax >= ay) & (ax >= az), pick(d[..., 0] > 0, 0, 1),
                       torch.where(ay >= az, pick(d[..., 1] > 0, 2, 3),
                                   pick(d[..., 2] > 0, 4, 5)))
    uu = torch.zeros(d.shape[:-1], device=d.device)
    vv = torch.zeros(d.shape[:-1], device=d.device)
    for i in range(6):
        r, u, f = _axes(i, d.device)
        t = torch.sum(d * f, dim=-1)
        t = torch.where(torch.abs(t) < 1e-6, 1e-6, t)
        uu = torch.where(face == i, torch.sum(d * r, dim=-1) / t, uu)
        vv = torch.where(face == i, torch.sum(d * u, dim=-1) / t, vv)
    px = torch.clamp(((uu * 0.5 + 0.5) * size).int(), 0, size - 1).long()
    py = torch.clamp(((vv * 0.5 + 0.5) * size).int(), 0, size - 1).long()
    return cube[face, py, px]
