"""Collision shapes as a deduplicated structure-of-arrays table.

Port of `garden_tpu.physics.shapes` for the shape kinds the port's
narrowphase handles: sphere, box and plane. The table is host-side numpy,
as in the reference; `device_arrays` copies it to a device.

Shape params layout (f32[4]):
- SPHERE: [radius, -, -, -]
- BOX:    [hx, hy, hz, convex_radius]
- PLANE:  [nx, ny, nz, d] with n.x + d = 0 on the plane

Type ids equal the reference's, so canonical (type(a) <= type(b)) pair order
puts planes on the B side.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

EMPTY = 0
SPHERE = 1
BOX = 2
CAPSULE = 3
HULL = 4
COMPOUND = 5
PLANE = 6
HEIGHTFIELD = 7
MESH = 8


class ShapeTable:
    """Host-side shape registry with content-hash dedup: creating the same
    box twice returns the same index."""

    def __init__(self, capacity: int = 1024) -> None:
        self.capacity = capacity
        self.types = np.zeros((capacity,), dtype=np.int32)
        self.params = np.zeros((capacity, 4), dtype=np.float32)
        self.density = np.ones((capacity,), dtype=np.float32)
        self._count = 0
        self._dedup: Dict[bytes, int] = {}

    def _intern(self, stype: int, params, density: float) -> int:
        params = np.asarray(params, dtype=np.float32)
        key = hashlib.blake2b(
            np.concatenate([[stype], params, [density]]).astype(np.float32).tobytes(),
            digest_size=16,
        ).digest()
        if key in self._dedup:
            return self._dedup[key]
        if self._count >= self.capacity:
            raise RuntimeError("shape capacity exhausted")
        idx = self._count
        self._count += 1
        self.types[idx] = stype
        self.params[idx] = params
        self.density[idx] = density
        self._dedup[key] = idx
        return idx

    def sphere(self, radius: float, density: float = 1000.0) -> int:
        return self._intern(SPHERE, [radius, 0, 0, 0], density)

    def box(self, half_extents, convex_radius: float = 0.05,
            density: float = 1000.0) -> int:
        hx, hy, hz = half_extents
        return self._intern(BOX, [hx, hy, hz, convex_radius], density)

    def plane(self, normal=(0.0, 1.0, 0.0), d: float = 0.0) -> int:
        n = np.asarray(normal, np.float32)
        n = n / np.linalg.norm(n)
        return self._intern(PLANE, [n[0], n[1], n[2], d], 1000.0)

    def device_arrays(self, device) -> Dict[str, Tensor]:
        return {
            "type": torch.as_tensor(self.types, device=device),
            "params": torch.as_tensor(self.params, device=device),
            "density": torch.as_tensor(self.density, device=device),
        }

    def present_types(self) -> frozenset:
        """Shape types in use: the narrowphase runs only their pair kernels."""
        return frozenset(int(t) for t in self.types[: self._count])

    def body_mass_properties(self, shape_idx: int) -> Tuple[float, np.ndarray]:
        """Host-side (mass, diagonal inertia) of one shape row."""
        return mass_properties_np(int(self.types[shape_idx]),
                                  self.params[shape_idx],
                                  float(self.density[shape_idx]))


def mass_properties(stype: Tensor, params: Tensor, density: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """(mass, local diagonal inertia) per shape, batched."""
    r = params[..., 0]
    hx, hy, hz = params[..., 0], params[..., 1], params[..., 2]
    sphere_mass = density * (4.0 / 3.0) * torch.pi * r ** 3
    sphere_i = 0.4 * sphere_mass * r ** 2
    sphere_inertia = torch.stack([sphere_i, sphere_i, sphere_i], -1)
    box_mass = density * 8.0 * hx * hy * hz
    box_inertia = (box_mass[..., None] / 3.0) * torch.stack(
        [hy ** 2 + hz ** 2, hx ** 2 + hz ** 2, hx ** 2 + hy ** 2], -1)
    is_sphere = stype == SPHERE
    is_box = stype == BOX
    one = torch.ones_like(r)
    mass = torch.where(is_sphere, sphere_mass, torch.where(is_box, box_mass, one))
    inertia = torch.where(is_sphere[..., None], sphere_inertia,
                          torch.where(is_box[..., None], box_inertia,
                                      torch.ones_like(sphere_inertia)))
    return mass, inertia


def mass_properties_np(stype: int, params: np.ndarray, density: float
                       ) -> Tuple[float, np.ndarray]:
    """Host-side scalar mass properties (world construction stays on host)."""
    params = np.asarray(params, np.float64)
    if stype == SPHERE:
        r = params[0]
        m = density * (4.0 / 3.0) * np.pi * r ** 3
        i = 0.4 * m * r * r
        return m, np.array([i, i, i], np.float32)
    if stype == BOX:
        hx, hy, hz = params[:3]
        m = density * 8.0 * hx * hy * hz
        return m, np.array([
            m / 3.0 * (hy * hy + hz * hz),
            m / 3.0 * (hx * hx + hz * hz),
            m / 3.0 * (hx * hx + hy * hy),
        ], np.float32)
    return 1.0, np.ones(3, np.float32)


def local_aabb(stype: Tensor, params: Tensor) -> Tuple[Tensor, Tensor]:
    """Shape-local AABB (min, max), batched; planes get an unbounded box."""
    r = params[..., 0:1]
    ext = torch.where((stype == SPHERE)[..., None], r.expand_as(params[..., :3]),
                      torch.zeros_like(params[..., :3]))
    ext = torch.where((stype == BOX)[..., None], params[..., :3], ext)
    ext = torch.where((stype == PLANE)[..., None], torch.full_like(ext, 1e9), ext)
    return -ext, ext
