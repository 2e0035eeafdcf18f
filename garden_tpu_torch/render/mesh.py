"""Triangle meshes, materials and the scene buffers.

Port of `garden_tpu.render.mesh`. Meshes and the scene pools are host-side
numpy, as in the reference; `SceneBuffers.device_arrays` copies them to a
device under the reference's keys and layouts. The reference expands
per-instance data to triangles with blocked broadcasts (a TPU gather
workaround); the port indexes by `tri_instance`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class Mesh:
    """Host-side triangle mesh: positions (V,3), normals (V,3), uvs (V,2),
    triangle indices (T,3)."""

    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray

    @property
    def vertex_count(self) -> int:
        return self.positions.shape[0]

    @property
    def triangle_count(self) -> int:
        return self.indices.shape[0]


def cube(half: float = 0.5) -> Mesh:
    """Cube with per-face normals (24 vertices, 12 triangles)."""
    faces = [
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for n, u, v in faces:
        n, u, v = (np.array(x, np.float32) for x in (n, u, v))
        base = len(pos)
        for su, sv, tu, tv in ((-1, -1, 0, 0), (1, -1, 1, 0), (1, 1, 1, 1),
                               (-1, 1, 0, 1)):
            pos.append((n + u * su + v * sv) * half)
            nrm.append(n)
            uv.append((tu, tv))
        idx += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    return Mesh(np.array(pos, np.float32), np.array(nrm, np.float32),
                np.array(uv, np.float32), np.array(idx, np.int32))


def plane_grid(size: float = 10.0, divisions: int = 8, y: float = 0.0) -> Mesh:
    """Subdivided ground plane."""
    pos, nrm, uv, idx = [], [], [], []
    n = divisions + 1
    for iz in range(n):
        for ix in range(n):
            pos.append(((ix / divisions - 0.5) * size, y,
                        (iz / divisions - 0.5) * size))
            nrm.append((0.0, 1.0, 0.0))
            uv.append((ix / divisions, iz / divisions))
    for iz in range(divisions):
        for ix in range(divisions):
            a = iz * n + ix
            b = a + n
            idx += [(a, b, a + 1), (a + 1, b, b + 1)]
    return Mesh(np.array(pos, np.float32), np.array(nrm, np.float32),
                np.array(uv, np.float32), np.array(idx, np.int32))


@dataclasses.dataclass(frozen=True)
class Material:
    """PBR material. base_texture rides in the shading record (the port
    has no texture sampling yet); blend_mode routes non-opaque content to
    other passes."""

    base_color: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    metallic: float = 0.0
    roughness: float = 0.5
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    reflectance: float = 0.5
    alpha: float = 1.0
    base_texture: int = -1
    blend_mode: str = "opaque"


class SceneBuffers:
    """Fixed-capacity geometry, material and instance pools (host numpy)."""

    def __init__(self, max_vertices: int, max_triangles: int,
                 max_instances: int, max_materials: int = 64):
        self.max_vertices = max_vertices
        self.max_triangles = max_triangles
        self.max_instances = max_instances
        self.positions = np.zeros((max_vertices, 3), np.float32)
        self.normals = np.zeros((max_vertices, 3), np.float32)
        self.uvs = np.zeros((max_vertices, 2), np.float32)
        self.indices = np.zeros((max_triangles, 3), np.int32)
        self.tri_valid = np.zeros((max_triangles,), bool)
        # rows: [base3, metallic, roughness, emissive3, reflectance, alpha,
        # base_texture, blend_mode]
        self.materials = np.zeros((max_materials, 12), np.float32)
        self.materials[:, 10] = -1.0
        self._v = 0
        self._t = 0
        self._m = 0
        self.inst_material = np.zeros((max_instances,), np.int32)
        self._i = 0
        self.tri_instance = np.full((max_triangles,), -1, np.int32)
        self.inst_aabb_min = np.zeros((max_instances, 3), np.float32)
        self.inst_aabb_max = np.zeros((max_instances, 3), np.float32)

    def add_material(self, mat: Material) -> int:
        m = self._m
        self.materials[m, 0:3] = mat.base_color
        self.materials[m, 3] = mat.metallic
        self.materials[m, 4] = mat.roughness
        self.materials[m, 5:8] = mat.emissive
        self.materials[m, 8] = mat.reflectance
        self.materials[m, 9] = mat.alpha
        self.materials[m, 10] = mat.base_texture
        self.materials[m, 11] = {"opaque": 0, "oit": 1, "sorted": 2,
                                 "refract": 3}[mat.blend_mode]
        self._m += 1
        return m

    def add_instance(self, mesh: Mesh, material: int = 0) -> int:
        """Instantiate a mesh: its geometry is copied into the pools."""
        if self._i >= self.max_instances:
            raise RuntimeError("instance capacity exhausted")
        v0, t0 = self._v, self._t
        nv, nt = mesh.vertex_count, mesh.triangle_count
        if v0 + nv > self.max_vertices or t0 + nt > self.max_triangles:
            raise RuntimeError("scene buffer capacity exhausted")
        inst = self._i
        self._i += 1
        self.positions[v0:v0 + nv] = mesh.positions
        self.normals[v0:v0 + nv] = mesh.normals
        self.uvs[v0:v0 + nv] = mesh.uvs
        self.indices[t0:t0 + nt] = mesh.indices + v0
        self.tri_valid[t0:t0 + nt] = True
        self.tri_instance[t0:t0 + nt] = inst
        self._v = v0 + nv
        self._t = t0 + nt
        self.inst_material[inst] = material
        self.inst_aabb_min[inst] = mesh.positions.min(axis=0)
        self.inst_aabb_max[inst] = mesh.positions.max(axis=0)
        return inst

    def _tri_mask(self, inst_sel: np.ndarray) -> np.ndarray:
        ti = np.maximum(self.tri_instance, 0)
        return inst_sel[ti] & (self.tri_instance >= 0)

    def tri_translucent_mask(self) -> np.ndarray:
        """Triangles of the OIT pass: mode 'oit', or 'opaque' with alpha < 1."""
        mat = self.materials[self.inst_material]
        mode = mat[:, 11].astype(np.int32)
        return self._tri_mask((mode == 1) | ((mode == 0) & (mat[:, 9] < 1.0)))

    def tri_sorted_mask(self) -> np.ndarray:
        mat = self.materials[self.inst_material]
        return self._tri_mask(mat[:, 11].astype(np.int32) == 2)

    def tri_refract_mask(self) -> np.ndarray:
        mat = self.materials[self.inst_material]
        return self._tri_mask(mat[:, 11].astype(np.int32) == 3)

    def device_arrays(self, device) -> Dict[str, Tensor]:
        """The device arrays the renderer reads, under the reference's keys
        and layouts (a subset of the reference's scene dict)."""
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        return {
            "tri_valid": t(self.tri_valid),
            "tri_translucent": t(self.tri_translucent_mask()),
            "tri_sorted": t(self.tri_sorted_mask()),
            "tri_refract": t(self.tri_refract_mask()),
            "tri_instance": t(self.tri_instance),
            "inst_material": t(self.inst_material),
            "inst_aabb_min": t(self.inst_aabb_min),
            "inst_aabb_max": t(self.inst_aabb_max),
            "inst_valid": t(np.arange(self.max_instances) < self._i),
            "materials": t(self.materials),
            "tri_uvs": t(self.uvs[self.indices]),
            # (component, corner, T): the per-component planes
            "tri_pos_local_t": t(np.transpose(self.positions[self.indices], (2, 1, 0))),
            "tri_nrm_local_t": t(np.transpose(self.normals[self.indices], (2, 1, 0))),
        }


def transform_triangle_planes(scene: Dict[str, Tensor], inst_matrices: Tensor
                              ) -> Tuple[Tuple[Tensor, Tensor, Tensor],
                                         Tuple[Tensor, Tensor, Tensor]]:
    """Per-triangle world corners and unit normals as per-component (3, T)
    planes: ((px, py, pz), (nx, ny, nz)); plane row k is corner k.
    Triangles without an instance get zero matrices."""
    ti = scene["tri_instance"]
    rows = inst_matrices[:, :3, :].reshape(-1, 12)[torch.clamp(ti, min=0).long()]
    rows = torch.where((ti >= 0)[:, None], rows, torch.zeros_like(rows))
    rows_t = rows.T                                    # (12, T): row 4i + j = M[i, j]
    r = lambda i, j: rows_t[4 * i + j][None, :]
    lp = scene["tri_pos_local_t"]                      # (3 comp, 3 corner, T)
    ln = scene["tri_nrm_local_t"]
    pos = tuple(r(k, 0) * lp[0] + r(k, 1) * lp[1] + r(k, 2) * lp[2] + r(k, 3)
                for k in range(3))
    nr = tuple(r(k, 0) * ln[0] + r(k, 1) * ln[1] + r(k, 2) * ln[2]
               for k in range(3))
    inv_len = torch.rsqrt(torch.clamp(nr[0] * nr[0] + nr[1] * nr[1]
                                      + nr[2] * nr[2], min=1e-12))
    return pos, tuple(c * inv_len for c in nr)
