"""Triangle meshes, materials and the scene buffers.

Port of `garden_tpu.render.mesh`. Meshes and the scene pools are host-side
numpy, as in the reference; `SceneBuffers.device_arrays` copies them to a
device under the reference's keys and layouts. The pools also hold a
fixed-size RGBA texture array (`add_texture`) and LOD chains
(`add_instance_lods`: every level resident, tagged per triangle, one level
chosen per instance and frame by camera distance). The reference expands
per-instance data to triangles with blocked broadcasts (a TPU gather
workaround); the port indexes by `tri_instance`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.core import math3d as m3

Tensor = torch.Tensor

MAX_LODS = 4


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


def uv_sphere(radius: float = 0.5, rings: int = 12, segments: int = 24) -> Mesh:
    """Latitude-longitude sphere: (rings + 1) x (segments + 1) vertices,
    2 x rings x segments triangles."""
    pos, nrm, uv, idx = [], [], [], []
    for r in range(rings + 1):
        phi = math.pi * r / rings
        for s in range(segments + 1):
            theta = 2.0 * math.pi * s / segments
            n = (math.sin(phi) * math.cos(theta), math.cos(phi),
                 math.sin(phi) * math.sin(theta))
            pos.append(np.array(n) * radius)
            nrm.append(n)
            uv.append((s / segments, r / rings))
    cols = segments + 1
    for r in range(rings):
        for s in range(segments):
            a = r * cols + s
            b = a + cols
            idx += [(a, b, a + 1), (a + 1, b, b + 1)]
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


def heightfield(heights: np.ndarray, cell: float = 1.0) -> Mesh:
    """Terrain mesh from an (H, W) height grid, centred on the origin, with
    normals from central differences."""
    h, w = heights.shape
    xs = (np.arange(w) - (w - 1) / 2.0) * cell
    zs = (np.arange(h) - (h - 1) / 2.0) * cell
    px, pz = np.meshgrid(xs, zs)
    pos = np.stack([px, heights, pz], axis=-1).reshape(-1, 3).astype(np.float32)
    gx = np.gradient(heights, cell, axis=1)
    gz = np.gradient(heights, cell, axis=0)
    nrm = np.stack([-gx, np.ones_like(heights), -gz], axis=-1)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).reshape(-1, 3).astype(np.float32)
    uv = np.stack(np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h)),
                  axis=-1).reshape(-1, 2).astype(np.float32)
    idx = []
    for iz in range(h - 1):
        for ix in range(w - 1):
            a = iz * w + ix
            b = a + w
            idx += [(a, b, a + 1), (a + 1, b, b + 1)]
    return Mesh(pos, nrm, uv, np.array(idx, np.int32))


def resize_image(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Host-side bilinear resize of a float image in [0, 1] to size (h, w),
    through 8-bit PIL; raises RuntimeError without PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("PIL unavailable") from e
    h, w = size
    u8 = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return np.asarray(Image.fromarray(u8).resize((w, h), Image.BILINEAR),
                      np.float32) / 255.0


@dataclasses.dataclass(frozen=True)
class Material:
    """PBR material. base_texture indexes the scene's texture array (-1:
    the flat base colour); blend_mode routes non-opaque content to other
    passes."""

    base_color: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    metallic: float = 0.0
    roughness: float = 0.5
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    reflectance: float = 0.5
    alpha: float = 1.0
    base_texture: int = -1
    blend_mode: str = "opaque"


class SceneBuffers:
    """Fixed-capacity geometry, material, texture and instance pools (host
    numpy)."""

    def __init__(self, max_vertices: int, max_triangles: int,
                 max_instances: int, max_materials: int = 64,
                 texture_size: int = 256, max_textures: int = 0):
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
        # the texture array: fixed-size RGBA slots
        self.texture_size = texture_size
        self.textures = np.zeros((max_textures, texture_size, texture_size, 4),
                                 np.float32)
        self._tex = 0
        self._mesh_ranges: List[Tuple[int, int, int, int]] = []  # v0, nv, t0, nt
        self._v = 0
        self._t = 0
        self._m = 0
        self.inst_material = np.zeros((max_instances,), np.int32)
        self.inst_entity = np.full((max_instances,), -1, np.int32)
        self._i = 0
        self.tri_instance = np.full((max_triangles,), -1, np.int32)
        self.vert_instance = np.full((max_vertices,), -1, np.int32)
        self.inst_aabb_min = np.zeros((max_instances, 3), np.float32)
        self.inst_aabb_max = np.zeros((max_instances, 3), np.float32)
        # LOD chains: each triangle's level, each instance's switch
        # distances (inf: no further level)
        self.tri_lod = np.zeros((max_triangles,), np.int8)
        self.inst_lod_dist = np.full((max_instances, MAX_LODS - 1), np.inf,
                                     np.float32)

    def add_mesh(self, mesh: Mesh) -> int:
        """Register a mesh's range at the pools' current ends (no geometry
        is copied: instances copy their own) -> mesh id."""
        v0, t0 = self._v, self._t
        nv, nt = mesh.vertex_count, mesh.triangle_count
        if v0 + nv > self.max_vertices or t0 + nt > self.max_triangles:
            raise RuntimeError("scene buffer capacity exhausted")
        self._mesh_ranges.append((v0, nv, t0, nt))
        return len(self._mesh_ranges) - 1

    def _mesh_store(self, mesh_id: int) -> Tuple[int, int, int, int]:
        return self._mesh_ranges[mesh_id]

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

    def add_texture(self, image: np.ndarray) -> int:
        """Store an (h, w), (h, w, 3) or (h, w, 4) float image in the next
        texture slot (grey and rgb get alpha 1; another size is resized,
        which needs PIL) -> the index for Material.base_texture."""
        if self._tex >= self.textures.shape[0]:
            raise RuntimeError("texture capacity exhausted")
        s = self.texture_size
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3 + [np.ones_like(img)], axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones(img.shape[:2] + (1,), np.float32)],
                                 axis=-1)
        if img.shape[:2] != (s, s):
            img = resize_image(img, (s, s))
        t = self._tex
        self._tex += 1
        self.textures[t] = img
        return t

    @property
    def any_textured(self) -> bool:
        return bool((self.materials[: self._m, 10] >= 0).any())

    def _copy_geometry(self, mesh: Mesh, inst: int, lod: int) -> None:
        v0, t0 = self._v, self._t
        nv, nt = mesh.vertex_count, mesh.triangle_count
        if v0 + nv > self.max_vertices or t0 + nt > self.max_triangles:
            raise RuntimeError("scene buffer capacity exhausted")
        self.positions[v0:v0 + nv] = mesh.positions
        self.normals[v0:v0 + nv] = mesh.normals
        self.uvs[v0:v0 + nv] = mesh.uvs
        self.indices[t0:t0 + nt] = mesh.indices + v0
        self.tri_valid[t0:t0 + nt] = True
        self.tri_instance[t0:t0 + nt] = inst
        self.vert_instance[v0:v0 + nv] = inst
        self.tri_lod[t0:t0 + nt] = lod
        self._v = v0 + nv
        self._t = t0 + nt

    def add_instance(self, mesh: Mesh, material: int = 0, entity: int = -1) -> int:
        """Instantiate a mesh: its geometry is copied into the pools."""
        if self._i >= self.max_instances:
            raise RuntimeError("instance capacity exhausted")
        inst = self._i
        self._copy_geometry(mesh, inst, 0)
        self._i += 1
        self.inst_material[inst] = material
        self.inst_entity[inst] = entity
        self.inst_aabb_min[inst] = mesh.positions.min(axis=0)
        self.inst_aabb_max[inst] = mesh.positions.max(axis=0)
        return inst

    def add_instance_lods(self, meshes: List[Mesh], distances: List[float],
                          material: int = 0, entity: int = -1) -> int:
        """Instance with a LOD chain: meshes[k] draws while the camera is
        within distances[k] of the instance (ascending; the last level
        covers the rest). Every level's geometry is resident; the frame's
        cull picks one level per instance."""
        if not 1 <= len(meshes) <= MAX_LODS:
            raise ValueError(f"1..{MAX_LODS} LOD levels supported")
        if len(distances) != len(meshes) - 1:
            raise ValueError("need len(meshes)-1 switch distances")
        inst = self.add_instance(meshes[0], material=material, entity=entity)
        for k, mesh in enumerate(meshes[1:], start=1):
            self._copy_geometry(mesh, inst, k)
            self.inst_aabb_min[inst] = np.minimum(self.inst_aabb_min[inst],
                                                  mesh.positions.min(axis=0))
            self.inst_aabb_max[inst] = np.maximum(self.inst_aabb_max[inst],
                                                  mesh.positions.max(axis=0))
        self.inst_lod_dist[inst, :len(distances)] = distances
        return inst

    @property
    def any_lods(self) -> bool:
        return bool((self.tri_lod != 0).any())

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
        """The device arrays the renderers read, under the reference's keys
        and layouts (the reference's scene dict without its (T, 3, 3)
        local-corner copies, which only its blocked-broadcast paths read)."""
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        return {
            "positions": t(self.positions),
            "normals": t(self.normals),
            "uvs": t(self.uvs),
            "indices": t(self.indices),
            "tri_valid": t(self.tri_valid),
            "tri_translucent": t(self.tri_translucent_mask()),
            "tri_sorted": t(self.tri_sorted_mask()),
            "tri_refract": t(self.tri_refract_mask()),
            "tri_instance": t(self.tri_instance),
            "vert_instance": t(self.vert_instance),
            "inst_material": t(self.inst_material),
            "inst_entity": t(self.inst_entity),
            "inst_aabb_min": t(self.inst_aabb_min),
            "inst_aabb_max": t(self.inst_aabb_max),
            "inst_valid": t(np.arange(self.max_instances) < self._i),
            "materials": t(self.materials),
            "textures": t(self.textures),
            "tri_lod": t(self.tri_lod.astype(np.int32)),
            "tri_uvs": t(self.uvs[self.indices]),
            # (component, corner, T): the per-component planes
            "tri_pos_local_t": t(np.transpose(self.positions[self.indices], (2, 1, 0))),
            "tri_nrm_local_t": t(np.transpose(self.normals[self.indices], (2, 1, 0))),
            "inst_lod_dist": t(self.inst_lod_dist),
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


def transform_triangles(scene: Dict[str, Tensor], inst_matrices: Tensor
                        ) -> Tuple[Tensor, Tensor]:
    """Per-triangle world corners and unit normals, (T, 3, 3) each
    (triangle, corner, component), under each triangle's instance matrix;
    triangles without an instance take instance 0's, as the reference's
    clamped gather. (The reference's `tri_instance_np` block layout is a
    TPU gather workaround with the same result on valid triangles.)"""
    rows = inst_matrices[:, :3, :].reshape(-1, 12)[
        torch.clamp(scene["tri_instance"], min=0).long()]   # (T, 12): 4i + j = M[i, j]
    c = lambda j: rows[:, None, j::4]                        # column j (T, 1, 3)
    p = scene["tri_pos_local_t"].permute(2, 1, 0)            # (T, corner, comp)
    n = scene["tri_nrm_local_t"].permute(2, 1, 0)
    pos = c(0) * p[..., 0:1] + c(1) * p[..., 1:2] + c(2) * p[..., 2:3] + c(3)
    nrm = m3.normalize(c(0) * n[..., 0:1] + c(1) * n[..., 1:2] + c(2) * n[..., 2:3])
    return pos, nrm


def transform_vertices(scene: Dict[str, Tensor], inst_matrices: Tensor
                       ) -> Tuple[Tensor, Tensor]:
    """The vertex pool in world space: (positions (V, 3), unit normals
    (V, 3)) under each vertex's instance matrix (I, 4, 4); normals take
    the matrix's 3x3 part, renormalized. Vertices without an instance take
    instance 0's matrix, as the reference's clamped gather."""
    rows = inst_matrices[:, :3, :].reshape(-1, 12)[
        torch.clamp(scene["vert_instance"], min=0).long()]   # (V, 12): 4i + j = M[i, j]
    c = lambda j: rows[:, j::4]                                # column j (V, 3)
    p, n = scene["positions"], scene["normals"]
    pos = c(0) * p[:, 0:1] + c(1) * p[:, 1:2] + c(2) * p[:, 2:3] + c(3)
    nrm = c(0) * n[:, 0:1] + c(1) * n[:, 1:2] + c(2) * n[:, 2:3]
    return pos, m3.normalize(nrm)
