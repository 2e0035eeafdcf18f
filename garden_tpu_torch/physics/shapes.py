"""Collision shapes as a deduplicated structure-of-arrays table.

Port of `garden_tpu.physics.shapes`. The table is host-side numpy, as in
the reference; `device_arrays` copies it to a device.

Shape params layout (f32[4]):
- SPHERE:      [radius, -, -, -]
- BOX:         [hx, hy, hz, convex_radius]
- CAPSULE:     [radius, half_height, -, -]   (axis = local Y)
- HULL:        [hull_index, convex_radius, -, -]  (side tables below)
- COMPOUND:    [compound_index, -, -, -]
- PLANE:       [nx, ny, nz, d]  with n.x + d = 0 on the plane
- HEIGHTFIELD: [hf_index, cell_size, nx, nz]  (grid centered on local origin)
- MESH:        [mesh_index, -, -, -]  (triangle soup in a uniform local grid;
               static bodies only)

Hulls, heightfields, meshes and compounds carry more than 4 floats, so they
live in fixed-capacity side tables on the ShapeTable: hull vertex, face and
edge-direction pools, height grids, binned mesh triangles and compound child
lists.

Type ids equal the reference's, so canonical (type(a) <= type(b)) pair order
puts field-like shapes (plane, heightfield, mesh) on the B side.
"""

from __future__ import annotations

import hashlib
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

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

SHAPE_NAMES = {EMPTY: "empty", SPHERE: "sphere", BOX: "box",
               CAPSULE: "capsule", HULL: "hull", COMPOUND: "compound",
               PLANE: "plane", HEIGHTFIELD: "heightfield", MESH: "mesh"}

MAX_HULL_VERTS = 32
MAX_HULL_FACES = 32
MAX_HULL_DIRS = 8
MAX_CHILDREN = 4


def _convex_hull_host(points: np.ndarray):
    """Host-side convex hull: unique hull vertices, outward face normals
    (coplanar faces merged), and outward-wound triangles for the mass
    integrals."""
    from scipy.spatial import ConvexHull  # host-only dependency

    hull = ConvexHull(np.asarray(points, np.float64))
    verts = hull.points[hull.vertices]
    # equations rows are [n, b] with n.x + b <= 0 inside: outward n
    normals = hull.equations[:, :3]
    uniq: List[np.ndarray] = []
    for n in normals:
        if not any(np.dot(n, u) > 1.0 - 1e-6 for u in uniq):
            uniq.append(n)
    # scipy does not promise a winding; signed-tet integrals need outward
    tris = hull.points[hull.simplices].astype(np.float64)
    tri_n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    flip = np.einsum("ij,ij->i", tri_n, normals) < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    return verts.astype(np.float32), np.array(uniq, np.float32), tris


def _polyhedron_mass(simplices: np.ndarray, density: float):
    """Mass, COM and diagonal inertia (about the COM) of a closed triangular
    surface by signed-tetrahedron decomposition."""
    a, b, c = simplices[:, 0], simplices[:, 1], simplices[:, 2]
    cross = np.cross(b - a, c - a)
    vol6 = np.einsum("ij,ij->i", a, cross)          # signed, 6x tet volume
    volume = np.abs(vol6.sum()) / 6.0
    sign = 1.0 if vol6.sum() >= 0 else -1.0
    com = (sign * (vol6[:, None] * (a + b + c)).sum(0)) / (24.0 * max(volume, 1e-12))

    def sq_int(pa, pb, pc):
        return pa * pa + pb * pb + pc * pc + pa * pb + pb * pc + pc * pa
    ints = np.zeros(3)
    for i in range(3):
        ints[i] = (sign * vol6 / 60.0 * sq_int(a[:, i], b[:, i], c[:, i])).sum()
    ints = ints - volume * com ** 2                 # about the COM
    mass = density * volume
    inertia = density * np.array([
        ints[1] + ints[2], ints[0] + ints[2], ints[0] + ints[1]])
    return mass, com.astype(np.float32), np.maximum(inertia, 1e-12).astype(np.float32)


class ShapeTable:
    """Host-side shape registry with content-hash dedup: creating the same
    shape twice returns the same index."""

    def __init__(self, capacity: int = 1024, max_hulls: int = 16,
                 max_heightfields: int = 4, hf_dim: int = 128,
                 max_compounds: int = 32, max_meshes: int = 4,
                 mesh_max_tris: int = 4096, mesh_grid: int = 8,
                 mesh_bucket: int = 32) -> None:
        self.capacity = capacity
        self.types = np.zeros((capacity,), dtype=np.int32)
        self.params = np.zeros((capacity, 4), dtype=np.float32)
        self.density = np.ones((capacity,), dtype=np.float32)
        self._count = 0
        self._dedup: Dict[bytes, int] = {}
        self.hull_verts = np.zeros((max_hulls, MAX_HULL_VERTS, 3), np.float32)
        self.hull_vert_valid = np.zeros((max_hulls, MAX_HULL_VERTS), bool)
        self.hull_face_n = np.zeros((max_hulls, MAX_HULL_FACES, 3), np.float32)
        self.hull_face_valid = np.zeros((max_hulls, MAX_HULL_FACES), bool)
        # distinct edge directions (deduped by +-direction) for the
        # edge-cross SAT axes of hull-hull and box-hull pairs
        self.hull_edge_dirs = np.zeros((max_hulls, MAX_HULL_DIRS, 3), np.float32)
        self.hull_edge_valid = np.zeros((max_hulls, MAX_HULL_DIRS), bool)
        self._hull_mass: Dict[int, Tuple[float, np.ndarray]] = {}
        self._n_hulls = 0
        self.hf_dim = hf_dim
        self.hf_heights = np.zeros((max_heightfields, hf_dim, hf_dim), np.float32)
        self._n_hf = 0
        self.comp_type = np.zeros((max_compounds, MAX_CHILDREN), np.int32)
        self.comp_params = np.zeros((max_compounds, MAX_CHILDREN, 4), np.float32)
        self.comp_pos = np.zeros((max_compounds, MAX_CHILDREN, 3), np.float32)
        self.comp_quat = np.tile(np.array([0, 0, 0, 1], np.float32),
                                 (max_compounds, MAX_CHILDREN, 1))
        self._comp_mass: Dict[int, Tuple[float, np.ndarray]] = {}
        self._n_comp = 0
        # triangle meshes: a soup binned into a uniform local grid of
        # fixed-capacity buckets
        self.mesh_grid = mesh_grid
        self.mesh_bucket = mesh_bucket
        self.mesh_tris = np.zeros((max_meshes, mesh_max_tris, 3, 3), np.float32)
        self.mesh_cells = np.full((max_meshes, mesh_grid ** 3, mesh_bucket), -1,
                                  np.int32)
        # [origin xyz | cell size | grid dim | tri count | pad pad]
        self.mesh_info = np.zeros((max_meshes, 8), np.float32)
        self._n_mesh = 0

    def _intern(self, stype: int, params, density: float) -> int:
        params = np.asarray(params, dtype=np.float32)
        key = hashlib.blake2b(
            np.concatenate([[stype], params, [density]]).astype(np.float32).tobytes(),
            digest_size=16,
        ).digest()
        if key in self._dedup:
            return self._dedup[key]
        return self._intern_raw(stype, params, density, key)

    def _intern_raw(self, stype: int, params, density: float, key: bytes) -> int:
        """Register a shape row under a precomputed dedup key."""
        if self._count >= self.capacity:
            raise RuntimeError("shape capacity exhausted")
        idx = self._count
        self._count += 1
        self.types[idx] = stype
        self.params[idx] = np.asarray(params, np.float32)
        self.density[idx] = density
        self._dedup[key] = idx
        return idx

    def sphere(self, radius: float, density: float = 1000.0) -> int:
        return self._intern(SPHERE, [radius, 0, 0, 0], density)

    def box(self, half_extents, convex_radius: float = 0.05,
            density: float = 1000.0) -> int:
        hx, hy, hz = half_extents
        return self._intern(BOX, [hx, hy, hz, convex_radius], density)

    def capsule(self, radius: float, half_height: float,
                density: float = 1000.0) -> int:
        return self._intern(CAPSULE, [radius, half_height, 0, 0], density)

    def plane(self, normal=(0.0, 1.0, 0.0), d: float = 0.0) -> int:
        n = np.asarray(normal, np.float32)
        n = n / np.linalg.norm(n)
        return self._intern(PLANE, [n[0], n[1], n[2], d], 1000.0)

    def hull(self, points, convex_radius: float = 0.05,
             density: float = 1000.0) -> int:
        """Convex hull of a point cloud. Vertices are re-centred so the
        hull's centre of mass sits at the body origin."""
        pts = np.asarray(points, np.float32)
        key = hashlib.blake2b(
            np.concatenate([[HULL], pts.reshape(-1), [convex_radius, density]]
                           ).astype(np.float32).tobytes(), digest_size=16,
        ).digest()
        if key in self._dedup:
            return self._dedup[key]
        verts, face_n, simplices = _convex_hull_host(pts)
        if verts.shape[0] > MAX_HULL_VERTS:
            raise ValueError(f"hull has {verts.shape[0]} vertices; max {MAX_HULL_VERTS}")
        if face_n.shape[0] > MAX_HULL_FACES:
            raise ValueError(f"hull has {face_n.shape[0]} distinct face normals; "
                             f"max {MAX_HULL_FACES}")
        if self._n_hulls >= self.hull_verts.shape[0]:
            raise RuntimeError("hull capacity exhausted")
        mass, com, inertia = _polyhedron_mass(simplices, density)
        h = self._n_hulls
        self._n_hulls += 1
        nv = verts.shape[0]
        self.hull_verts[h, :nv] = verts - com
        self.hull_vert_valid[h, :nv] = True
        nf = face_n.shape[0]
        self.hull_face_n[h, :nf] = face_n
        self.hull_face_valid[h, :nf] = True
        # distinct edge directions of the simplices (a box-like hull gives
        # its 3 axes)
        dirs: List[np.ndarray] = []
        for tri in simplices:
            for a_, b_ in ((0, 1), (1, 2), (2, 0)):
                d = tri[b_] - tri[a_]
                nrm = np.linalg.norm(d)
                if nrm < 1e-9:
                    continue
                d = d / nrm
                if not any(abs(np.dot(d, u)) > 1.0 - 1e-4 for u in dirs):
                    dirs.append(d)
                if len(dirs) >= MAX_HULL_DIRS:
                    break
            if len(dirs) >= MAX_HULL_DIRS:
                break
        if dirs:
            self.hull_edge_dirs[h, :len(dirs)] = np.asarray(dirs, np.float32)
            self.hull_edge_valid[h, :len(dirs)] = True
        self._hull_mass[h] = (mass, inertia)
        return self._intern_raw(HULL, [float(h), convex_radius, 0.0, 0.0],
                                density, key)

    def heightfield(self, heights: np.ndarray, cell: float = 1.0) -> int:
        """Terrain height grid centred on the body origin in local XZ, sample
        spacing `cell`."""
        hts = np.asarray(heights, np.float32)
        nz, nx = hts.shape
        if nx > self.hf_dim or nz > self.hf_dim:
            raise ValueError(f"heightfield {nz}x{nx} exceeds table dim {self.hf_dim}")
        key = hashlib.blake2b(
            np.concatenate([[HEIGHTFIELD, cell], hts.reshape(-1)]
                           ).astype(np.float32).tobytes(), digest_size=16,
        ).digest()
        if key in self._dedup:
            return self._dedup[key]
        if self._n_hf >= self.hf_heights.shape[0]:
            raise RuntimeError("heightfield capacity exhausted")
        f = self._n_hf
        self._n_hf += 1
        # edge-replicate into the fixed-size slab so clamped samples are flat
        self.hf_heights[f, :nz, :nx] = hts
        self.hf_heights[f, nz:, :nx] = hts[-1:, :]
        self.hf_heights[f, :nz, nx:] = self.hf_heights[f, :nz, nx - 1:nx]
        self.hf_heights[f, nz:, nx:] = hts[-1, -1]
        return self._intern_raw(
            HEIGHTFIELD, [float(f), cell, float(nx), float(nz)], 1000.0, key)

    def mesh(self, vertices: np.ndarray, indices: np.ndarray) -> int:
        """Static triangle-mesh collider. `vertices` (V, 3) local positions,
        `indices` (T, 3) CCW triangles (outward normals by the right-hand
        rule). Triangles are binned into a uniform grid of fixed-capacity
        buckets over the mesh AABB; a full bucket drops triangles. Mesh
        bodies must be static or kinematic."""
        verts = np.asarray(vertices, np.float32)
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        if idx.shape[0] > self.mesh_tris.shape[1]:
            raise ValueError(f"mesh has {idx.shape[0]} triangles; max "
                             f"{self.mesh_tris.shape[1]}")
        key = hashlib.blake2b(verts.tobytes() + idx.tobytes(), digest_size=16).digest()
        if key in self._dedup:
            return self._dedup[key]
        if self._n_mesh >= self.mesh_tris.shape[0]:
            raise RuntimeError("mesh capacity exhausted")
        m = self._n_mesh
        self._n_mesh += 1
        tris = verts[idx]                       # (T, 3, 3)
        t = tris.shape[0]
        self.mesh_tris[m, :t] = tris
        g = self.mesh_grid
        lo = tris.reshape(-1, 3).min(axis=0)
        hi = tris.reshape(-1, 3).max(axis=0)
        # cubical cells, padded slightly so border triangles land inside
        cell = float(max((hi - lo).max() / g, 1e-6)) * 1.001
        origin = (lo + hi) * 0.5 - 0.5 * cell * g
        counts = np.zeros((g, g, g), np.int32)
        cells = self.mesh_cells[m].reshape(g, g, g, self.mesh_bucket)
        # half-cell inflation: a query point probes only its own cell, so a
        # point slightly past a face must still find the neighbour's triangle
        inflate = 0.5 * cell
        tmin = ((tris.min(axis=1) - inflate - origin) / cell).astype(np.int32)
        tmax = ((tris.max(axis=1) + inflate - origin) / cell).astype(np.int32)
        tmin = np.clip(tmin, 0, g - 1)
        tmax = np.clip(tmax, 0, g - 1)
        dropped = 0
        for ti in range(t):
            for cx in range(tmin[ti, 0], tmax[ti, 0] + 1):
                for cy in range(tmin[ti, 1], tmax[ti, 1] + 1):
                    for cz in range(tmin[ti, 2], tmax[ti, 2] + 1):
                        c = counts[cx, cy, cz]
                        if c < self.mesh_bucket:
                            cells[cx, cy, cz, c] = ti
                            counts[cx, cy, cz] = c + 1
                        else:
                            dropped += 1
        if dropped:
            warnings.warn(f"mesh bucket overflow: {dropped} (cell, tri) insertions "
                          f"dropped (raise mesh_bucket or mesh_grid)")
        self.mesh_info[m, 0:3] = origin
        self.mesh_info[m, 3] = cell
        self.mesh_info[m, 4] = g
        self.mesh_info[m, 5] = t
        return self._intern_raw(MESH, [float(m), 0.0, 0.0, 0.0], 1000.0, key)

    def compound(self, children: Sequence[Tuple[int, Tuple, Tuple]]) -> int:
        """Compound of up to MAX_CHILDREN convex children, each (child shape
        index, local position, local quaternion); children are spheres,
        boxes or capsules."""
        if not 1 <= len(children) <= MAX_CHILDREN:
            raise ValueError(f"compound supports 1..{MAX_CHILDREN} children")
        blob: List[float] = [COMPOUND]
        for sidx, cpos, cquat in children:
            st = int(self.types[sidx])
            if st not in (SPHERE, BOX, CAPSULE):
                raise ValueError("compound children must be sphere/box/capsule, got "
                                 + SHAPE_NAMES.get(st, str(st)))
            blob += [sidx, *cpos, *cquat]
        key = hashlib.blake2b(np.asarray(blob, np.float32).tobytes(),
                              digest_size=16).digest()
        if key in self._dedup:
            return self._dedup[key]
        if self._n_comp >= self.comp_type.shape[0]:
            raise RuntimeError("compound capacity exhausted")
        c = self._n_comp
        self._n_comp += 1
        total_mass = 0.0
        inertia = np.zeros(3)
        for k, (sidx, cpos, cquat) in enumerate(children):
            st = int(self.types[sidx])
            self.comp_type[c, k] = st
            self.comp_params[c, k] = self.params[sidx]
            self.comp_pos[c, k] = cpos
            self.comp_quat[c, k] = cquat
            m, i_diag = mass_properties_np(st, self.params[sidx],
                                           float(self.density[sidx]))
            # the child's inertia rotated into the compound frame (diagonal
            # part) plus the parallel-axis shift; the body inertia model is
            # diagonal in the local frame, so off-diagonal products drop
            x, y, z, w = np.asarray(cquat, np.float64)
            rot = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            i_rot = np.diag(rot @ np.diag(i_diag) @ rot.T)
            d = np.asarray(cpos, np.float64)
            inertia += i_rot + m * (np.dot(d, d) - d * d)
            total_mass += m
        self._comp_mass[c] = (total_mass, np.maximum(inertia, 1e-12).astype(np.float32))
        return self._intern_raw(COMPOUND, [float(c), 0.0, 0.0, 0.0], 1000.0, key)

    def hull_local_extent(self) -> np.ndarray:
        """(max_hulls, 3) max |vert| per axis, for the AABBs."""
        v = np.where(self.hull_vert_valid[..., None], np.abs(self.hull_verts), 0.0)
        return v.max(axis=1)

    def compound_local_extent(self) -> np.ndarray:
        """(max_compounds, 3) conservative extent: child offset + child AABB."""
        ext = np.zeros((self.comp_type.shape[0], 3), np.float32)
        for c in range(self._n_comp):
            for k in range(MAX_CHILDREN):
                st = int(self.comp_type[c, k])
                if st == EMPTY:
                    continue
                p = self.comp_params[c, k]
                if st == SPHERE:
                    e = np.array([p[0]] * 3)
                elif st == BOX:
                    e = np.linalg.norm(p[:3]) * np.ones(3)  # rotation-safe
                else:  # capsule
                    e = (p[0] + p[1]) * np.ones(3)
                ext[c] = np.maximum(ext[c], np.abs(self.comp_pos[c, k]) + e)
        return ext

    def device_arrays(self, device) -> Dict[str, Tensor]:
        host = {
            "type": self.types, "params": self.params, "density": self.density,
            "hull_verts": self.hull_verts, "hull_vert_valid": self.hull_vert_valid,
            "hull_face_n": self.hull_face_n, "hull_face_valid": self.hull_face_valid,
            "hull_edge_dirs": self.hull_edge_dirs,
            "hull_edge_valid": self.hull_edge_valid,
            "hull_ext": self.hull_local_extent().astype(np.float32),
            "hf_heights": self.hf_heights,
            "comp_type": self.comp_type, "comp_params": self.comp_params,
            "comp_pos": self.comp_pos, "comp_quat": self.comp_quat,
            "comp_ext": self.compound_local_extent(),
            "mesh_tris": self.mesh_tris, "mesh_cells": self.mesh_cells,
            "mesh_info": self.mesh_info,
        }
        return {k: torch.as_tensor(np.array(v), device=device) for k, v in host.items()}

    def count(self) -> int:
        return self._count

    def present_types(self) -> frozenset:
        """Shape types in use (the narrowphase runs only their pair kernels);
        compound child types count, since their kernels run."""
        present = {int(t) for t in self.types[: self._count]}
        for c in range(self._n_comp):
            present |= {int(t) for t in self.comp_type[c] if t != EMPTY}
        return frozenset(present)

    def body_mass_properties(self, shape_idx: int) -> Tuple[float, np.ndarray]:
        """Host-side (mass, diagonal inertia) of any shape row."""
        stype = int(self.types[shape_idx])
        if stype == HULL:
            return self._hull_mass[int(self.params[shape_idx, 0])]
        if stype == COMPOUND:
            return self._comp_mass[int(self.params[shape_idx, 0])]
        return mass_properties_np(stype, self.params[shape_idx],
                                  float(self.density[shape_idx]))


def mass_properties(stype: Tensor, params: Tensor, density: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """(mass, local diagonal inertia) per shape, batched; hulls and
    compounds get the reference's unit placeholder (their true values come
    from `ShapeTable.body_mass_properties`)."""
    r = params[..., 0]
    hx, hy, hz = params[..., 0], params[..., 1], params[..., 2]
    hh = params[..., 1]
    sphere_mass = density * (4.0 / 3.0) * torch.pi * r ** 3
    sphere_i = 0.4 * sphere_mass * r ** 2
    sphere_inertia = torch.stack([sphere_i, sphere_i, sphere_i], -1)
    box_mass = density * 8.0 * hx * hy * hz
    box_inertia = (box_mass[..., None] / 3.0) * torch.stack(
        [hy ** 2 + hz ** 2, hx ** 2 + hz ** 2, hx ** 2 + hy ** 2], -1)
    # capsule: a cylinder and two hemispheres about local Y
    cyl_m = density * torch.pi * r ** 2 * (2.0 * hh)
    hem_m = density * (2.0 / 3.0) * torch.pi * r ** 3
    cap_mass = cyl_m + 2.0 * hem_m
    cyl_iy = 0.5 * cyl_m * r ** 2
    cyl_ix = cyl_m * (3.0 * r ** 2 + (2.0 * hh) ** 2) / 12.0
    hem_iy = 0.4 * hem_m * r ** 2
    hem_ix = hem_iy + hem_m * (hh + 3.0 * r / 8.0) ** 2
    cap_inertia = torch.stack([cyl_ix + 2.0 * hem_ix, cyl_iy + 2.0 * hem_iy,
                               cyl_ix + 2.0 * hem_ix], -1)
    mass = torch.ones_like(r)
    inertia = torch.ones_like(sphere_inertia)
    for t, m, i in ((CAPSULE, cap_mass, cap_inertia), (BOX, box_mass, box_inertia),
                    (SPHERE, sphere_mass, sphere_inertia)):
        mass = torch.where(stype == t, m, mass)
        inertia = torch.where((stype == t)[..., None], i, inertia)
    return mass, inertia


def mass_properties_np(stype: int, params: np.ndarray, density: float
                       ) -> Tuple[float, np.ndarray]:
    """Host-side scalar mass properties (world construction stays on host)."""
    params = np.asarray(params, np.float64)
    density = float(density)
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
    if stype == CAPSULE:
        r, hh = params[0], params[1]
        cyl_m = density * np.pi * r * r * (2.0 * hh)
        hem_m = density * (2.0 / 3.0) * np.pi * r ** 3
        m = cyl_m + 2.0 * hem_m
        cyl_iy = 0.5 * cyl_m * r * r
        cyl_ix = cyl_m * (3.0 * r * r + (2.0 * hh) ** 2) / 12.0
        hem_iy = 0.4 * hem_m * r * r
        hem_ix = hem_iy + hem_m * (hh + 3.0 * r / 8.0) ** 2
        ix = cyl_ix + 2.0 * hem_ix
        iy = cyl_iy + 2.0 * hem_iy
        return m, np.array([ix, iy, ix], np.float32)
    return 1.0, np.ones(3, np.float32)


def local_aabb(stype: Tensor, params: Tensor,
               hull_ext: Optional[Tensor] = None,
               comp_ext: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Shape-local AABB (min, max), batched. hull_ext/comp_ext: per-row
    extents of HULL/COMPOUND rows from the side tables; planes,
    heightfields and meshes bypass the grid and get an unbounded box."""
    r = params[..., 0]
    sphere_ext = torch.stack([r, r, r], -1)
    cap_ext = torch.stack([r, r + params[..., 1], r], -1)
    ext = torch.zeros_like(sphere_ext)
    conds = [(stype == SPHERE, sphere_ext), (stype == BOX, params[..., :3]),
             (stype == CAPSULE, cap_ext),
             ((stype == PLANE) | (stype == HEIGHTFIELD) | (stype == MESH),
              torch.full_like(sphere_ext, 1e9))]
    if hull_ext is not None:
        conds.append((stype == HULL, hull_ext))
    if comp_ext is not None:
        conds.append((stype == COMPOUND, comp_ext))
    for cond, val in reversed(conds):     # the first true condition wins
        ext = torch.where(cond[..., None], val, ext)
    return -ext, ext
