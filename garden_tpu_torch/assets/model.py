"""Model loading: Wavefront OBJ -> engine meshes.

Rebuild of the modelc converter (include/garden/graphics/modelc.hpp:27,
source/graphics/modelc.cpp — an Assimp-based CLI producing engine
vertex/index buffers). Assimp isn't in this toolchain; OBJ covers the same
role for authored assets: positions/normals/uvs with face triangulation
(fan), per-vertex deduplication, and normal generation when missing.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from garden_tpu_torch.render.mesh import Mesh


def load_obj(path_or_text: str, from_string: bool = False) -> Mesh:
    text = path_or_text if from_string else open(path_or_text, "r",
                                                 encoding="utf-8").read()
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []
    out_pos: List = []
    out_nrm: List = []
    out_uv: List = []
    out_idx: List = []
    vert_cache: Dict[Tuple[int, int, int], int] = {}

    def emit(spec: str) -> int:
        parts = (spec.split("/") + ["", ""])[:3]
        vi = int(parts[0])
        ti = int(parts[1]) if parts[1] else 0
        ni = int(parts[2]) if parts[2] else 0
        key = (vi, ti, ni)
        if key in vert_cache:
            return vert_cache[key]
        idx = len(out_pos)
        vert_cache[key] = idx
        out_pos.append(positions[vi - 1 if vi > 0 else vi])
        out_uv.append(uvs[ti - 1 if ti > 0 else ti] if ti else (0.0, 0.0))
        out_nrm.append(normals[ni - 1 if ni > 0 else ni] if ni else None)
        return idx

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        if tok[0] == "v":
            positions.append(tuple(float(x) for x in tok[1:4]))
        elif tok[0] == "vn":
            normals.append(tuple(float(x) for x in tok[1:4]))
        elif tok[0] == "vt":
            uvs.append(tuple(float(x) for x in tok[1:3]))
        elif tok[0] == "f":
            verts = [emit(s) for s in tok[1:]]
            for i in range(1, len(verts) - 1):  # fan triangulation
                out_idx.append((verts[0], verts[i], verts[i + 1]))

    pos = np.asarray(out_pos, np.float32)
    uv = np.asarray(out_uv, np.float32)
    idx = np.asarray(out_idx, np.int32)

    # generate smooth normals where missing
    nrm = np.zeros_like(pos)
    have_all = all(n is not None for n in out_nrm)
    if have_all:
        nrm = np.asarray(out_nrm, np.float32)
    else:
        for a, b, c in idx:
            fn = np.cross(pos[b] - pos[a], pos[c] - pos[a])
            nrm[a] += fn
            nrm[b] += fn
            nrm[c] += fn
        lens = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = nrm / np.maximum(lens, 1e-9)
    return Mesh(pos, nrm, uv, idx)


def save_obj(mesh: Mesh, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for p in mesh.positions:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for n in mesh.normals:
            f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for t in mesh.uvs:
            f.write(f"vt {t[0]} {t[1]}\n")
        for a, b, c in mesh.indices + 1:
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
