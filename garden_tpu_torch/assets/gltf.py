"""Minimal glTF 2.0 model loader (.gltf / .glb).

The modelc-CLI analog (reference: source/modelc.cpp — an Assimp-based
any-format converter producing engine vertex/index buffers;
include/garden/graphics/modelc.hpp:27). Assimp isn't part of this stack;
glTF 2.0 is the open interchange format that covers its main use, parsed
here with no dependencies: JSON + raw buffer views -> Mesh per primitive.

Supports: GLB container, embedded data: URIs, external .bin buffers,
POSITION/NORMAL/TEXCOORD_0 attributes, uint8/16/32 indices, float vec2/vec3
accessors (the layouts exporters actually emit for static meshes).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from garden_tpu_torch.render.mesh import Mesh

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT3": 9, "MAT4": 16}


def _read_buffers(doc: dict, bin_chunk: Optional[bytes],
                  base_dir: str) -> List[bytes]:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(bin_chunk or b"")
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _accessor(doc: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    count = acc["count"]
    ncomp = _TYPE_COUNT[acc["type"]]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    data = buffers[view["buffer"]]
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        rows = []
        for i in range(count):
            start = offset + i * stride
            rows.append(np.frombuffer(data, dtype, ncomp, start))
        arr = np.stack(rows)
    else:
        arr = np.frombuffer(data, dtype, count * ncomp, offset).reshape(
            count, ncomp)
    return np.array(arr)  # writable copy


def load_gltf_bytes(data: bytes, base_dir: str = ".") -> List[Mesh]:
    """Parse .glb or .gltf bytes -> list of Mesh (one per primitive)."""
    if data[:4] == b"glTF":  # GLB container
        _, _, _ = struct.unpack("<III", data[:12])
        pos = 12
        doc = None
        bin_chunk = None
        while pos < len(data):
            clen, ctype = struct.unpack("<II", data[pos:pos + 8])
            chunk = data[pos + 8: pos + 8 + clen]
            if ctype == 0x4E4F534A:        # 'JSON'
                doc = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:      # 'BIN'
                bin_chunk = chunk
            pos += 8 + clen
        assert doc is not None, "GLB without JSON chunk"
    else:
        doc = json.loads(data.decode("utf-8"))
        bin_chunk = None

    buffers = _read_buffers(doc, bin_chunk, base_dir)
    meshes: List[Mesh] = []
    for m in doc.get("meshes", []):
        for prim in m.get("primitives", []):
            attrs = prim["attributes"]
            pos = _accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            n = pos.shape[0]
            if "NORMAL" in attrs:
                nrm = _accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
            else:
                nrm = np.tile(np.array([0, 1, 0], np.float32), (n, 1))
            if "TEXCOORD_0" in attrs:
                uv = _accessor(doc, buffers, attrs["TEXCOORD_0"])
                if uv.dtype != np.float32:  # normalized integer UVs
                    uv = uv.astype(np.float32) / np.iinfo(uv.dtype).max
            else:
                uv = np.zeros((n, 2), np.float32)
            if "indices" in prim:
                idx = _accessor(doc, buffers, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(n, dtype=np.uint32)
            idx = idx.astype(np.int32).reshape(-1, 3)
            meshes.append(Mesh(pos, nrm, uv[:, :2].astype(np.float32), idx))
    return meshes


def load_gltf(path: str) -> List[Mesh]:
    with open(path, "rb") as f:
        data = f.read()
    return load_gltf_bytes(data, os.path.dirname(path))
