"""Minimal BSON codec + json2bson conversion.

Rebuild of the reference's BSON path: scenes serialize to JSON in debug and
pack to BSON for shipping via the json2bson tool (source/json2bson.cpp:196;
JsonDeserializer's BSON load at include/garden/json-serialize.hpp:92-108).
Implements the BSON subset those scenes use: documents, arrays, strings,
doubles, int32/int64, booleans, null.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Tuple


def _encode_element(name: str, value: Any) -> bytes:
    key = name.encode("utf-8") + b"\x00"
    if isinstance(value, bool):
        return b"\x08" + key + (b"\x01" if value else b"\x00")
    if isinstance(value, int):
        if -(2 ** 31) <= value < 2 ** 31:
            return b"\x10" + key + struct.pack("<i", value)
        return b"\x12" + key + struct.pack("<q", value)
    if isinstance(value, float):
        return b"\x01" + key + struct.pack("<d", value)
    if isinstance(value, str):
        data = value.encode("utf-8") + b"\x00"
        return b"\x02" + key + struct.pack("<i", len(data)) + data
    if value is None:
        return b"\x0a" + key
    if isinstance(value, dict):
        return b"\x03" + key + dumps(value)
    if isinstance(value, (list, tuple)):
        doc = {str(i): v for i, v in enumerate(value)}
        return b"\x04" + key + dumps(doc)
    raise TypeError(f"unsupported BSON type: {type(value)}")


def dumps(doc: dict) -> bytes:
    body = b"".join(_encode_element(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _decode_element(data: bytes, off: int) -> Tuple[str, Any, int]:
    etype = data[off]
    off += 1
    end = data.index(b"\x00", off)
    name = data[off:end].decode("utf-8")
    off = end + 1
    if etype == 0x08:
        return name, data[off] == 1, off + 1
    if etype == 0x10:
        return name, struct.unpack_from("<i", data, off)[0], off + 4
    if etype == 0x12:
        return name, struct.unpack_from("<q", data, off)[0], off + 8
    if etype == 0x01:
        return name, struct.unpack_from("<d", data, off)[0], off + 8
    if etype == 0x02:
        (n,) = struct.unpack_from("<i", data, off)
        s = data[off + 4:off + 4 + n - 1].decode("utf-8")
        return name, s, off + 4 + n
    if etype == 0x0A:
        return name, None, off
    if etype in (0x03, 0x04):
        (n,) = struct.unpack_from("<i", data, off)
        sub = _loads(data[off:off + n])
        if etype == 0x04:
            sub = [sub[str(i)] for i in range(len(sub))]
        return name, sub, off + n
    raise ValueError(f"unsupported BSON element type 0x{etype:02x}")


def _loads(data: bytes) -> dict:
    (total,) = struct.unpack_from("<i", data, 0)
    off = 4
    out = {}
    while off < total - 1:
        name, value, off = _decode_element(data, off)
        out[name] = value
    return out


def loads(data: bytes) -> dict:
    return _loads(data)


def json2bson(json_path: str, bson_path: str) -> None:
    """The json2bson CLI behavior (scene shipping format)."""
    with open(json_path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    with open(bson_path, "wb") as f:
        f.write(dumps(doc))


def bson2json(bson_path: str, json_path: str) -> None:
    with open(bson_path, "rb") as f:
        doc = loads(f.read())
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
