"""Encoding and filesystem utilities.

Rebuild of the reference's base64/utf/file helpers (source/base64.cpp 604
LoC, utf.cpp 306 LoC, file.cpp 132 LoC + mpio path resolution). Python's
stdlib covers the mechanics; this module pins the reference's API surface
(URL-safe variant, UTF-16/32 round-trips, app-data/resource directory
resolution) so callers have a stable 1:1 home for it.
"""

from __future__ import annotations

import base64 as _b64
import os
from pathlib import Path
from typing import Union

Bytes = Union[bytes, bytearray, memoryview]


# -- base64 (base64.hpp) -------------------------------------------------------

def base64_encode(data: Bytes, url_safe: bool = False) -> str:
    enc = _b64.urlsafe_b64encode if url_safe else _b64.b64encode
    return enc(bytes(data)).decode("ascii")


def base64_decode(text: str, url_safe: bool = False) -> bytes:
    dec = _b64.urlsafe_b64decode if url_safe else _b64.b64decode
    pad = -len(text) % 4
    return dec(text + "=" * pad)


# -- UTF conversions (utf.hpp) -------------------------------------------------

def utf8_to_utf16(s: str) -> bytes:
    return s.encode("utf-16-le")


def utf16_to_utf8(b: Bytes) -> str:
    return bytes(b).decode("utf-16-le")


def utf8_to_utf32(s: str) -> bytes:
    return s.encode("utf-32-le")


def utf32_to_utf8(b: Bytes) -> str:
    return bytes(b).decode("utf-32-le")


def codepoint_count(s: str) -> int:
    """Number of Unicode code points (what the reference's utf helpers
    iterate for text layout)."""
    return len(s)


# -- file helpers (file.hpp + mpio directories) ---------------------------------

def read_bytes(path: Union[str, Path]) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def write_bytes(path: Union[str, Path], data: Bytes) -> None:
    ensure_dir(os.path.dirname(str(path)) or ".")
    with open(path, "wb") as f:
        f.write(bytes(data))


def read_text(path: Union[str, Path]) -> str:
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def write_text(path: Union[str, Path], text: str) -> None:
    ensure_dir(os.path.dirname(str(path)) or ".")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def ensure_dir(path: Union[str, Path]) -> None:
    os.makedirs(str(path), exist_ok=True)


def app_data_dir(app_name: str) -> str:
    """Per-user writable app directory (the mpio getDataDirectory analog the
    SettingsSystem persists into, settings.cpp:20-40)."""
    base = os.environ.get("XDG_DATA_HOME",
                          os.path.join(os.path.expanduser("~"),
                                       ".local", "share"))
    path = os.path.join(base, app_name)
    ensure_dir(path)
    return path


def app_cache_dir(app_name: str) -> str:
    """Per-user cache directory (compiled-pipeline cache home)."""
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    path = os.path.join(base, app_name)
    ensure_dir(path)
    return path
