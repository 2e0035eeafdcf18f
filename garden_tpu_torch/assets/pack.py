"""Pack archive bindings: native C++ reader/writer with a Python path.

A copy of `garden_tpu.assets.pack` (the cfnptr/pack integration:
ResourceSystem reads `pack::Reader` archives in release builds,
include/garden/system/resource.hpp:28-30, 183-189). The format is GPK1:
zlib-compressed items and an FNV-1a path index, the same in both packages,
so an archive written by either reads in the other.

Two paths serve it:
- native: `native/pack/pack.cpp` through ctypes. At first use it is
  compiled with `g++ -O2 -shared -fPIC ... -lz` into `_build/` beside this
  package (the file name carries a hash of the source and the flags). The
  reference's own library under `garden_tpu/assets/_native/` is never
  loaded.
- Python: the same format in pure Python, when there is no g++ or no
  `native/` source tree. A failed compile raises.

`native_available()` says which path runs; each `PackWriter` and
`PackReader` also records it in its `native` attribute. This is a host
file format, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_MAGIC = b"GPK1"
_SOURCE = Path(__file__).resolve().parents[2] / "native" / "pack" / "pack.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]
_UNSET = object()
_NATIVE = _UNSET       # the loaded library, None for the Python path
_lock = threading.Lock()


def _fnv1a(name: bytes) -> int:
    h = 1469598103934665603
    for b in name:
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgardenpack-{digest}.so"


def _build() -> Optional[Path]:
    """Compile pack.cpp unless built; None without g++ or the source."""
    gxx = shutil.which("g++")
    if gxx is None or not _SOURCE.exists():
        return None
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([gxx, *GXX_FLAGS, str(_SOURCE), "-lz", "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {_SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.gpk_writer_create.restype = ctypes.c_void_p
    lib.gpk_writer_create.argtypes = [ctypes.c_char_p]
    lib.gpk_writer_add.restype = ctypes.c_int
    lib.gpk_writer_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_uint64]
    lib.gpk_writer_finish.restype = ctypes.c_int
    lib.gpk_writer_finish.argtypes = [ctypes.c_void_p]
    lib.gpk_reader_open.restype = ctypes.c_void_p
    lib.gpk_reader_open.argtypes = [ctypes.c_char_p]
    lib.gpk_reader_count.restype = ctypes.c_uint32
    lib.gpk_reader_count.argtypes = [ctypes.c_void_p]
    lib.gpk_reader_find.restype = ctypes.c_int
    lib.gpk_reader_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.gpk_reader_item_size.restype = ctypes.c_uint64
    lib.gpk_reader_item_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gpk_reader_item_name.restype = ctypes.c_int
    lib.gpk_reader_item_name.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_char_p, ctypes.c_uint32]
    lib.gpk_reader_read.restype = ctypes.c_int
    lib.gpk_reader_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_char_p]
    lib.gpk_reader_close.argtypes = [ctypes.c_void_p]
    return lib


def _native():
    """The native library, built and loaded on first use; None when the
    Python path serves."""
    global _NATIVE
    with _lock:
        if _NATIVE is _UNSET:
            path = _build()
            _NATIVE = None if path is None else _load(path)
        return _NATIVE


def native_available() -> bool:
    return _native() is not None


class PackWriter:
    def __init__(self, path: str):
        self.path = path
        self._lib = _native()
        self.native = self._lib is not None
        if self._lib:
            self._w = self._lib.gpk_writer_create(path.encode())
            if not self._w:
                raise IOError(f"cannot create {path}")
            self._items = None
        else:
            self._w = None
            self._items: List[Tuple[bytes, bytes]] = []

    def add(self, name: str, data: bytes) -> None:
        if self._w:
            rc = self._lib.gpk_writer_add(self._w, name.encode(), data, len(data))
            if rc < 0:
                raise IOError(f"pack add failed: {rc}")
        else:
            self._items.append((name.encode(), data))

    def add_file(self, name: str, path: str) -> None:
        with open(path, "rb") as f:
            self.add(name, f.read())

    def finish(self) -> None:
        if self._w:
            rc = self._lib.gpk_writer_finish(self._w)
            self._w = None
            if rc < 0:
                # e.g. index write hit a full disk: the archive is truncated
                raise IOError(f"pack finish failed: {rc}")
            return
        # the Python path: identical format
        with open(self.path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<I", len(self._items)))
            index_pos = f.tell()
            f.write(struct.pack("<Q", 0))
            index = []
            for name, data in self._items:
                comp = zlib.compress(data, 6) if len(data) > 64 else data
                compressed = 1 if len(data) > 64 and len(comp) < len(data) else 0
                stored = comp if compressed else data
                offset = f.tell()
                f.write(stored)
                index.append((name, offset, len(stored), len(data), compressed))
            index_offset = f.tell()
            for name, offset, stored, raw, compressed in index:
                f.write(struct.pack("<Q", _fnv1a(name)))
                f.write(struct.pack("<I", len(name)))
                f.write(name)
                f.write(struct.pack("<QQQB", offset, stored, raw, compressed))
            f.seek(index_pos)
            f.write(struct.pack("<Q", index_offset))


class PackReader:
    def __init__(self, path: str):
        self.path = path
        self._lib = _native()
        self.native = self._lib is not None
        if self._lib:
            self._r = self._lib.gpk_reader_open(path.encode())
            if not self._r:
                raise IOError(f"cannot open {path}")
            self._index = None
        else:
            self._r = None
            self._index: Dict[str, Tuple[int, int, int, int]] = {}
            with open(path, "rb") as f:
                if f.read(4) != _MAGIC:
                    raise IOError("bad magic")
                (count,) = struct.unpack("<I", f.read(4))
                (index_offset,) = struct.unpack("<Q", f.read(8))
                f.seek(index_offset)
                for _ in range(count):
                    f.read(8)  # hash
                    (n,) = struct.unpack("<I", f.read(4))
                    name = f.read(n).decode()
                    offset, stored, raw, compressed = struct.unpack(
                        "<QQQB", f.read(25))
                    self._index[name] = (offset, stored, raw, compressed)

    def names(self) -> List[str]:
        if self._r:
            out = []
            buf = ctypes.create_string_buffer(4096)
            for i in range(self._lib.gpk_reader_count(self._r)):
                if self._lib.gpk_reader_item_name(self._r, i, buf, 4096) >= 0:
                    out.append(buf.value.decode())
            return out
        return list(self._index.keys())

    def read(self, name: str) -> bytes:
        if self._r:
            idx = self._lib.gpk_reader_find(self._r, name.encode())
            if idx < 0:
                raise KeyError(name)
            size = self._lib.gpk_reader_item_size(self._r, idx)
            buf = ctypes.create_string_buffer(int(size))
            rc = self._lib.gpk_reader_read(self._r, idx, buf)
            if rc != 0:
                raise IOError(f"pack read failed: {rc}")
            return buf.raw
        if name not in self._index:
            raise KeyError(name)
        offset, stored, raw, compressed = self._index[name]
        with open(self.path, "rb") as f:
            f.seek(offset)
            data = f.read(stored)
        return zlib.decompress(data) if compressed else data

    def close(self) -> None:
        if self._r:
            self._lib.gpk_reader_close(self._r)
            self._r = None
