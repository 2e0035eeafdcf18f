"""Async resource pipeline: background loads with completion queues.

Rebuild of ResourceSystem (include/garden/system/resource.hpp:77,119-199,
source/system/resource.cpp): loads run on a background pool; results queue
under a lock and are drained on the engine tick (the reference dequeues
pipelines/buffers/images on the Input event and fires "ImageLoaded"/
"BufferLoaded" events). Shared-resource dedup keys by content path hash
(resource.hpp:164-168); a registered pack archive serves reads in "release"
mode while loose files serve "debug" mode (resource.hpp:183-189); the
FileWatcherSystem can hot-reload a resource by re-queuing its loader
(resource.hpp:203 fileChange).

Decode is host work (PIL/parsers); device upload happens on the consumer
side (SceneBuffers.add_texture / add_instance) at drain time, so the frame
never blocks on IO. A copy of `garden_tpu.assets.resources`; models decode
to the port's `render.mesh.Mesh`.
"""

from __future__ import annotations

import hashlib
import io
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

IMAGE = "image"
MODEL = "model"
BYTES = "bytes"
ANIMATION = "animation"


@dataclass
class Handle:
    """Async load handle (the Ref<Image>/Ref<Buffer> analog)."""

    uid: int
    kind: str
    path: str
    ready: bool = False
    error: Optional[str] = None
    value: Any = None


class ResourceSystem:
    """Background loader with a drain-on-tick completion queue."""

    def __init__(self, workers: int = 4, root: str = "."):
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="res-bg")
        self._queue: "queue.Queue[Tuple[Handle, Any, Optional[str]]]" = queue.Queue()
        self._dedup: Dict[bytes, Handle] = {}
        self._handles: Dict[int, Handle] = {}
        self._listeners: Dict[str, List[Callable[[Handle], None]]] = {}
        self._next_uid = 0
        self._lock = threading.Lock()
        self.root = root
        self._pack = None  # release-mode archive (pack::Reader analog)

    # -- configuration -----------------------------------------------------

    def use_pack(self, path: str) -> None:
        """Serve reads from a pack archive (release builds,
        resource.hpp:183-189)."""
        from garden_tpu_torch.assets.pack import PackReader
        self._pack = PackReader(path)

    def on_loaded(self, kind: str, fn: Callable[[Handle], None]) -> None:
        """Subscribe to completion events ("ImageLoaded"/"BufferLoaded",
        resource.hpp:75)."""
        self._listeners.setdefault(kind, []).append(fn)

    # -- async loads ---------------------------------------------------------

    def load_image_async(self, path: str, linearize: bool = True) -> Handle:
        return self._submit(IMAGE, path, lambda data: self._decode_image(
            data, path, linearize))

    def load_model_async(self, path: str) -> Handle:
        return self._submit(MODEL, path, lambda data: self._decode_model(
            data, path))

    def load_bytes_async(self, path: str) -> Handle:
        return self._submit(BYTES, path, lambda data: data)

    def load_animation_async(self, path: str) -> Handle:
        import json

        def decode(data: bytes):
            return json.loads(data.decode("utf-8"))
        return self._submit(ANIMATION, path, decode)

    def _submit(self, kind: str, path: str,
                decode: Callable[[bytes], Any]) -> Handle:
        key = hashlib.blake2b(f"{kind}:{path}".encode(),
                              digest_size=16).digest()
        with self._lock:
            if key in self._dedup:
                return self._dedup[key]
            h = Handle(uid=self._next_uid, kind=kind, path=path)
            self._next_uid += 1
            self._dedup[key] = h
            self._handles[h.uid] = h

        def work():
            try:
                data = self._read(path)
                value = decode(data)
                self._queue.put((h, value, None))
            except Exception as e:  # queue the failure, don't kill the pool
                self._queue.put((h, None, f"{type(e).__name__}: {e}"))

        self._pool.submit(work)
        return h

    def _read(self, path: str) -> bytes:
        if self._pack is not None:
            try:
                return self._pack.read(path)
            except KeyError:
                pass  # fall through to loose files (debug assets)
        full = path if os.path.isabs(path) else os.path.join(self.root, path)
        with open(full, "rb") as f:
            return f.read()

    @staticmethod
    def _decode_image(data: bytes, path: str, linearize: bool):
        from garden_tpu_torch.assets import images
        ext = os.path.splitext(path)[1].lower()
        if ext == ".hdr":
            import tempfile
            with tempfile.NamedTemporaryFile(suffix=".hdr", delete=False) as f:
                f.write(data)
                tmp = f.name
            try:
                return images.load_hdr(tmp)
            finally:
                os.unlink(tmp)
        from PIL import Image
        img = Image.open(io.BytesIO(data)).convert("RGBA")
        arr = np.asarray(img, np.float32) / 255.0
        if linearize:
            rgb = images.srgb_to_linear(arr[..., :3])
            arr = np.concatenate([rgb, arr[..., 3:4]], axis=-1)
        return arr

    @staticmethod
    def _decode_model(data: bytes, path: str):
        ext = os.path.splitext(path)[1].lower()
        if ext in (".gltf", ".glb"):
            from garden_tpu_torch.assets.gltf import load_gltf_bytes
            return load_gltf_bytes(data, os.path.dirname(path))
        from garden_tpu_torch.assets.model import load_obj
        return load_obj(data.decode("utf-8"), from_string=True)

    # -- drain (the render-thread Input-event dequeue) -----------------------

    def drain(self, max_items: int = 64) -> List[Handle]:
        """Pop completed loads; fires per-kind listeners. Call once per tick
        (the dequeuePipelines/Buffers/Images analog, resource.hpp:119-199)."""
        done: List[Handle] = []
        for _ in range(max_items):
            try:
                h, value, err = self._queue.get_nowait()
            except queue.Empty:
                break
            h.value = value
            h.error = err
            h.ready = err is None
            done.append(h)
            for fn in self._listeners.get(h.kind, []):
                fn(h)
        return done

    def wait_all(self, timeout: float = 30.0) -> List[Handle]:
        """Block until every submitted load completed (offline/baking use)."""
        import time
        done: List[Handle] = []
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            done += self.drain()
            with self._lock:
                pending = sum(1 for h in self._handles.values()
                              if not h.ready and h.error is None)
            if pending == 0:
                return done
            time.sleep(0.005)
        raise TimeoutError("resource loads did not complete")

    def reload(self, path: str) -> List[Handle]:
        """Hot reload: re-queue every resource loaded from `path`
        (FileWatcherSystem fileChange -> ResourceSystem, resource.hpp:203)."""
        out = []
        with self._lock:
            hs = [h for h in self._handles.values() if h.path == path]
        for h in hs:
            decode = {
                IMAGE: lambda d, p=h.path: self._decode_image(d, p, True),
                MODEL: lambda d, p=h.path: self._decode_model(d, p),
                BYTES: lambda d: d,
                ANIMATION: lambda d: __import__("json").loads(d.decode()),
            }[h.kind]

            def work(h=h, decode=decode):
                try:
                    data = self._read(h.path)
                    self._queue.put((h, decode(data), None))
                except Exception as e:
                    self._queue.put((h, None, f"{type(e).__name__}: {e}"))

            h.ready = False
            self._pool.submit(work)
            out.append(h)
        return out

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
