"""Small core systems: locale, app info, file watching.

Rebuilds of LocaleSystem (include/garden/system/locale.hpp:101: string
translation maps per module), AppInfoSystem (app-info.hpp:33: app identity +
resource/cache dirs, from CMake vars in the reference), and
FileWatcherSystem (file-watcher.hpp:34: inotify-based resource watching
driving hot reload via ResourceSystem::fileChange) — here a portable
mtime-polling watcher with change callbacks.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

from garden_tpu_torch.core.ecs import System


class LocaleSystem(System):
    """String translation maps (locale.hpp:101)."""

    def __init__(self, locale: str = "en"):
        self.locale = locale
        self._strings: Dict[str, Dict[str, str]] = {}

    def load_locale(self, locale: str, strings: Dict[str, str]) -> None:
        self._strings.setdefault(locale, {}).update(strings)

    def load_locale_file(self, locale: str, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            self.load_locale(locale, json.load(f))

    def set_locale(self, locale: str) -> None:
        self.locale = locale

    def get(self, key: str, default: Optional[str] = None) -> str:
        table = self._strings.get(self.locale, {})
        if key in table:
            return table[key]
        if default is not None:
            return default
        return key


@dataclasses.dataclass
class AppInfo:
    name: str = "garden-tpu-app"
    version: str = "0.1.0"
    description: str = ""
    resources_path: str = "resources"
    cache_path: str = ".cache"
    data_path: str = ".app-data"


class AppInfoSystem(System):
    """App identity + well-known directories (app-info.hpp:33)."""

    def __init__(self, info: Optional[AppInfo] = None):
        self.info = info or AppInfo()

    def resource_path(self, rel: str) -> str:
        return os.path.join(self.info.resources_path, rel)

    def cache_path(self, rel: str) -> str:
        os.makedirs(self.info.cache_path, exist_ok=True)
        return os.path.join(self.info.cache_path, rel)


class FileWatcherSystem(System):
    """Polling file watcher with change callbacks (hot-reload driver,
    file-watcher.hpp:34 / resource.hpp:203 fileChange)."""

    def __init__(self) -> None:
        self._watched: Dict[str, float] = {}
        self._callbacks: List[Callable[[str], None]] = []

    def watch(self, path: str) -> None:
        try:
            self._watched[path] = os.path.getmtime(path)
        except OSError:
            self._watched[path] = 0.0

    def watch_tree(self, root: str, exts: Optional[tuple] = None) -> int:
        count = 0
        for dirpath, _dirs, files in os.walk(root):
            for f in files:
                if exts and not f.endswith(exts):
                    continue
                self.watch(os.path.join(dirpath, f))
                count += 1
        return count

    def on_change(self, fn: Callable[[str], None]) -> None:
        self._callbacks.append(fn)

    def poll(self) -> List[str]:
        """Check mtimes; fire callbacks; returns changed paths."""
        changed = []
        for path, old in list(self._watched.items()):
            try:
                now = os.path.getmtime(path)
            except OSError:
                continue
            if now != old:
                self._watched[path] = now
                changed.append(path)
                for cb in self._callbacks:
                    cb(path)
        return changed
