"""User-persistent typed key/value settings.

Replaces SettingsSystem (reference: include/garden/system/settings.hpp:35,
source/system/settings.cpp:20-40): a typed Int/Float/Bool/String/Color store
persisted as JSON in an app-data directory; systems pull values at init
(e.g. render.useVsync at graphics.cpp:148-155, csm.shadowMapSize at
csm.cpp:183).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


class Settings:
    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._data: Dict[str, Any] = {}
        if path and os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                self._data = json.load(f)

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self._data.get(key, default))

    def get_float(self, key: str, default: float = 0.0) -> float:
        return float(self._data.get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        return bool(self._data.get(key, default))

    def get_string(self, key: str, default: str = "") -> str:
        return str(self._data.get(key, default))

    def get_color(self, key: str, default=(1.0, 1.0, 1.0, 1.0)):
        v = self._data.get(key, default)
        return tuple(float(c) for c in v)

    def set(self, key: str, value: Any) -> None:
        if isinstance(value, tuple):
            value = list(value)
        self._data[key] = value

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path:
            raise ValueError("no settings path")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self._data, f, indent=2, sort_keys=True)
