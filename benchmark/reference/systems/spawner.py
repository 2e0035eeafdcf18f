"""Spawner system: prefab instantiation.

Rebuild of SpawnerSystem (include/garden/system/spawner.hpp:122,
source/system/spawner.cpp): spawn prefabs (scene fragments or registered
factories) at an entity's transform, with spawn modes (OneShot / Manual),
delay and maxCount. Entity creation is host-side by nature (it changes the
alive set), so spawners process between ticks — the analog of the
reference running spawners inside Update on the render thread.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from benchmark.reference.core.ecs import ComponentDef, Field, System, World


MODE_ONE_SHOT = 0
MODE_MANUAL = 1

SPAWNER = ComponentDef(
    "spawner",
    {
        "mode": Field((), np.int32, MODE_ONE_SHOT),
        "delay": Field((), np.float32, 0.0),
        "max_count": Field((), np.int32, 1),
        "spawned_count": Field((), np.int32, 0),
        "elapsed": Field((), np.float32, 0.0),
        "is_active": Field((), np.bool_, True),
    },
)

PrefabFn = Callable[[World, int], int]  # (world, spawner_entity) -> new entity


class SpawnerSystem(System):
    component = SPAWNER

    def __init__(self) -> None:
        self._prefabs: Dict[str, PrefabFn] = {}
        self._spawner_prefab: Dict[int, str] = {}
        self._spawned: Dict[int, List[int]] = {}

    def register_prefab(self, name: str, factory: PrefabFn) -> None:
        """Register a prefab factory (the scene-path / prefab-UUID analog of
        spawner.hpp's path+prefab fields)."""
        self._prefabs[name] = factory

    def add_spawner(self, entity: int, prefab: str, mode: int = MODE_ONE_SHOT,
                    delay: float = 0.0, max_count: int = 1) -> None:
        self.world.add_component(entity, "spawner", mode=mode, delay=delay,
                                 max_count=max_count)
        self._spawner_prefab[entity] = prefab

    def spawn(self, entity: int) -> Optional[int]:
        """Manually spawn one instance from a spawner entity."""
        prefab = self._spawner_prefab.get(entity)
        if prefab is None or prefab not in self._prefabs:
            return None
        child = self._prefabs[prefab](self.world, entity)
        self._spawned.setdefault(entity, []).append(child)
        store = self.world._stores["spawner"]
        store["spawned_count"][entity] += 1
        return child

    def spawned_of(self, entity: int) -> List[int]:
        return list(self._spawned.get(entity, []))

    def process(self, delta_time: float) -> List[int]:
        """Host-side tick: run one-shot spawns whose delay elapsed.

        Call between ticks (entity creation mutates the alive set)."""
        created: List[int] = []
        store = self.world._stores.get("spawner")
        if store is None:
            return created
        for e in range(self.world.capacity):
            if not (self.world._alive[e] and store["has"][e]):
                continue
            if not store["is_active"][e]:
                continue
            if int(store["mode"][e]) != MODE_ONE_SHOT:
                continue
            store["elapsed"][e] += delta_time
            if store["elapsed"][e] < store["delay"][e]:
                continue
            if int(store["spawned_count"][e]) >= int(store["max_count"][e]):
                continue
            child = self.spawn(e)
            if child is not None:
                created.append(child)
        return created
