"""Link system: UUID + tag registry for entity lookup.

Rebuild of LinkSystem (include/garden/system/link.hpp:74): entities get a
128-bit UUID (Hash128 in the reference) and/or a string tag; scenes and
networking resolve cross-references through this registry. Host-side only —
links are identity metadata, not frame-path state.
"""

from __future__ import annotations

import secrets
from typing import Dict, List, Optional

from benchmark.reference.core.ecs import System


class LinkSystem(System):
    def __init__(self) -> None:
        self._uuid_to_entity: Dict[str, int] = {}
        self._entity_to_uuid: Dict[int, str] = {}
        self._tags: Dict[str, List[int]] = {}
        self._entity_tag: Dict[int, str] = {}

    def add_link(self, entity: int, uuid: Optional[str] = None,
                 tag: Optional[str] = None) -> str:
        if uuid is None:
            uuid = secrets.token_hex(16)
        if uuid in self._uuid_to_entity and self._uuid_to_entity[uuid] != entity:
            raise ValueError(f"uuid collision: {uuid}")
        self._uuid_to_entity[uuid] = entity
        self._entity_to_uuid[entity] = uuid
        if tag:
            self.set_tag(entity, tag)
        return uuid

    def set_tag(self, entity: int, tag: str) -> None:
        old = self._entity_tag.get(entity)
        if old:
            self._tags[old].remove(entity)
        self._entity_tag[entity] = tag
        self._tags.setdefault(tag, []).append(entity)

    def find_by_uuid(self, uuid: str) -> Optional[int]:
        return self._uuid_to_entity.get(uuid)

    def find_by_tag(self, tag: str) -> List[int]:
        return list(self._tags.get(tag, []))

    def uuid_of(self, entity: int) -> Optional[str]:
        return self._entity_to_uuid.get(entity)

    def remove(self, entity: int) -> None:
        uuid = self._entity_to_uuid.pop(entity, None)
        if uuid:
            self._uuid_to_entity.pop(uuid, None)
        tag = self._entity_tag.pop(entity, None)
        if tag:
            self._tags[tag].remove(entity)
