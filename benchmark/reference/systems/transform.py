"""Transform hierarchy: position/rotation/scale with parent links.

Port of `garden_tpu.systems.transform`. The hierarchy lives in SoA arrays
and the bake is one vectorized pointer-jumping pass:

    world[i] = world[parent[i]] @ world[i];  parent[i] = parent[parent[i]]

which resolves any tree of depth <= 2^K in K iterations. Marker components
(DoNotDestroy/DoNotDuplicate/DoNotSerialize) are boolean fields on the
transform store.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.core import math3d as m3
from benchmark.reference.core.ecs import ComponentDef, Field, System

Tensor = torch.Tensor

# Maximum supported hierarchy depth = 2**JUMP_ITERS.
JUMP_ITERS = 5  # depth 32

TRANSFORM = ComponentDef(
    "transform",
    {
        "position": Field((3,), np.float32, 0.0),
        "rotation": Field((4,), np.float32, (0.0, 0.0, 0.0, 1.0)),
        "scale": Field((3,), np.float32, 1.0),
        "parent": Field((), np.int32, -1),
        "active": Field((), np.bool_, True),
        "static": Field((), np.bool_, False),
        # marker flags
        "do_not_destroy": Field((), np.bool_, False),
        "do_not_duplicate": Field((), np.bool_, False),
        "do_not_serialize": Field((), np.bool_, False),
    },
)


def bake_world_matrices(store: Dict[str, Tensor]) -> Tensor:
    """Compose local TRS with ancestors -> (N, 4, 4) world matrices by
    log-depth pointer jumping. Each gather reads the clamped index `safe`,
    as the reference does, and a root's row takes the identity."""
    local = m3.compose_trs(store["position"], store["rotation"], store["scale"])
    eye = torch.eye(4, dtype=local.dtype, device=local.device)
    world = torch.where(store["has"][:, None, None], local, eye)
    none = torch.full_like(store["parent"], -1)
    parent = torch.where(store["has"], store["parent"], none)
    for _ in range(JUMP_ITERS):
        has_parent = parent >= 0
        safe = torch.clamp(parent, min=0).long()
        parent_mat = torch.where(has_parent[:, None, None], world[safe], eye)
        world = m3.matmul(parent_mat, world)
        parent = torch.where(has_parent, parent[safe], none)
    return world


def bake_world_active(store: Dict[str, Tensor]) -> Tensor:
    """Cascade active flags down the tree -> bool[N]."""
    active = store["active"] & store["has"]
    none = torch.full_like(store["parent"], -1)
    parent = torch.where(store["has"], store["parent"], none)
    for _ in range(JUMP_ITERS):
        has_parent = parent >= 0
        safe = torch.clamp(parent, min=0).long()
        active = active & torch.where(has_parent, active[safe], True)
        parent = torch.where(has_parent, parent[safe], none)
    return active


def world_positions(world_mats: Tensor) -> Tensor:
    return world_mats[..., :3, 3]


class TransformSystem(System):
    component = TRANSFORM

    # Host-side convenience used by scene code.
    def set_parent(self, entity: int, parent: int) -> None:
        self.world.set_component(entity, "transform", parent=parent)
