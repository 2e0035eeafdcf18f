"""PhysicsSystem: the ECS bridge to the physics world.

Port of `garden_tpu.systems.physics`: rigidbodies are ECS components
referencing slots in the physics body arrays; each tick the system runs the
fixed-rate accumulator (`world.simulate`) and writes the interpolated body
poses into the transform components of the movable bodies, one
`index_put` over those rows. On a card the accumulator's fixed-step loop
(`world.fixed_steps`) replays as one CUDA graph a tick
(`utils.cuda_graph.GraphedStep`; the first tick of a layout runs eagerly,
the second captures); the accumulator's arithmetic stays eager around it.
A replayed tick opens no physics stage span, but while a profiler records
its `graph_replay` span carries a record of each span of the capture: the
4 `fixed_step` spans and their stages, each naming its device ops.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from garden_tpu_torch.core.config import PhysicsConfig
from garden_tpu_torch.core.ecs import ComponentDef, Field, System, World
from garden_tpu_torch.physics import world as pw
from garden_tpu_torch.utils.cuda_graph import GraphedStep

RIGIDBODY = ComponentDef(
    "rigidbody",
    {
        "body": Field((), np.int32, -1),  # slot in the physics body arrays
    },
)


class PhysicsSystem(System):
    component = RIGIDBODY

    def __init__(self, config: Optional[PhysicsConfig] = None):
        self.config = config or PhysicsConfig()
        self.physics = pw.PhysicsWorld(self.config)
        # fixed_steps' arguments as one tree: the config, h, the step count
        # and the present shape types are leaves keyed by value, so a change
        # of any of them captures a graph of its own
        self.fixed_steps = GraphedStep(lambda args: pw.fixed_steps(*args))

    def attach(self, world: World) -> None:
        super().attach(world)
        world.events.subscribe("Update", self.update, priority=10.0)

    # -- host-side body creation -------------------------------------------

    def add_rigidbody(self, entity: int, shape: int, **kwargs) -> int:
        """Create a body for an entity, at its transform's pose unless the
        caller gives one."""
        tstore = self.world._stores.get("transform")
        if tstore is not None and tstore["has"][entity]:
            kwargs.setdefault("position", tstore["position"][entity])
            kwargs.setdefault("rotation", tstore["rotation"][entity])
        body = self.physics.add_body(shape, entity=entity, **kwargs)
        self.world.add_component(entity, "rigidbody", body=body)
        return body

    def device_state(self) -> Dict[str, Any]:
        return self.physics.device_state(self.world.device)

    # -- per-tick update (pure) ------------------------------------------------

    def update(self, state: Dict[str, Any], ctx: Dict[str, Any]) -> Dict[str, Any]:
        phys = pw.simulate(state["physics"], self.config, ctx["delta_time"],
                           present_types=self.physics.shapes.present_types(),
                           loop=lambda *args: self.fixed_steps(args))
        state = dict(state, physics=phys)
        if "transform" in state["components"]:
            state = self.sync_transforms(state)
        return state

    def sync_transforms(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Write interpolated body poses into the transform components of
        the movable bodies (alive, bound to an entity, not static); every
        other transform row keeps its value."""
        phys = state["physics"]
        pos, quat = pw.interpolated_pose(phys, self.config)
        bodies = phys["bodies"]
        tcomp = state["components"]["transform"]
        movable = bodies["has"] & (bodies["entity"] >= 0) & (bodies["motion"] != pw.STATIC)
        tcomp = dict(tcomp,
                     position=put_rows(tcomp["position"], bodies["entity"], movable, pos),
                     rotation=put_rows(tcomp["rotation"], bodies["entity"], movable, quat))
        return dict(state, components=dict(state["components"], transform=tcomp))


def put_rows(dst: torch.Tensor, index: torch.Tensor, keep: torch.Tensor,
             values: torch.Tensor) -> torch.Tensor:
    """A copy of dst with dst[index[i]] = values[i] wherever keep[i] (the
    reference's `.at[where(keep, index, len(dst))].set(values, mode="drop")`).
    The rows not kept go to a spare row past the end, cut off after the
    `index_put`, so no row count is read back from the device."""
    n = dst.shape[0]
    target = torch.where(keep, index, torch.full_like(index, n)).long()
    return torch.cat([dst, dst[:1]]).index_put((target,), values)[:n]
