"""Character controller.

Port of `garden_tpu.systems.character`. The character is a capsule
rigidbody with locked rotation (angular_factor = 0) driven by velocity
control; the ground state comes from the body's contact normals each step
(grounded = any supporting contact whose normal is within max_slope of up).

Two swept-shape behaviours use sphere casts (physics/queries.cast_sphere),
all characters in one batched cast per probe. The casts run over the rows
of the stepped state that hold an active character (one small read-back of
their indices per update), not over the whole entity capacity: a cast is
(characters x bodies) pairs, and the rest of the rows cannot climb or stick
(they are inactive).
- walk-stairs: when grounded, moving, and blocked at foot level but clear at
  step height, the body is lifted by step_height so the solver lands it on
  the step.
- stick-to-floor: when recently grounded, not jumping, and the ground is
  within stick_distance below the foot, downward velocity is added to close
  the gap within one step.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from benchmark.reference.core import math3d as m3
from benchmark.reference.core.ecs import ComponentDef, Field, System
from benchmark.reference.physics import queries as pq
from benchmark.reference.systems.physics import put_rows

CHARACTER = ComponentDef(
    "character",
    {
        "body": Field((), np.int32, -1),
        "desired_vel": Field((3,), np.float32, 0.0),
        "jump_impulse": Field((), np.float32, 0.0),
        "grounded": Field((), np.bool_, False),
        "max_slope_cos": Field((), np.float32, 0.7071),  # 45 degrees
        "control_accel": Field((), np.float32, 30.0),
        # capsule dimensions (cached for the cast probes)
        "radius": Field((), np.float32, 0.3),
        "half_height": Field((), np.float32, 0.6),
        "step_height": Field((), np.float32, 0.4),     # walk-stairs
        "stick_distance": Field((), np.float32, 0.3),  # stick-to-floor
    },
)


class CharacterSystem(System):
    component = CHARACTER

    def attach(self, world) -> None:
        super().attach(world)
        # runs just before PhysicsSystem (priority 10) applies simulate
        world.events.subscribe("Update", self.update, priority=9.0)

    def add_character(self, entity: int, radius: float = 0.3,
                      half_height: float = 0.6, mass: float = 70.0,
                      step_height: float = 0.4,
                      stick_distance: float = 0.3) -> int:
        phys = self.world.systems["PhysicsSystem"]
        shape = phys.physics.shapes.capsule(radius, half_height)
        body = phys.add_rigidbody(
            entity, shape, friction=0.2, mass_override=mass,
            angular_factor=(0.0, 0.0, 0.0),  # upright lock
        )
        self.world.add_component(entity, "character", body=body,
                                 radius=radius, half_height=half_height,
                                 step_height=step_height,
                                 stick_distance=stick_distance)
        return body

    def update(self, state: Dict[str, Any], ctx: Dict[str, Any]) -> Dict[str, Any]:
        comp = state["components"].get("character")
        if comp is None:
            return state
        phys = state["physics"]
        bodies = phys["bodies"]
        dt = ctx["delta_time"]

        body = torch.clamp(comp["body"], min=0).long()
        active = comp["has"] & (comp["body"] >= 0)

        # ground state computed by the physics step from contact normals
        grounded = phys["grounded"][body] & active

        # velocity control: steer horizontal velocity toward desired
        linvel = bodies["linvel"]
        v = linvel[body]
        desired = comp["desired_vel"]
        accel = comp["control_accel"] * dt
        dvx = torch.clamp(desired[:, 0] - v[:, 0], -accel, accel)
        dvz = torch.clamp(desired[:, 2] - v[:, 2], -accel, accel)
        zero = torch.zeros_like(accel)
        jump = torch.where(grounded & (comp["jump_impulse"] > 0.0), comp["jump_impulse"],
                           zero)
        new_v = v + torch.stack([dvx, jump, dvz], dim=-1) * torch.where(
            active[:, None], 1.0, 0.0)

        # -- walk-stairs ----------------------------------------------------
        # blocked at foot level but clear at step height -> lift the body by
        # step_height; the contact solve provides the forward+down motion
        pos = bodies["pos"]
        p = pos[body]
        speed = torch.sqrt(desired[:, 0] ** 2 + desired[:, 2] ** 2)
        moving = speed > 0.05
        dirn = torch.stack([desired[:, 0], torch.zeros_like(speed), desired[:, 2]],
                           -1) / torch.clamp(speed, min=1e-6)[:, None]
        # actual progress along the desired direction is far below desired
        v_along = v[:, 0] * dirn[:, 0] + v[:, 2] * dirn[:, 2]
        blocked = grounded & moving & (v_along < 0.5 * speed)
        foot = p - torch.stack([torch.zeros_like(speed), comp["half_height"],
                                torch.zeros_like(speed)], -1)
        probe_dist = comp["radius"] + torch.clamp(speed, min=1.0) * dt * 2.0
        probe_r = comp["radius"] * 0.9

        up = m3.constant((0.0, 1.0, 0.0), p.device)
        rows = torch.nonzero(active).squeeze(-1)

        def probe(origin, direction, distance):
            hit = pq.cast_sphere(phys, origin[rows], direction[rows], probe_r[rows],
                                 distance[rows], comp["body"][rows])
            return (torch.zeros_like(active).index_put((rows,), hit.hit),
                    zero.index_put((rows,), hit.distance))

        low_hit, _ = probe(foot, dirn, probe_dist)
        high_hit, _ = probe(foot + up * comp["step_height"][:, None], dirn, probe_dist)
        climb = active & blocked & low_hit & ~high_hit
        lift = torch.where(climb, comp["step_height"], zero)

        # -- stick-to-floor -------------------------------------------------
        # recently grounded, not rising: if the floor is within
        # stick_distance below the foot, add downward velocity to reach it
        falling = active & comp["grounded"] & ~grounded & (new_v[:, 1] <= 0.0)
        down_hit, down_d = probe(foot, (-up).expand(foot.shape),
                                 comp["stick_distance"] + comp["radius"])
        stick = falling & down_hit
        # a tensor divisor: CUDA divides by a host scalar as a multiply by
        # its reciprocal, which rounds differently
        stick_v = torch.where(stick, -down_d / torch.full_like(zero, max(dt, 1e-4)), zero)
        stick_v = torch.clamp(stick_v, min=-3.0)  # bounded snap speed
        new_v = _add_y(new_v, torch.where(stick, stick_v, zero))

        lifted = _add_y(p, lift)
        linvel = put_rows(linvel, body, active, new_v)
        pos = put_rows(pos, body, active, lifted)
        # sync the per-character slope limit into the body's ground
        # threshold so serialized max_slope_cos values take effect
        ground_cos = put_rows(bodies["ground_cos"], body, active, comp["max_slope_cos"])

        bodies = dict(bodies, linvel=linvel, pos=pos, ground_cos=ground_cos)
        comp = dict(comp, grounded=grounded,
                    jump_impulse=torch.where(grounded, zero, comp["jump_impulse"]))
        return dict(
            state,
            physics=dict(phys, bodies=bodies),
            components=dict(state["components"], character=comp),
        )


def _add_y(v: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """v with dy added to its y column only (x and z keep their bits)."""
    return torch.cat([v[:, :1], v[:, 1:2] + dy[:, None], v[:, 2:]], -1)
