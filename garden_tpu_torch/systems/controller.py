"""Camera / player controllers.

Rebuild of FpvControllerSystem (include/garden/system/controller/fpv.hpp:31)
and Controller2DSystem (2d.hpp:33): host-side input -> camera pose / desired
character velocity. The controllers read the InputSystem state each tick and
produce values the step consumes.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from garden_tpu_torch.core.ecs import System
from garden_tpu_torch.systems.input import InputSystem


class FpvController(System):
    """First-person fly camera: mouse-look + WASD/EQ movement."""

    def __init__(self, position=(0.0, 2.0, 8.0), yaw: float = 0.0,
                 pitch: float = 0.0, speed: float = 6.0,
                 sensitivity: float = 0.003, boost: float = 4.0):
        self.position = np.asarray(position, np.float32)
        self.yaw = yaw
        self.pitch = pitch
        self.speed = speed
        self.sensitivity = sensitivity
        self.boost = boost

    def process(self, inp: InputSystem, dt: float) -> None:
        dx, dy = inp.cursor_delta
        self.yaw -= dx * self.sensitivity
        self.pitch = max(-1.55, min(1.55, self.pitch - dy * self.sensitivity))

        forward = self.forward()
        right = np.array([math.cos(self.yaw), 0.0, -math.sin(self.yaw)],
                         np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        move = np.zeros(3, np.float32)
        if inp.is_down("w"):
            move += forward
        if inp.is_down("s"):
            move -= forward
        if inp.is_down("d"):
            move += right
        if inp.is_down("a"):
            move -= right
        if inp.is_down("e"):
            move += up
        if inp.is_down("q"):
            move -= up
        n = np.linalg.norm(move)
        if n > 1e-6:
            speed = self.speed * (self.boost if inp.is_down("shift") else 1.0)
            self.position = self.position + move / n * speed * dt

    def forward(self) -> np.ndarray:
        cp = math.cos(self.pitch)
        return np.array([
            -math.sin(self.yaw) * cp,
            math.sin(self.pitch),
            -math.cos(self.yaw) * cp,
        ], np.float32)

    def view_target(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.position, self.position + self.forward()


class Controller2D(System):
    """Side-scroller control: A/D walk, space jump — drives a character
    component's desired velocity (Controller2DSystem analog)."""

    def __init__(self, entity: int, walk_speed: float = 4.0,
                 jump_impulse: float = 5.0):
        self.entity = entity
        self.walk_speed = walk_speed
        self.jump_impulse = jump_impulse

    def process(self, inp: InputSystem) -> Tuple[float, float]:
        """Returns (desired_vx, jump) to write into the character comp."""
        vx = 0.0
        if inp.is_down("d") or inp.is_down("right"):
            vx += self.walk_speed
        if inp.is_down("a") or inp.is_down("left"):
            vx -= self.walk_speed
        jump = self.jump_impulse if inp.was_pressed("space") else 0.0
        return vx, jump
