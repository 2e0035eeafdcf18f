"""The benchmark's worlds and frame, rebuilt by the reference.

Each function here takes a configuration file's dict and the body positions the
benchmark generated from its seed, and builds with the frozen copy alone:
the same bodies, shapes, camera, scene and render configuration that the
program is given, so nothing of the program's set-up reaches the reference.
`Flagship` follows `garden_tpu_torch.entry.build` and `CombinedStep`;
`physics_world` follows `entry.flagship_world`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from benchmark.reference.core import math3d as m3
from benchmark.reference.core.config import PhysicsConfig, RenderConfig, ShadowConfig
from benchmark.reference.physics import world as pw
from benchmark.reference.render import mesh as rmesh
from benchmark.reference.render.deferred import DeferredRenderer


def physics_config(cfg: Dict[str, Any]) -> PhysicsConfig:
    p = cfg["physics"]
    return PhysicsConfig(max_bodies=cfg["n_bodies"], **p)


def render_config(cfg: Dict[str, Any]) -> RenderConfig:
    r = dict(cfg["render"])
    r["shadow"] = ShadowConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in r["shadow"].items()})
    return RenderConfig(**r)


def _world(cfg: Dict[str, Any], positions: np.ndarray) -> Tuple[pw.PhysicsWorld, PhysicsConfig]:
    """A plane (body 0) and cfg's dynamic bodies at rows 1.. of `positions`
    (n_bodies, 3), their shapes taken in turn from cfg["bodies"]["shapes"]."""
    pcfg = physics_config(cfg)
    w = pw.PhysicsWorld(pcfg)
    w.add_body(w.shapes.plane((0.0, 1.0, 0.0), 0.0), motion=pw.STATIC)
    b = cfg["bodies"]
    half = b["half_extent"]
    made = {"box": lambda: w.shapes.box((half, half, half)),
            "sphere": lambda: w.shapes.sphere(half)}
    ids = [made[s]() for s in b["shapes"]]
    for k, p in enumerate(positions[1:]):
        w.add_body(ids[k % len(ids)], position=tuple(float(c) for c in p),
                   friction=b["friction"])
    return w, pcfg


def physics_world(cfg: Dict[str, Any], positions: np.ndarray, device
                  ) -> Tuple[Dict[str, Any], PhysicsConfig, frozenset]:
    """(state, config, present types) of cfg's world at `positions`."""
    w, pcfg = _world(cfg, positions)
    return w.device_state(device), pcfg, w.shapes.present_types()


class Flagship:
    """The combined step: physics, instance matrices, the deferred frame."""

    def __init__(self, cfg: Dict[str, Any], positions: np.ndarray, device):
        w, self.pcfg = _world(cfg, positions)
        self.present_types = w.shapes.present_types()
        self.state0 = w.device_state(device)
        n_dyn = cfg["n_bodies"] - 1
        side = cfg["bodies"]["lattice"]["side"]
        cube = rmesh.cube(cfg["bodies"]["half_extent"])
        ground = rmesh.plane_grid(max(side * 2.0, 20.0), 4)
        rcfg = render_config(dict(cfg, render=dict(
            cfg["render"], width=cfg["width"], height=cfg["height"],
            max_vertices=n_dyn * cube.vertex_count + ground.vertex_count,
            max_triangles=n_dyn * cube.triangle_count + ground.triangle_count,
            max_instances=n_dyn + 1)))
        scene = rmesh.SceneBuffers(rcfg.max_vertices, rcfg.max_triangles,
                                   rcfg.max_instances, texture_size=256, max_textures=0)
        box = scene.add_material(rmesh.Material(base_color=tuple(cfg["box_color"])))
        gmat = scene.add_material(rmesh.Material(base_color=(0.5, 0.5, 0.5)))
        scene.add_instance(ground, material=gmat)
        for _ in range(n_dyn):
            scene.add_instance(cube, material=box)
        self.renderer = DeferredRenderer(rcfg, scene, device)
        self.scene = self.renderer.device_scene()
        self.constants = _camera(side, cfg["width"], cfg["height"], device)
        self.n_instances = cfg["n_bodies"]

    def physics(self, phys: Dict[str, Any]) -> Dict[str, Any]:
        return pw.step(phys, self.pcfg, 1.0 / 60.0, self.present_types)

    def instance_matrices(self, phys: Dict[str, Any]) -> torch.Tensor:
        n = self.n_instances
        pos, quat = phys["bodies"]["pos"][:n], phys["bodies"]["quat"][:n]
        mats = m3.compose_trs(pos, quat, torch.ones_like(pos))
        mats[0] = torch.eye(4, device=mats.device)
        return mats

    def __call__(self, state: Dict[str, Any]):
        """-> (next state, instance matrices, image)."""
        phys = self.physics(state["physics"])
        mats = self.instance_matrices(phys)
        out = self.renderer.render(self.scene, mats, self.constants, state["frame"])
        return {"physics": phys, "frame": out["frame_state"]}, mats, out["image"]


def _camera(side: int, width: int, height: int, device) -> Dict[str, torch.Tensor]:
    """A camera above and in front of the pile, looking at the origin, and
    its sun (garden_tpu_torch.entry's flagship camera and
    systems.camera.common_constants)."""
    vec = lambda *c: torch.tensor(c, dtype=torch.float32, device=device)
    eye = vec(0.0, side * 0.9 + 4.0, side * 1.6 + 8.0)
    view = m3.look_at(eye, vec(0.0, 0.0, 0.0), vec(0.0, 1.0, 0.0))
    proj = m3.perspective_reverse_z(1.0, width / height, 0.1, device=device)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
    view_proj = m3.matmul(proj, view)
    inv_view = m3.mat4_inverse(view)
    inv_proj = m3.mat4_inverse(proj)
    return {
        "view": view, "projection": proj, "view_proj": view_proj,
        "inv_view": inv_view, "inv_proj": inv_proj,
        "inv_view_proj": m3.matmul(inv_view, inv_proj),
        "prev_view_proj": view_proj, "camera_pos": eye,
        "light_dir": m3.normalize(vec(0.4, -0.7, -0.5)),
        "frame_size": f32((width, height)), "inv_frame_size": 1.0 / f32((width, height)),
        "time": f32(0.0), "delta_time": f32(1.0 / 60.0),
    }
