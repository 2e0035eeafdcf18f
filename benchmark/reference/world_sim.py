"""The combined world sim, rebuilt by the reference: the flagship's world and
combined step (`scenes.Flagship`) with the configuration file's materials,
camera and sun, and its render switches (clouds, trans-depth, the split
shadow atlas) in the render configuration.

Built from the frozen copy alone, in float32 (the caller turns TF32 off):
box k takes `cfg["materials"][k % len(materials)]`, one material row per
distinct material in order of first use and the ground's last, as
`garden_tpu_torch.entry.build` lays them out; the camera looks from
`cfg["camera"]["eye"]` at its `target` with its vertical FOV and near
plane, the sun shines along `cfg["sun_dir"]`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from benchmark.reference import scenes
from benchmark.reference.core import math3d as m3
from benchmark.reference.render import mesh as rmesh
from benchmark.reference.render.deferred import DeferredRenderer


def materials(cfg: Dict[str, Any]):
    """The file's material rotation as the reference's Materials."""
    return [rmesh.Material(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in m.items()}) for m in cfg["materials"]]


class WorldSim(scenes.Flagship):
    """The combined step of the world sim: physics, instance matrices and
    the deferred frame, as `scenes.Flagship` steps them."""

    def __init__(self, cfg: Dict[str, Any], positions: np.ndarray, device):
        w, self.pcfg = scenes._world(cfg, positions)
        self.present_types = w.shapes.present_types()
        self.state0 = w.device_state(device)
        n_dyn = cfg["n_bodies"] - 1
        side = cfg["bodies"]["lattice"]["side"]
        cube = rmesh.cube(cfg["bodies"]["half_extent"])
        ground = rmesh.plane_grid(max(side * 2.0, 20.0), 4)
        rcfg = scenes.render_config(dict(cfg, render=dict(
            cfg["render"], width=cfg["width"], height=cfg["height"],
            max_vertices=n_dyn * cube.vertex_count + ground.vertex_count,
            max_triangles=n_dyn * cube.triangle_count + ground.triangle_count,
            max_instances=n_dyn + 1)))
        scene = rmesh.SceneBuffers(rcfg.max_vertices, rcfg.max_triangles,
                                   rcfg.max_instances, texture_size=256, max_textures=0)
        mats = materials(cfg)
        rows = {}
        for m in mats:
            if m not in rows:
                rows[m] = scene.add_material(m)
        gmat = scene.add_material(rmesh.Material(base_color=(0.5, 0.5, 0.5)))
        scene.add_instance(ground, material=gmat)
        for k in range(n_dyn):
            scene.add_instance(cube, material=rows[mats[k % len(mats)]])
        self.renderer = DeferredRenderer(rcfg, scene, device)
        self.scene = self.renderer.device_scene()
        self.constants = camera(cfg, device)
        self.n_instances = cfg["n_bodies"]


def camera(cfg: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The file's camera and sun as the frame's constants (the keys and
    formulas of `scenes._camera`)."""
    cam = cfg["camera"]
    width, height = cfg["width"], cfg["height"]
    vec = lambda c: torch.tensor([float(x) for x in c], dtype=torch.float32, device=device)
    eye = vec(cam["eye"])
    view = m3.look_at(eye, vec(cam["target"]), vec((0.0, 1.0, 0.0)))
    proj = m3.perspective_reverse_z(cam["fov_y_rad"], width / height, cam["near"],
                                    device=device)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
    view_proj = m3.matmul(proj, view)
    inv_view = m3.mat4_inverse(view)
    inv_proj = m3.mat4_inverse(proj)
    return {
        "view": view, "projection": proj, "view_proj": view_proj,
        "inv_view": inv_view, "inv_proj": inv_proj,
        "inv_view_proj": m3.matmul(inv_view, inv_proj),
        "prev_view_proj": view_proj, "camera_pos": eye,
        "light_dir": m3.normalize(vec(cfg["sun_dir"])),
        "frame_size": f32((width, height)), "inv_frame_size": 1.0 / f32((width, height)),
        "time": f32(0.0), "delta_time": f32(1.0 / 60.0),
    }
