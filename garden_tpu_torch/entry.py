"""The combined physics + deferred-frame step, built from the port.

`build` is the twin of the reference's `__graft_entry__._build`: the same
world (a pile of 0.9 m boxes on a static ground plane), scene, camera and
configs, built from `garden_tpu_torch` modules on an explicit device. It
returns `(step, state)` with `step(state) -> (state, image)`.

With no overrides the frame is the flagship's: cascaded shadows on the
split atlas raster, half-res HBAO, the atmosphere, bloom, auto exposure and
FXAA. `cfg_overrides=DENSE_SHADOW_OVERRIDES` gives the reference-parity
shadows (`ShadowConfig()` defaults: three 2048 cascades drawn by the dense
depth raster); `cfg_overrides=SLICE_OVERRIDES` turns shadows, HBAO, bloom,
the atmosphere and FXAA off.

`box_materials=GLASS_BOXES` with `cfg_overrides=GLASS_OVERRIDES` is the
glass step: the flagship frame whose boxes take, in rotation, opaque,
weighted-blended OIT, sorted (back-to-front) and refractive materials, with
the trans-depth pass on, so one frame runs every non-opaque pass and the
translucent shadow map.

`cfg_overrides=ULTRA_OVERRIDES` is the `ultra` quality preset: volumetric
clouds with their shadow, SSR and SSGI, and the dense 3x2048 shadow atlas
with a 5x5 PCF. `cfg_overrides=TEMPORAL_OVERRIDES` adds the temporal pass
set to the flagship: per-pixel velocity and the disocclusion mask, Hi-Z
occlusion culling against the previous frame's depth, and SMAA in place
of FXAA. Any other `QUALITY_PRESETS` entry applies the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import (QUALITY_PRESETS, PhysicsConfig, RenderConfig,
                                          SLICE_OVERRIDES, ShadowConfig)
from garden_tpu_torch.physics import world as pw
from garden_tpu_torch.render import mesh as rmesh
from garden_tpu_torch.render.deferred import DeferredRenderer
from garden_tpu_torch.systems.camera import common_constants

__all__ = ["CombinedStep", "DENSE_SHADOW_OVERRIDES", "GLASS_BOXES",
           "GLASS_OVERRIDES", "SLICE_OVERRIDES", "TEMPORAL_OVERRIDES",
           "ULTRA_OVERRIDES", "build"]

# the reference-parity shadow preset: the dense depth raster over a
# 6144x2048 atlas of 128x128 tiles
DENSE_SHADOW_OVERRIDES = dict(shadow=ShadowConfig())

BOX_MATERIAL = rmesh.Material(base_color=(0.8, 0.3, 0.2))     # the flagship's
_OIT = rmesh.Material(base_color=(0.6, 0.8, 1.0), roughness=0.1, alpha=0.35,
                      blend_mode="oit")
_SORTED = rmesh.Material(base_color=(0.2, 0.9, 0.3), alpha=0.5, blend_mode="sorted")
_REFRACT = rmesh.Material(base_color=(0.9, 1.0, 0.9), roughness=0.1,
                          blend_mode="refract")
# dynamic box k takes GLASS_BOXES[k % 8]: an eighth of the boxes each OIT,
# sorted and refractive, the rest opaque
GLASS_BOXES = (BOX_MATERIAL, _OIT, BOX_MATERIAL, _SORTED, BOX_MATERIAL, _REFRACT,
               BOX_MATERIAL, BOX_MATERIAL)
GLASS_OVERRIDES = dict(use_trans_depth=True)

ULTRA_OVERRIDES = dict(QUALITY_PRESETS["ultra"])
TEMPORAL_OVERRIDES = dict(use_velocity=True, use_occlusion_culling=True, aa_mode="smaa")


class CombinedStep:
    """One physics step, instance matrices from the body poses, one frame.
    Its parts are exposed so callers can time or inspect each stage."""

    def __init__(self, pcfg: PhysicsConfig, present_types: frozenset,
                 renderer: DeferredRenderer, scene: Dict[str, torch.Tensor],
                 constants: Dict[str, torch.Tensor], n_instances: int):
        self.pcfg = pcfg
        self.present_types = present_types
        self.renderer = renderer
        self.scene = scene
        self.constants = constants
        self.n_instances = n_instances

    def physics(self, phys: Dict[str, Any]) -> Dict[str, Any]:
        return pw.step(phys, self.pcfg, 1.0 / 60.0, self.present_types)

    def instance_matrices(self, phys: Dict[str, Any]) -> torch.Tensor:
        """Instance 0 is the static ground; instances 1.. track bodies 1.."""
        n = self.n_instances
        pos, quat = phys["bodies"]["pos"][:n], phys["bodies"]["quat"][:n]
        mats = m3.compose_trs(pos, quat, torch.ones_like(pos))
        mats[0] = torch.eye(4, device=mats.device)
        return mats

    def render(self, inst_mats: torch.Tensor, frame: Dict[str, torch.Tensor],
               prev_inst_matrices: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        return self.renderer.render(self.scene, inst_mats, self.constants, frame,
                                    prev_inst_matrices)

    def __call__(self, state: Dict[str, Any]) -> Tuple[Dict[str, Any], torch.Tensor]:
        phys = self.physics(state["physics"])
        out = self.render(self.instance_matrices(phys), state["frame"])
        return {"physics": phys, "frame": out["frame_state"]}, out["image"]


def flagship_world(n_bodies: int, grid_dim: int = 16, cell_size: float = 2.0
                   ) -> Tuple[pw.PhysicsWorld, PhysicsConfig, int]:
    """The combined step's physics world (a plane and n_bodies - 1 boxes of
    0.45 m on a 1.05 m lattice), its config and the lattice's side."""
    pcfg = PhysicsConfig(max_bodies=n_bodies, grid_dim=grid_dim,
                         cell_size=cell_size, max_contacts_per_body=7,
                         solver_iterations=8, max_globals=1,
                         max_active_contacts=16)
    w = pw.PhysicsWorld(pcfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=pw.STATIC)
    box = w.shapes.box((0.45, 0.45, 0.45))
    n_dyn = n_bodies - 1
    side = max(int(round(n_dyn ** (1.0 / 3.0))), 1)
    count = 0
    for iy in range(n_dyn // (side * side) + 2):
        for iz in range(side):
            for ix in range(side):
                if count >= n_dyn:
                    break
                w.add_body(box, position=(ix * 1.05 - side / 2, 0.5 + iy * 1.05,
                                          iz * 1.05 - side / 2), friction=0.5)
                count += 1
    return w, pcfg, side


def build(n_bodies: int, width: int, height: int, grid_dim: int = 16,
          cell_size: float = 2.0, tile_size: int = 128,
          cfg_overrides: Optional[dict] = None, *, device,
          box_materials: Optional[Tuple[rmesh.Material, ...]] = None
          ) -> Tuple[CombinedStep, Dict[str, Any]]:
    """The combined step and its initial state on `device`. Dynamic box k
    takes box_materials[k % len(box_materials)] (default: the flagship's
    one material)."""
    w, pcfg, side = flagship_world(n_bodies, grid_dim, cell_size)
    n_dyn = n_bodies - 1

    cube_mesh = rmesh.cube(0.45)
    ground = rmesh.plane_grid(max(side * 2.0, 20.0), 4)
    rkwargs = dict(
        width=width, height=height, tile_size=tile_size,
        max_vertices=n_dyn * cube_mesh.vertex_count + ground.vertex_count,
        max_triangles=n_dyn * cube_mesh.triangle_count + ground.triangle_count,
        max_tris_per_tile=512, max_instances=n_dyn + 1,
        shadow=ShadowConfig(resolve_step=2, cascade_sizes=(2048, 1024, 1024),
                            atlas_tile_h=16, atlas_foot_y=2,
                            max_active_tiles=768),
        tile_h=32, foot_y=2,
    )
    rkwargs.update(cfg_overrides or {})
    rcfg = RenderConfig(**rkwargs)
    scene = rmesh.SceneBuffers(rcfg.max_vertices, rcfg.max_triangles,
                               rcfg.max_instances)
    box_materials = box_materials or (BOX_MATERIAL,)
    rows = {}                        # one material row per distinct material
    for m in box_materials:
        if m not in rows:
            rows[m] = scene.add_material(m)
    gmat = scene.add_material(rmesh.Material(base_color=(0.5, 0.5, 0.5)))
    scene.add_instance(ground, material=gmat)
    for k in range(n_dyn):
        scene.add_instance(cube_mesh, material=rows[box_materials[k % len(box_materials)]])
    renderer = DeferredRenderer(rcfg, scene, device)

    vec = lambda *c: torch.tensor(c, dtype=torch.float32, device=device)
    eye = vec(0.0, side * 0.9 + 4.0, side * 1.6 + 8.0)
    view = m3.look_at(eye, vec(0.0, 0.0, 0.0), vec(0.0, 1.0, 0.0))
    proj = m3.perspective_reverse_z(1.0, width / height, 0.1, device=device)
    constants = common_constants(eye, view, proj, vec(0.4, -0.7, -0.5),
                                 (width, height), 0.0, 1.0 / 60.0)
    state = {"physics": w.device_state(device),
             "frame": renderer.initial_frame_state()}
    step = CombinedStep(pcfg, w.shapes.present_types(), renderer,
                        renderer.device_scene(), constants, n_dyn + 1)
    return step, state
