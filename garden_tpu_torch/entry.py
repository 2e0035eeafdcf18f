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
translucent shadow map. `cfg_overrides=WORLD_SIM_OVERRIDES` adds the
volumetric clouds and their shadow to the glass step: with
`box_materials=GLASS_BOXES` and `camera=WORLD_SIM_CAMERA`, a camera low
enough that the upper half of the frame is sky, it is the combined world
sim (10K bodies under a cloudy sky, every non-opaque pass, the split
shadow atlas). `build` takes any camera as `camera=(eye, target)`; the
default is the flagship's, which sees no sky.

`cfg_overrides=ULTRA_OVERRIDES` is the `ultra` quality preset: volumetric
clouds with their shadow, SSR and SSGI, and the dense 3x2048 shadow atlas
with a 5x5 PCF. `cfg_overrides=TEMPORAL_OVERRIDES` adds the temporal pass
set to the flagship: per-pixel velocity and the disocclusion mask, Hi-Z
occlusion culling against the previous frame's depth, and SMAA in place
of FXAA. Any other `QUALITY_PRESETS` entry applies the same way.

`build_forward` puts the flagship scene and camera through the forward
renderer (`render.forward.ForwardRenderer`: one visibility pass on square
128x128 tiles, no shadows or post). `build_feature_frame` is the flagship with every scene feature the
reference's renderer takes: shadows with a y-footprint of 8 atlas tiles
(`FEATURE_OVERRIDES`: slot-binned cascades, then the split depth raster),
base-colour textures on every other box (`FEATURE_BOXES`, 8 seeded
textures), a lat-long environment map of the procedural sky in place of
the atmosphere, and a HUD of nine-slice panels and sprites composited
after AA. `build_bench_frame` draws bench.py's world (boxes and spheres,
`physics.scenes.bench_world`) with the flagship's camera and passes, each
sphere a two-level LOD chain switching at the 0.1 quantile of the
spheres' camera distances (BENCH_LOD_QUANTILE).

`build_engine_frame` is the runtime's frame: an `Engine` (transform,
camera, physics, character, animation, spawner, link and the UI systems)
whose entities are the flagship pile (entity i carries body i, and its
baked world matrix is the scene's instance i), N_CHARACTERS capsule
characters walking beside it, N_ANIMATED entities on named animation tracks
(one with a property curve) and a HUD of labels, two buttons, a checkbox
and a focused input box emitted through `render.text.FontAtlas` (the
committed `DEFAULT_GLYPHS`, no PIL). One engine frame is one Engine step
(Input, Update, Output), the bake of the world matrices and the flagship's
deferred frame.

`dryrun_multichip(n, devices)` is the reference's multichip dryrun: a tiny
combined step, one world and one frame on each of n devices through
`parallel.worlds.WorldBatch`, each device's step a `CombinedStep.to` copy.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import (QUALITY_PRESETS, EngineConfig, PhysicsConfig,
                                          RenderConfig, SLICE_OVERRIDES, ShadowConfig)
from garden_tpu_torch.engine import Engine
from garden_tpu_torch.parallel.worlds import WorldBatch
from garden_tpu_torch.physics import scenes
from garden_tpu_torch.physics import shapes as psh
from garden_tpu_torch.physics import world as pw
from garden_tpu_torch.ops.blur import decimate2x
from garden_tpu_torch.render import atmosphere, ibl, lighting
from garden_tpu_torch.render import mesh as rmesh
from garden_tpu_torch.render import sprites as rsprites
from garden_tpu_torch.render import text as rtext
from garden_tpu_torch.render.deferred import DeferredRenderer
from garden_tpu_torch.render.forward import ForwardRenderer
from garden_tpu_torch.systems import ui
from garden_tpu_torch.systems.animation import AnimationSystem
from garden_tpu_torch.systems.camera import CameraSystem, common_constants
from garden_tpu_torch.systems.character import CharacterSystem
from garden_tpu_torch.systems.link import LinkSystem
from garden_tpu_torch.systems.physics import PhysicsSystem
from garden_tpu_torch.systems.spawner import SpawnerSystem
from garden_tpu_torch.systems.transform import TransformSystem, bake_world_matrices
from garden_tpu_torch.utils import profiler
from garden_tpu_torch.utils.cuda_graph import GraphedStep

__all__ = ["CombinedStep", "DENSE_SHADOW_OVERRIDES", "EngineFrame", "FEATURE_BOXES",
           "FEATURE_OVERRIDES", "GLASS_BOXES", "GLASS_OVERRIDES", "SLICE_OVERRIDES",
           "TEMPORAL_OVERRIDES", "ULTRA_OVERRIDES", "WORLD_SIM_CAMERA",
           "WORLD_SIM_OVERRIDES", "build", "build_bench_frame",
           "build_engine_frame", "build_feature_frame", "build_forward",
           "dryrun_multichip", "world_sim_cloud_inputs"]

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
# the glass step under the clouds; the flagship camera's top row points
# 0.2 deg below the horizon, so none of its half-res sky rays reaches the
# cloud layer (mu > 0.02): WORLD_SIM_CAMERA, at the pile's mid-height in
# front of it, sees sky on 54% of them and still frames the whole pile
WORLD_SIM_OVERRIDES = dict(GLASS_OVERRIDES, use_clouds=True)
WORLD_SIM_CAMERA = ((0.0, 6.0, 45.0), (0.0, 9.0, 0.0))

ULTRA_OVERRIDES = dict(QUALITY_PRESETS["ultra"])
TEMPORAL_OVERRIDES = dict(use_velocity=True, use_occlusion_culling=True, aa_mode="smaa")

# the flagship's shadows with the default y-footprint of 16-row atlas tiles,
# 256 // 16 = 8: slot-binned cascades
FEATURE_OVERRIDES = dict(shadow=ShadowConfig(
    resolve_step=2, cascade_sizes=(2048, 1024, 1024), atlas_tile_h=16,
    atlas_foot_y=None, max_active_tiles=768))
N_FEATURE_TEXTURES = 8
# dynamic box k takes FEATURE_BOXES[k % 16]: every other box textured, box
# 2j + 1 with texture j % 8 over a light tint
FEATURE_BOXES = tuple(
    BOX_MATERIAL if k % 2 == 0 else
    rmesh.Material(base_color=(0.9, 0.85, 0.8), roughness=0.6, base_texture=k // 2)
    for k in range(2 * N_FEATURE_TEXTURES))
BENCH_SPHERE_LODS = ((6, 12), (3, 6))   # uv_sphere (rings, segments) per level
# the LOD switch: this quantile of the sphere centres' camera distances. At
# full size the camera sees mostly the pile's front face, 32-49 m away: the
# median of all centres (45.8 m) leaves 1 of 618 visible instances beyond
# it, the 0.1 quantile (36.8 m) 36% of them
BENCH_LOD_QUANTILE = 0.1


class CombinedStep:
    """One physics step, instance matrices from the body poses, one frame.
    Its parts are exposed so callers can time or inspect each stage; each
    runs in a span of its name (`physics`, `instance_matrices`, `render`),
    the whole step in the span `step`. On a card the physics step replays
    a CUDA graph of `physics.world.step` (`utils.cuda_graph.GraphedStep`,
    one a state layout; the first call of a layout runs eagerly, the
    second captures). A replayed `physics` span opens no stage span; while
    a profiler records, its `graph_replay` span carries a record of each
    stage span of the capture, each naming its device ops."""

    def __init__(self, pcfg: PhysicsConfig, present_types: frozenset,
                 renderer: DeferredRenderer, scene: Dict[str, torch.Tensor],
                 constants: Dict[str, torch.Tensor], n_instances: int):
        self.pcfg = pcfg
        self.present_types = present_types
        self.renderer = renderer
        self.scene = scene
        self.constants = constants
        self.n_instances = n_instances
        # the frame's optional inputs: a lat-long environment map, a UI atlas
        # and its sprites (SpriteBatch.device_arrays)
        self.environment: Optional[torch.Tensor] = None
        self.ui_atlas: Optional[torch.Tensor] = None
        self.ui_sprites: Optional[Dict[str, Any]] = None
        self.physics_step = GraphedStep(functools.partial(
            pw.step, config=pcfg, dt=1.0 / 60.0, present_types=present_types))

    def physics(self, phys: Dict[str, Any]) -> Dict[str, Any]:
        with profiler.span("physics"):
            out = self.physics_step(phys)
            pw.count_contacts(out)
        return out

    def instance_matrices(self, phys: Dict[str, Any]) -> torch.Tensor:
        """Instance 0 is the static ground; instances 1.. track bodies 1.."""
        with profiler.span("instance_matrices"):
            n = self.n_instances
            pos, quat = phys["bodies"]["pos"][:n], phys["bodies"]["quat"][:n]
            mats = m3.compose_trs(pos, quat, torch.ones_like(pos))
            mats[0] = torch.eye(4, device=mats.device)
        return mats

    def render(self, inst_mats: torch.Tensor, frame: Dict[str, torch.Tensor],
               prev_inst_matrices: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        with profiler.span("render"):
            return self.renderer.render(self.scene, inst_mats, self.constants, frame,
                                        ui_atlas=self.ui_atlas, ui_sprites=self.ui_sprites,
                                        prev_inst_matrices=prev_inst_matrices,
                                        environment=self.environment)

    def __call__(self, state: Dict[str, Any]) -> Tuple[Dict[str, Any], torch.Tensor]:
        with profiler.span("step"):
            phys = self.physics(state["physics"])
            out = self.render(self.instance_matrices(phys), state["frame"])
        return {"physics": phys, "frame": out["frame_state"]}, out["image"]

    def to(self, device) -> "CombinedStep":
        """This step on `device`: a renderer of its own there (as FrameTiles
        builds one per band device), the scene, constants and the frame's
        optional inputs copied there. A state for it is moved with `.to`
        leaf by leaf (WorldBatch.replicate does)."""
        renderer = DeferredRenderer(self.renderer.config, self.renderer.scene_host, device)
        move = lambda tree: tree_map(
            lambda x: x.to(renderer.device) if isinstance(x, torch.Tensor) else x, tree)
        step = CombinedStep(self.pcfg, self.present_types, renderer, renderer.device_scene(),
                            move(self.constants), self.n_instances)
        step.environment, step.ui_atlas, step.ui_sprites = move(
            (self.environment, self.ui_atlas, self.ui_sprites))
        return step


def _pile_side(n_bodies: int) -> int:
    """The side of the flagship's lattice of n_bodies - 1 boxes."""
    return max(int(round((n_bodies - 1) ** (1.0 / 3.0))), 1)


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
    side = _pile_side(n_bodies)
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


def _render_config(width: int, height: int, tile_size: int, max_vertices: int,
                   max_triangles: int, max_instances: int,
                   cfg_overrides: Optional[dict]) -> RenderConfig:
    """The flagship's RenderConfig at these capacities, with overrides."""
    rkwargs = dict(
        width=width, height=height, tile_size=tile_size,
        max_vertices=max_vertices, max_triangles=max_triangles,
        max_tris_per_tile=512, max_instances=max_instances,
        shadow=ShadowConfig(resolve_step=2, cascade_sizes=(2048, 1024, 1024),
                            atlas_tile_h=16, atlas_foot_y=2,
                            max_active_tiles=768),
        tile_h=32, foot_y=2,
    )
    rkwargs.update(cfg_overrides or {})
    return RenderConfig(**rkwargs)


def _flagship_camera(side: int, width: int, height: int, device,
                     camera: Optional[Tuple[Sequence[float], Sequence[float]]] = None
                     ) -> Dict[str, torch.Tensor]:
    """The flagship's constants: a camera above and in front of a pile
    `side` bodies wide, looking at the origin, or at `camera` (eye,
    target) when given, and its sun."""
    vec = lambda *c: torch.tensor(c, dtype=torch.float32, device=device)
    if camera is None:
        eye, target = vec(0.0, side * 0.9 + 4.0, side * 1.6 + 8.0), vec(0.0, 0.0, 0.0)
    else:
        eye, target = (vec(*(float(c) for c in p)) for p in camera)
    view = m3.look_at(eye, target, vec(0.0, 1.0, 0.0))
    proj = m3.perspective_reverse_z(1.0, width / height, 0.1, device=device)
    return common_constants(eye, view, proj, vec(0.4, -0.7, -0.5),
                            (width, height), 0.0, 1.0 / 60.0)


def world_sim_cloud_inputs(device, width: int = 1920, height: int = 1080):
    """The cloud march's and shadow's inputs in the world sim's frame:
    its half-res view rays (height / 2, width / 2, 3), its sun (toward the
    light) and time, and the ground points under the rays: where a ray
    meets the plane y = 0, or 2 km along it when it does not."""
    c = _flagship_camera(0, width, height, device, camera=WORLD_SIM_CAMERA)
    rays = lighting.view_rays({"depth": torch.zeros(height, width, device=device)}, c)
    rays_h = decimate2x(rays)
    eye = c["camera_pos"]
    dist = torch.where(rays_h[..., 1] < -1e-3, -eye[1] / rays_h[..., 1], 2000.0)
    return rays_h, -c["light_dir"], c["time"], eye + rays_h * dist[..., None]


def flagship_atmosphere_inputs(device, n_bodies: int = 10240, width: int = 1920,
                               height: int = 1080):
    """The atmosphere's inputs at play's shapes, from the flagship camera
    over a pile of n_bodies: its view rays (height, width, 3), their
    half-res decimation, those mirrored off the ground (the specular sky's
    rays over a flat floor), each pixel's distance to the ground in km (0
    where its ray does not meet it) and the sun (toward the light)."""
    c = _flagship_camera(_pile_side(n_bodies), width, height, device)
    rays = lighting.view_rays({"depth": torch.zeros(height, width, device=device)}, c)
    rays_h = decimate2x(rays)
    refl_h = m3.reflect(rays_h, m3.constant((0.0, 1.0, 0.0), device))
    depth = torch.where(rays[..., 1] < -1e-3, -c["camera_pos"][1] / rays[..., 1] * 0.001, 0.0)
    return rays, rays_h, refl_h, depth, -c["light_dir"]


def _combined_step(phys_state, pcfg: PhysicsConfig, present_types: frozenset,
                   rcfg: RenderConfig, scene: rmesh.SceneBuffers,
                   constants: Dict[str, torch.Tensor], device
                   ) -> Tuple[CombinedStep, Dict[str, Any]]:
    renderer = DeferredRenderer(rcfg, scene, device)
    state = {"physics": phys_state, "frame": renderer.initial_frame_state()}
    return CombinedStep(pcfg, present_types, renderer, renderer.device_scene(), constants,
                        pcfg.max_bodies), state


def build(n_bodies: int, width: int, height: int, grid_dim: int = 16,
          cell_size: float = 2.0, tile_size: int = 128,
          cfg_overrides: Optional[dict] = None, *, device,
          box_materials: Optional[Tuple[rmesh.Material, ...]] = None,
          textures: Sequence[np.ndarray] = (),
          camera: Optional[Tuple[Sequence[float], Sequence[float]]] = None
          ) -> Tuple[CombinedStep, Dict[str, Any]]:
    """The combined step and its initial state on `device`. Dynamic box k
    takes box_materials[k % len(box_materials)] (default: the flagship's
    one material); `textures` (square RGBA images of one size) fill the
    scene's texture array, in order, for Material.base_texture; `camera`
    (eye, target), world points, places the camera (default: the
    flagship's, above and in front of the pile, looking at the origin)."""
    w, pcfg, side = flagship_world(n_bodies, grid_dim, cell_size)
    n_dyn = n_bodies - 1
    cube_mesh = rmesh.cube(0.45)
    ground = rmesh.plane_grid(max(side * 2.0, 20.0), 4)
    rcfg = _render_config(
        width, height, tile_size,
        n_dyn * cube_mesh.vertex_count + ground.vertex_count,
        n_dyn * cube_mesh.triangle_count + ground.triangle_count, n_dyn + 1,
        cfg_overrides)
    tex_size = textures[0].shape[0] if len(textures) else 256
    scene = rmesh.SceneBuffers(rcfg.max_vertices, rcfg.max_triangles,
                               rcfg.max_instances, texture_size=tex_size,
                               max_textures=len(textures))
    for img in textures:
        scene.add_texture(img)
    box_materials = box_materials or (BOX_MATERIAL,)
    rows = {}                        # one material row per distinct material
    for m in box_materials:
        if m not in rows:
            rows[m] = scene.add_material(m)
    gmat = scene.add_material(rmesh.Material(base_color=(0.5, 0.5, 0.5)))
    scene.add_instance(ground, material=gmat)
    for k in range(n_dyn):
        scene.add_instance(cube_mesh, material=rows[box_materials[k % len(box_materials)]])
    return _combined_step(w.device_state(device), pcfg, w.shapes.present_types(), rcfg,
                          scene, _flagship_camera(side, width, height, device, camera),
                          device)


# the reference's multichip dryrun: its tiny combined step, shadows scaled
# to the frame (the dense atlas: max_active_tiles unset), clouds off
DRYRUN_SIZE = dict(n_bodies=32, width=64, height=32, grid_dim=8, tile_size=128)
DRYRUN_OVERRIDES = dict(shadow=ShadowConfig(map_size=128, resolve_step=1), use_clouds=False)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None
                     ) -> Tuple[List[Dict[str, Any]], torch.Tensor]:
    """The twin of `__graft_entry__.dryrun_multichip`: the tiny combined
    step (DRYRUN_SIZE, DRYRUN_OVERRIDES), one world and one frame on each of
    `n_devices` devices through WorldBatch, stepped once. `devices` defaults
    to the first n_devices cards and may repeat a device (["cpu"] * n runs
    on the CPU). -> (each device's stepped state, with a world axis of 1,
    images (n_devices, 32, 64, 3) uint8 on devices[0])."""
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n_devices:
            raise RuntimeError(f"dryrun_multichip: {n_devices} cards needed, {visible} "
                               "visible; name the devices to run elsewhere")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"dryrun_multichip: {len(devices)} devices for {n_devices}")
    step, state = build(**DRYRUN_SIZE, cfg_overrides=DRYRUN_OVERRIDES, device=devices[0])
    wb = WorldBatch([step] + [step.to(d) for d in devices[1:]], n_devices, devices=devices)
    out = wb.step(wb.replicate(state))
    images = torch.cat([img.to(devices[0]) for _, img in out])
    print(f"dryrun_multichip: {n_devices} devices OK, image batch {tuple(images.shape)}")
    return [s for s, _ in out], images


def build_forward(n_bodies: int, width: int, height: int, grid_dim: int = 16, *,
                  device, use_hdr: bool = False):
    """The flagship's scene, initial poses and camera under the forward
    renderer -> (renderer, device scene, instance matrices, constants);
    one frame is renderer.render(scene, mats, constants)."""
    step, state = build(n_bodies, width, height, grid_dim, device=device)
    fwd = ForwardRenderer(step.renderer.config, step.renderer.scene_host, device,
                          use_hdr=use_hdr)
    return fwd, step.scene, step.instance_matrices(state["physics"]), step.constants


def feature_textures(seed: int = 0, size: int = 256, count: int = N_FEATURE_TEXTURES
                     ) -> list:
    """`count` seeded (size, size, 4) RGBA textures, alpha 1: a checker of
    a seeded period and two colours, with seeded noise over it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    out = []
    for _ in range(count):
        period = int(rng.integers(8, 65))
        c0, c1 = rng.uniform(0.2, 1.0, (2, 3))
        check = ((xx // period + yy // period) % 2)[..., None]
        rgb = np.where(check == 1, c1, c0) * rng.uniform(0.8, 1.0, (size, size, 1))
        out.append(np.concatenate([rgb, np.ones((size, size, 1))], -1).astype(np.float32))
    return out


def environment_map(sun_dir_to_light: torch.Tensor, height: int = 512) -> torch.Tensor:
    """A height x 2 height lat-long map (3 channels) of the procedural sky
    (`atmosphere.sky_radiance`, 12 march steps) at the texel centres."""
    dirs, _ = ibl._latlong_dirs(height, 2 * height, sun_dir_to_light.device)
    return atmosphere.sky_radiance(dirs, sun_dir_to_light)


def hud(width: int, height: int, seed: int = 0, atlas_size: int = 512
        ) -> Tuple[rsprites.TextureAtlas, rsprites.SpriteBatch]:
    """A HUD over a seeded atlas: four nine-slice panels (36 sprites) at
    the frame's corners and 12 icons in a bar along the bottom, all placed
    in proportion to the frame."""
    rng = np.random.default_rng(seed)
    atlas = rsprites.TextureAtlas(atlas_size)
    panel = np.zeros((48, 48, 4), np.float32)
    panel[..., :3] = rng.uniform(0.1, 0.3, 3)
    panel[..., 3] = 0.7
    panel[:4], panel[-4:], panel[:, :4], panel[:, -4:] = 1.0, 1.0, 1.0, 1.0
    panel_region = atlas.add(panel)
    yy, xx = np.mgrid[0:32, 0:32]
    disc = (((xx - 15.5) ** 2 + (yy - 15.5) ** 2) < 15.0 ** 2).astype(np.float32)
    icons = []
    for _ in range(4):
        img = np.concatenate([rng.uniform(0.3, 1.0, (32, 32, 3)), disc[..., None]],
                             -1).astype(np.float32)
        icons.append(atlas.add(img))
    batch = rsprites.SpriteBatch(atlas, capacity=64)
    pw_, ph_ = 0.22 * width, 0.16 * height
    border = max(0.012 * height, 2.0)
    for x in (0.02 * width, 0.76 * width):
        for y in (0.03 * height, 0.79 * height):
            batch.push_nine_slice(x, y, pw_, ph_, panel_region, border,
                                  color=(1.0, 1.0, 1.0, 0.85))
    size = 0.045 * height
    for i in range(12):
        color = tuple(rng.uniform(0.6, 1.0, 3)) + (0.9,)
        batch.push(rsprites.Sprite(0.30 * width + i * 1.2 * size, 0.90 * height, size, size,
                                   icons[i % len(icons)], color))
    return atlas, batch


def build_feature_frame(n_bodies: int, width: int, height: int, grid_dim: int = 16,
                        cell_size: float = 2.0, tile_size: int = 128,
                        cfg_overrides: Optional[dict] = None, *, device,
                        seed: int = 0, env_height: int = 512
                        ) -> Tuple[CombinedStep, Dict[str, Any]]:
    """The feature frame's combined step: `build` with FEATURE_OVERRIDES
    (then `cfg_overrides`), FEATURE_BOXES over `feature_textures(seed)`,
    the environment map of the sky (`environment_map`, env_height rows)
    and the HUD (`hud`) attached to the step."""
    step, state = build(n_bodies, width, height, grid_dim, cell_size, tile_size,
                        dict(FEATURE_OVERRIDES, **(cfg_overrides or {})), device=device,
                        box_materials=FEATURE_BOXES, textures=feature_textures(seed))
    step.environment = environment_map(-step.constants["light_dir"], env_height)
    atlas, batch = hud(width, height, seed)
    step.ui_atlas = atlas.device(device)
    step.ui_sprites = batch.device_arrays(device)
    return step, state


def build_bench_frame(n_bodies: int, width: int, height: int, tile_size: int = 128,
                      cfg_overrides: Optional[dict] = None, *, device
                      ) -> Tuple[CombinedStep, Dict[str, Any]]:
    """The combined step of bench.py's world (`physics.scenes.bench_world`:
    a plane, boxes and spheres) with the flagship's camera and passes. Each
    body is drawn by its shape in the physics state: a box as a cube of its
    half extent, a sphere as a LOD chain of BENCH_SPHERE_LODS (144 and 36
    triangles at the bench's radius) switching at the BENCH_LOD_QUANTILE
    quantile of the sphere centres' distances from the camera, so that both
    levels draw."""
    phys, pcfg, present = scenes.bench_world(device, n_bodies)
    side = scenes.BENCH_SIDE
    constants = _flagship_camera(side, width, height, device)
    body_shape = phys["bodies"]["shape"][:n_bodies].long()
    kinds = phys["shapes"]["type"][body_shape].cpu().numpy()
    sizes = phys["shapes"]["params"][body_shape][:, 0].cpu().numpy()
    if kinds[0] != psh.PLANE or not np.isin(kinds[1:], (psh.BOX, psh.SPHERE)).all():
        raise ValueError("build_bench_frame draws a plane (body 0), boxes and spheres")
    is_sphere = kinds == psh.SPHERE
    pos = phys["bodies"]["pos"][:n_bodies].cpu().numpy()
    eye = constants["camera_pos"].cpu().numpy()
    dists = np.linalg.norm(pos[is_sphere] - eye, axis=-1)
    switch = float(np.quantile(dists, BENCH_LOD_QUANTILE)) if dists.size else 0.0
    chains: Dict[Tuple[bool, float], list] = {}
    for b in range(1, n_bodies):
        key = (bool(is_sphere[b]), float(sizes[b]))
        if key not in chains:
            chains[key] = ([rmesh.uv_sphere(key[1], r, s) for r, s in BENCH_SPHERE_LODS]
                           if key[0] else [rmesh.cube(key[1])])
    body_chains = [chains[(bool(is_sphere[b]), float(sizes[b]))]
                   for b in range(1, n_bodies)]
    ground = rmesh.plane_grid(max(side * 2.0, 20.0), 4)
    rcfg = _render_config(
        width, height, tile_size,
        sum(m.vertex_count for c in body_chains for m in c) + ground.vertex_count,
        sum(m.triangle_count for c in body_chains for m in c) + ground.triangle_count,
        n_bodies, cfg_overrides)
    scene = rmesh.SceneBuffers(rcfg.max_vertices, rcfg.max_triangles, rcfg.max_instances)
    box_mat = scene.add_material(BOX_MATERIAL)
    sph_mat = scene.add_material(rmesh.Material(base_color=(0.2, 0.4, 0.8), roughness=0.3))
    scene.add_instance(ground, material=scene.add_material(
        rmesh.Material(base_color=(0.5, 0.5, 0.5))))
    for chain in body_chains:
        if len(chain) > 1:
            scene.add_instance_lods(chain, [switch], material=sph_mat)
        else:
            scene.add_instance(chain[0], material=box_mat)
    return _combined_step(phys, pcfg, present, rcfg, scene, constants, device)


# the engine frame's extra entities (build_engine_frame's defaults)
N_CHARACTERS, N_ANIMATED = 8, 64
ENGINE_DT = 1.0 / 60.0
UI_SYSTEMS = (ui.UiTransformSystem, ui.UiButtonSystem, ui.UiCheckboxSystem,
              ui.UiLabelSystem, ui.UiInputSystem, ui.UiScissorSystem, ui.UiTriggerSystem)


class EngineFrame:
    """An Engine and a deferred renderer over its entities. `state` is the
    engine's state, the renderer's frame state under "frame". Its parts are
    exposed so callers can time or inspect each stage; each runs in a span
    of its name (`tick`, `instance_matrices`, `render`), the whole frame in
    the span `step`, as `CombinedStep`'s do."""

    def __init__(self, engine: Engine, renderer: DeferredRenderer,
                 scene: Dict[str, torch.Tensor], constants: Dict[str, torch.Tensor],
                 n_instances: int, font: rtext.FontAtlas, hud_batch: rsprites.SpriteBatch):
        self.engine = engine
        self.renderer = renderer
        self.scene = scene
        self.constants = constants
        self.n_instances = n_instances
        self.font = font
        self.hud_batch = hud_batch
        self.engine_step = engine.build_step()
        self.ui_atlas = font.atlas.device(engine.device)
        self.ui_sprites = self.emit_hud()

    def emit_hud(self) -> Dict[str, Any]:
        """The UI systems' sprites (labels, then the input boxes) on the
        device; run again after the widgets change."""
        w = self.engine.world
        size = (float(self.renderer.width), float(self.renderer.height))
        self.hud_batch.clear()
        w.systems["UiLabelSystem"].emit(self.hud_batch, self.font, size)
        w.systems["UiInputSystem"].emit(self.hud_batch, self.font, size)
        return self.hud_batch.device_arrays(self.engine.device)

    def tick(self, state: Dict[str, Any], delta_time: float) -> Dict[str, Any]:
        """One Engine step (Input, Update, Output)."""
        with profiler.span("tick"):
            return self.engine_step(state, delta_time)

    def instance_matrices(self, state: Dict[str, Any]) -> torch.Tensor:
        """The baked world matrices of entities 0 .. n_instances - 1."""
        with profiler.span("instance_matrices"):
            return bake_world_matrices(state["components"]["transform"])[:self.n_instances]

    def render(self, inst_mats: torch.Tensor, frame: Dict[str, torch.Tensor]
               ) -> Dict[str, Any]:
        with profiler.span("render"):
            return self.renderer.render(self.scene, inst_mats, self.constants, frame,
                                        ui_atlas=self.ui_atlas, ui_sprites=self.ui_sprites)

    def __call__(self, state: Dict[str, Any]) -> Tuple[Dict[str, Any], torch.Tensor]:
        with profiler.span("step"):
            state = self.tick(state, ENGINE_DT)
            out = self.render(self.instance_matrices(state), state["frame"])
        return dict(state, frame=out["frame_state"]), out["image"]


def _engine_pile(engine: Engine, n_bodies: int) -> int:
    """The flagship pile as entities 0 .. n_bodies - 1: a static plane, then
    boxes on flagship_world's lattice, entity i on body i. -> the side."""
    w = engine.world
    phys = w.systems["PhysicsSystem"]
    shapes = phys.physics.shapes
    e = w.create_entity()
    w.add_component(e, "transform")
    phys.add_rigidbody(e, shapes.plane((0, 1, 0), 0.0), motion=pw.STATIC)
    box = shapes.box((0.45, 0.45, 0.45))
    n_dyn = n_bodies - 1
    side = _pile_side(n_bodies)
    for k in range(n_dyn):
        iy, iz, ix = k // (side * side), k // side % side, k % side
        e = w.create_entity()
        w.add_component(e, "transform", position=(ix * 1.05 - side / 2, 0.5 + iy * 1.05,
                                                  iz * 1.05 - side / 2))
        phys.add_rigidbody(e, box, friction=0.5)
    return side


def _engine_actors(engine: Engine, side: int, n_characters: int, n_animated: int
                   ) -> None:
    """Characters walking on the plane in front of the pile (linked and
    tagged), entities on named animation tracks (the first one also a
    camera whose fov_y follows a property curve) and one spawner with a
    one-shot prefab, spawned now."""
    w = engine.world
    rng = np.random.default_rng(0)
    chars, link = w.systems["CharacterSystem"], w.systems["LinkSystem"]
    for c in range(n_characters):
        e = w.create_entity()
        w.add_component(e, "transform", position=(
            (c - (n_characters - 1) / 2) * 1.5, 0.95, side * 0.5 + 3.0))
        chars.add_character(e)
        walk = 1.5 if c % 2 == 0 else -1.5
        w.set_component(e, "character", desired_vel=(walk, 0.0, 0.0))
        link.add_link(e, uuid=f"{c:032x}", tag="character")
    anim = w.systems["AnimationSystem"]
    for a in range(n_animated):
        e = w.create_entity()
        w.add_component(e, "transform")
        keys = []
        for k in range(4):
            axis = rng.normal(size=3)
            angle = rng.uniform(0.0, np.pi)
            quat = np.append(axis / np.linalg.norm(axis) * np.sin(angle / 2), np.cos(angle / 2))
            keys.append({"time": 0.5 * k, "position": rng.uniform(-20.0, 20.0, 3).tolist(),
                         "rotation": quat.tolist()})
        track = anim.add_track(keys, name=f"orbit_{a}")
        w.add_component(e, "animation", track=track, looped=True,
                        speed=float(rng.uniform(0.5, 1.5)))
        if a == 0:
            w.add_component(e, "camera")
            anim.add_property_keyframes(track, "camera", "fov_y", [
                {"time": 0.0, "value": 0.8}, {"time": 1.5, "value": 1.1}])
    spawner = w.systems["SpawnerSystem"]

    def prefab(world, owner):
        child = world.create_entity()
        world.add_component(child, "transform",
                            position=world._stores["transform"]["position"][owner])
        return child

    spawner.register_prefab("marker", prefab)
    e = w.create_entity()
    w.add_component(e, "transform", position=(0.0, 2.0, side * 0.5 + 6.0))
    spawner.add_spawner(e, "marker")
    spawner.process(0.0)


def _engine_hud(engine: Engine, width: int, height: int) -> None:
    """Labels, two buttons (labelled), a checkbox (labelled) and an input
    box, then a click that focuses the input box and typed text."""
    w = engine.world
    labels, inputs = w.systems["UiLabelSystem"], w.systems["UiInputSystem"]

    def widget(x, y, size, *components, text=None, anchor=ui.ANCHOR_TOP_LEFT):
        e = w.create_entity()
        w.add_component(e, "ui_transform", position=(x, y), size=size, anchor=anchor)
        for name in components:
            w.add_component(e, name)
        if text is not None:
            w.add_component(e, "ui_label", color=(1.0, 1.0, 0.8, 1.0))
            labels.set_text(e, text)
        return e

    widget(12.0, 10.0, (240.0, 20.0), text="garden-tpu engine frame")
    widget(-12.0, 10.0, (200.0, 20.0), text="bodies, characters, tracks",
           anchor=ui.ANCHOR_TOP_RIGHT)
    widget(12.0, -70.0, (96.0, 24.0), "ui_button", text="Pause", anchor=ui.ANCHOR_BOTTOM_LEFT)
    widget(120.0, -70.0, (96.0, 24.0), "ui_button", text="Reset", anchor=ui.ANCHOR_BOTTOM_LEFT)
    widget(228.0, -70.0, (120.0, 24.0), "ui_button", "ui_checkbox", text="[x] Shadows",
           anchor=ui.ANCHOR_BOTTOM_LEFT)
    box = widget(12.0, -36.0, (260.0, 24.0), "ui_input", anchor=ui.ANCHOR_BOTTOM_LEFT)
    inputs.set_text(box, "spawn ")
    rect = ui.resolve_rects(w._stores["ui_transform"], float(width), float(height))[box]
    inputs.process_click((float(rect[0]) + 4.0, float(rect[1]) + 4.0),
                         (float(width), float(height)))
    inputs.process_text("crate")


def build_engine_frame(n_bodies: int, width: int, height: int, grid_dim: int = 64,
                       cfg_overrides: Optional[dict] = None, *, device,
                       n_characters: int = N_CHARACTERS, n_animated: int = N_ANIMATED
                       ) -> Tuple[EngineFrame, Dict[str, Any]]:
    """The engine frame and its initial state on `device`: the flagship pile
    of n_bodies as entities, n_characters characters, n_animated animated
    entities, a spawner, a link registry and the HUD, drawn by the
    flagship's renderer (then `cfg_overrides`) at width x height."""
    n_dyn = n_bodies - 1
    cube_mesh = rmesh.cube(0.45)
    side = max(int(round(n_dyn ** (1.0 / 3.0))), 1)
    ground = rmesh.plane_grid(max(side * 2.0, 20.0), 4)
    rcfg = _render_config(
        width, height, 128,
        n_dyn * cube_mesh.vertex_count + ground.vertex_count,
        n_dyn * cube_mesh.triangle_count + ground.triangle_count, n_bodies,
        cfg_overrides)
    pcfg = PhysicsConfig(max_bodies=n_bodies + n_characters, grid_dim=grid_dim,
                         cell_size=2.0, max_contacts_per_body=7, solver_iterations=8,
                         max_globals=1, max_active_contacts=16)
    n_ui = 6
    capacity = n_bodies + n_characters + n_animated + 2 + n_ui
    engine = Engine(EngineConfig(capacity=capacity, physics=pcfg, render=rcfg), device=device)
    for system in (TransformSystem(), CameraSystem(), PhysicsSystem(pcfg), CharacterSystem(),
                   AnimationSystem(max_tracks=max(n_animated, 1), max_keyframes=8),
                   SpawnerSystem(), LinkSystem(), *(cls() for cls in UI_SYSTEMS)):
        engine.create_system(system)
    anim = engine.world.systems["AnimationSystem"]
    engine.register_state("animation_tracks", anim.device_state)
    engine.initialize()
    _engine_pile(engine, n_bodies)
    _engine_actors(engine, side, n_characters, n_animated)
    _engine_hud(engine, width, height)

    scene = rmesh.SceneBuffers(rcfg.max_vertices, rcfg.max_triangles, rcfg.max_instances)
    mat = scene.add_material(BOX_MATERIAL)
    scene.add_instance(ground, material=scene.add_material(
        rmesh.Material(base_color=(0.5, 0.5, 0.5))))
    for _ in range(n_dyn):
        scene.add_instance(cube_mesh, material=mat)
    renderer = DeferredRenderer(rcfg, scene, device)
    engine.register_state("frame", renderer.initial_frame_state)
    font = rtext.FontAtlas.load_glyphs(rsprites.TextureAtlas(256))
    frame = EngineFrame(engine, renderer, renderer.device_scene(),
                        _flagship_camera(side, width, height, device), n_bodies, font,
                        rsprites.SpriteBatch(font.atlas, capacity=256))
    return frame, engine.device_state()
