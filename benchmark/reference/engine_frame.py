"""The runtime's frame, rebuilt by the reference: an Engine of the ECS
systems over the flagship's pile, characters, animated entities, a
spawner, links and a HUD, stepped once (Input, Update, Output), its world
matrices baked and the flagship's deferred frame drawn with the HUD on top,
as `garden_tpu_torch.entry.build_engine_frame` and `EngineFrame` do. The
file's layout, which the benchmark's entry puts into the program's state:
the pile's last boxes are static steps 0.3 m high, one between each pair
of characters, and each character starts its own gap short of its step,
so that walk-stairs lifts it, at a tick of its own, within the first steps
the check compares.

Built from the configuration file and the seeded positions alone, in
float32 (the caller turns TF32 off). The frozen copies it adds to the
reference, each the port's file with the package renamed: `engine.py`,
`core/ecs.py`, `systems/` (transform, camera, physics, character,
animation, spawner, link, ui), `physics/queries.py`, `render/text.py` and
its glyph file `render/glyphs_default.npz`. One edit: `engine.py` marks
each subscriber with a `torch.profiler` range in place of the port's span,
and has no NaN guards (`utils/` is not copied).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from benchmark.reference import scenes
from benchmark.reference.core.config import EngineConfig, PhysicsConfig
from benchmark.reference.engine import Engine
from benchmark.reference.physics import world as pw
from benchmark.reference.render import mesh as rmesh
from benchmark.reference.render import sprites as rsprites
from benchmark.reference.render import text as rtext
from benchmark.reference.render.deferred import DeferredRenderer
from benchmark.reference.systems import ui
from benchmark.reference.systems.animation import AnimationSystem
from benchmark.reference.systems.camera import CameraSystem
from benchmark.reference.systems.character import CharacterSystem
from benchmark.reference.systems.link import LinkSystem
from benchmark.reference.systems.physics import PhysicsSystem
from benchmark.reference.systems.spawner import SpawnerSystem
from benchmark.reference.systems.transform import TransformSystem, bake_world_matrices

REFERENCE = Path(__file__).resolve().parent
ANCHORS = {"top_left": ui.ANCHOR_TOP_LEFT, "center": ui.ANCHOR_CENTER,
           "top_right": ui.ANCHOR_TOP_RIGHT, "bottom_left": ui.ANCHOR_BOTTOM_LEFT,
           "bottom_right": ui.ANCHOR_BOTTOM_RIGHT}
UI_SYSTEMS = (ui.UiTransformSystem, ui.UiButtonSystem, ui.UiCheckboxSystem,
              ui.UiLabelSystem, ui.UiInputSystem, ui.UiScissorSystem, ui.UiTriggerSystem)


def capacity(cfg: Dict[str, Any]) -> int:
    """The entity capacity: the pile, the characters, the animated entities,
    each spawner and its one-shot child, and the HUD's widgets."""
    hud = cfg["hud"]
    return (cfg["n_bodies"] + cfg["characters"]["count"] + cfg["animated"]["count"]
            + 2 * cfg["spawner"]["count"] + len(hud["labels"]) + len(hud["buttons"]) + 1)


def step_positions(cfg: Dict[str, Any]) -> np.ndarray:
    """(pairs, 3): the centres of the static steps, one between the start
    slots of each pair of characters, its top `top_m` over the plane, on the
    characters' line."""
    ch, st = cfg["characters"], cfg["steps"]
    n = ch["count"]
    if n != 2 * st["count"]:
        raise ValueError(f"{st['count']} steps for {n} characters: one a pair")
    x = (2 * np.arange(st["count"]) + 0.5 - (n - 1) / 2) * ch["spacing"]
    y = st["top_m"] - cfg["bodies"]["half_extent"]
    z = cfg["bodies"]["lattice"]["side"] * 0.5 + ch["z_past_pile"]
    return np.stack([x, np.full_like(x, y), np.full_like(x, z)], -1).astype(np.float32)


def character_positions(cfg: Dict[str, Any]) -> np.ndarray:
    """(characters, 3): character c starts `gap_m[c]` short of its pair's
    step, the even one of the pair on the step's -x side (it walks +x), the
    odd one on its +x side."""
    ch = cfg["characters"]
    steps = step_positions(cfg)
    c = np.arange(ch["count"])
    side = np.where(c % 2 == 0, -1.0, 1.0)
    reach = cfg["bodies"]["half_extent"] + ch["radius"] + np.asarray(ch["gap_m"])[c]
    x = steps[c // 2, 0] + side * reach
    return np.stack([x, np.full_like(x, ch["y"]), steps[c // 2, 2]],
                    -1).astype(np.float32)


def _pile(engine: Engine, cfg: Dict[str, Any], positions: np.ndarray) -> None:
    """Entity 0 the static plane, entity i the box on body i at positions[i];
    the last boxes are the static steps, at `step_positions`."""
    w = engine.world
    phys = w.systems["PhysicsSystem"]
    shapes = phys.physics.shapes
    e = w.create_entity()
    w.add_component(e, "transform")
    phys.add_rigidbody(e, shapes.plane((0.0, 1.0, 0.0), 0.0), motion=pw.STATIC)
    b = cfg["bodies"]
    half = b["half_extent"]
    box = shapes.box((half, half, half))
    steps = step_positions(cfg)
    free = len(positions) - len(steps)
    for i, p in enumerate(np.concatenate([positions[1:free], steps]), 1):
        e = w.create_entity()
        w.add_component(e, "transform", position=tuple(float(c) for c in p))
        phys.add_rigidbody(e, box, friction=b["friction"],
                           motion=pw.DYNAMIC if i < free else pw.STATIC)


def _actors(engine: Engine, cfg: Dict[str, Any]) -> None:
    """The characters (linked and tagged) at `character_positions`, the
    animated entities and the spawner with its one-shot child, spawned
    now."""
    w = engine.world
    side = cfg["bodies"]["lattice"]["side"]
    ch = cfg["characters"]
    chars, link = w.systems["CharacterSystem"], w.systems["LinkSystem"]
    for c, p in enumerate(character_positions(cfg)):
        e = w.create_entity()
        w.add_component(e, "transform", position=tuple(float(v) for v in p))
        chars.add_character(e, radius=ch["radius"], half_height=ch["half_height"],
                            mass=ch["mass"], step_height=ch["step_height"],
                            stick_distance=ch["stick_distance"])
        walk = ch["walk_mps"] if c % 2 == 0 else -ch["walk_mps"]
        w.set_component(e, "character", desired_vel=(walk, 0.0, 0.0))
        link.add_link(e, uuid=f"{c:032x}", tag="character")

    an = cfg["animated"]
    rng = np.random.default_rng(an["rng_seed"])
    anim = w.systems["AnimationSystem"]
    for a in range(an["count"]):
        e = w.create_entity()
        w.add_component(e, "transform")
        keys = []
        for k in range(an["keys"]):
            axis = rng.normal(size=3)
            angle = rng.uniform(0.0, np.pi)
            quat = np.append(axis / np.linalg.norm(axis) * np.sin(angle / 2), np.cos(angle / 2))
            keys.append({"time": an["key_s"] * k,
                         "position": rng.uniform(*an["position_m"], 3).tolist(),
                         "rotation": quat.tolist()})
        track = anim.add_track(keys, name=f"orbit_{a}")
        w.add_component(e, "animation", track=track, looped=an["looped"],
                        speed=float(rng.uniform(*an["speed"])))
        if a == 0:
            w.add_component(e, "camera")
            anim.add_property_keyframes(track, "camera", "fov_y", an["fov_curve"])

    sp = cfg["spawner"]
    spawner = w.systems["SpawnerSystem"]

    def prefab(world, owner):
        child = world.create_entity()
        world.add_component(child, "transform",
                            position=world._stores["transform"]["position"][owner])
        return child

    spawner.register_prefab("marker", prefab)
    for _ in range(sp["count"]):
        e = w.create_entity()
        x, y = sp["position"]
        w.add_component(e, "transform", position=(x, y, side * 0.5 + sp["z_past_pile"]))
        spawner.add_spawner(e, "marker")
    spawner.process(0.0)


def _hud(engine: Engine, cfg: Dict[str, Any]) -> None:
    """The labels, the buttons (a checkbox among them) and the input box,
    then a click that focuses the input box and the text typed into it."""
    w = engine.world
    hud = cfg["hud"]
    labels, inputs = w.systems["UiLabelSystem"], w.systems["UiInputSystem"]

    def widget(spec, *components):
        e = w.create_entity()
        w.add_component(e, "ui_transform", position=tuple(spec["position"]),
                        size=tuple(spec["size"]), anchor=ANCHORS[spec["anchor"]])
        for name in components:
            w.add_component(e, name)
        return e

    def labelled(e, text):
        w.add_component(e, "ui_label", color=tuple(hud["label_color"]))
        labels.set_text(e, text)

    for spec in hud["labels"]:
        labelled(widget(spec), spec["text"])
    for spec in hud["buttons"]:
        names = ("ui_button", "ui_checkbox") if spec.get("checkbox") else ("ui_button",)
        labelled(widget(spec, *names), spec["text"])
    box_spec = hud["input"]
    box = widget(box_spec, "ui_input")
    inputs.set_text(box, box_spec["text"])
    size = (float(cfg["width"]), float(cfg["height"]))
    rect = ui.resolve_rects(w._stores["ui_transform"], *size)[box]
    cx, cy = box_spec["click_at"]
    inputs.process_click((float(rect[0]) + cx, float(rect[1]) + cy), size)
    inputs.process_text(box_spec["typed"])


class EngineFrame:
    """The engine frame: `tick`, `instance_matrices` and the frame with its
    HUD; `state0` the engine's initial state, `constants` the camera's,
    `ui_atlas` and `ui_sprites` the HUD the frame composites."""

    def __init__(self, cfg: Dict[str, Any], positions: np.ndarray, device):
        pcfg = PhysicsConfig(**cfg["physics"])
        n_bodies, n_dyn = cfg["n_bodies"], cfg["n_bodies"] - 1
        side = cfg["bodies"]["lattice"]["side"]
        cube = rmesh.cube(cfg["bodies"]["half_extent"])
        ground = rmesh.plane_grid(max(side * 2.0, 20.0), 4)
        rcfg = scenes.render_config(dict(cfg, render=dict(
            cfg["render"], width=cfg["width"], height=cfg["height"],
            max_vertices=n_dyn * cube.vertex_count + ground.vertex_count,
            max_triangles=n_dyn * cube.triangle_count + ground.triangle_count,
            max_instances=n_bodies)))
        an = cfg["animated"]
        engine = Engine(EngineConfig(capacity=capacity(cfg), physics=pcfg, render=rcfg),
                        device=device)
        for system in (TransformSystem(), CameraSystem(), PhysicsSystem(pcfg),
                       CharacterSystem(),
                       AnimationSystem(max_tracks=max(an["count"], 1),
                                       max_keyframes=an["max_keyframes"]),
                       SpawnerSystem(), LinkSystem(), *(cls() for cls in UI_SYSTEMS)):
            engine.create_system(system)
        engine.register_state("animation_tracks",
                              engine.world.systems["AnimationSystem"].device_state)
        engine.initialize()
        _pile(engine, cfg, positions)
        _actors(engine, cfg)
        _hud(engine, cfg)

        scene = rmesh.SceneBuffers(rcfg.max_vertices, rcfg.max_triangles, rcfg.max_instances)
        box = scene.add_material(rmesh.Material(base_color=tuple(cfg["box_color"])))
        scene.add_instance(ground, material=scene.add_material(
            rmesh.Material(base_color=(0.5, 0.5, 0.5))))
        for _ in range(n_dyn):
            scene.add_instance(cube, material=box)
        self.renderer = DeferredRenderer(rcfg, scene, device)
        engine.register_state("frame", self.renderer.initial_frame_state)
        self.scene = self.renderer.device_scene()
        self.constants = scenes._camera(side, cfg["width"], cfg["height"], device)

        hud = cfg["hud"]
        font = rtext.FontAtlas.load_glyphs(rsprites.TextureAtlas(hud["atlas_size"]),
                                           REFERENCE / hud["glyphs"])
        self.ui_atlas = font.atlas.device(device)
        batch = rsprites.SpriteBatch(font.atlas, capacity=hud["sprite_capacity"])
        size = (float(self.renderer.width), float(self.renderer.height))
        engine.world.systems["UiLabelSystem"].emit(batch, font, size)
        engine.world.systems["UiInputSystem"].emit(batch, font, size)
        self.ui_sprites = batch.device_arrays(device)

        self.engine = engine
        self.dt = cfg["engine"]["dt"]
        self.n_instances = n_bodies
        self.engine_step = engine.build_step()
        self.state0 = engine.device_state()

    def tick(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return self.engine_step(state, self.dt)

    def instance_matrices(self, state: Dict[str, Any]) -> torch.Tensor:
        return bake_world_matrices(state["components"]["transform"])[:self.n_instances]

    def __call__(self, state: Dict[str, Any]
                 ) -> Tuple[Dict[str, Any], torch.Tensor, torch.Tensor]:
        """-> (next state, instance matrices, image)."""
        state = self.tick(state)
        mats = self.instance_matrices(state)
        out = self.renderer.render(self.scene, mats, self.constants, state["frame"],
                                   ui_atlas=self.ui_atlas, ui_sprites=self.ui_sprites)
        return dict(state, frame=out["frame_state"]), mats, out["image"]
