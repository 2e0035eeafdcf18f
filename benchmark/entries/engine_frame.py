"""Entry `engine_frame`: `garden_tpu_torch.entry.EngineFrame.__call__` once a
step, one game instance on one device: the Engine's tick (Input, Update,
Output), the bake of the world matrices and the flagship's deferred frame
with the HUD.

The program is `entry.build_engine_frame` at the configuration file's
sizes and entity counts, its render block passed as overrides; the entry
raises unless the program's physics configuration, tick, render block and
entity counts are the file's. The seeded positions go into the pile's
bodies and their transform rows (entity i is body i); then the file's
layout: the pile's last boxes become its static steps and the characters
start at its positions (`engine_frame.step_positions`,
`character_positions`). It is stepped as
`combined_step` does; `spans(n)` times the tick and the render. The check
rebuilds the engine frame in the reference (`engine_frame.EngineFrame`),
holds the program's initial state, camera and HUD to it leaf by leaf, and
then follows the program from its own input of each kept step: one
reference engine frame, whose body state, baked matrices, image, live
transform rows and character flags are compared with the program's.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark import check, inputs
from benchmark.entries import combined_step
from benchmark.entries._shared import bf16_rounded, precision
from benchmark.reference import engine_frame as ref_engine


def require_engine(frame, cfg: Dict[str, Any]) -> None:
    """Raise unless the program holds the file's physics configuration,
    tick, render block and entity counts, with entity i on body i."""
    from garden_tpu_torch import entry
    from garden_tpu_torch.physics import world as pw
    w = frame.engine.world
    stores = w._stores
    rcfg = dataclasses.asdict(frame.renderer.config)
    want_render = dict(cfg["render"], shadow=None)
    hud = cfg["hud"]
    n = cfg["n_bodies"]
    bodies = w.systems["PhysicsSystem"].physics._b
    have = {
        "physics": dataclasses.asdict(w.systems["PhysicsSystem"].config),
        "dt": entry.ENGINE_DT,
        "max_steps_per_tick":
            inspect.signature(pw.simulate).parameters["max_steps_per_tick"].default,
        "render": dict({k: rcfg[k] for k in cfg["render"]}, shadow=None),
        "shadow": {k: rcfg["shadow"][k] for k in cfg["render"]["shadow"]},
        "capacity": w.capacity,
        "characters": int(stores["character"]["has"].sum()),
        "animated": int(stores["animation"]["has"].sum()),
        "spawners": int(stores["spawner"]["has"].sum()),
        "widgets": int(stores["ui_transform"]["has"].sum()),
        "pile_entities": bool((bodies["entity"][:n] == np.arange(n)).all()),
    }
    want = {
        "physics": dict(have["physics"], **cfg["physics"]),
        "dt": cfg["engine"]["dt"],
        "max_steps_per_tick": cfg["engine"]["max_steps_per_tick"],
        "render": want_render,
        "shadow": combined_step._shadow(cfg["render"]["shadow"]),
        "capacity": ref_engine.capacity(cfg),
        "characters": cfg["characters"]["count"],
        "animated": cfg["animated"]["count"],
        "spawners": cfg["spawner"]["count"],
        "widgets": len(hud["labels"]) + len(hud["buttons"]) + 1,
        "pile_entities": True,
    }
    off = {k: (have[k], v) for k, v in want.items() if have[k] != v}
    if off:
        raise ValueError(f"the program's engine frame departs from the file's: {off}")


def with_positions(state: Dict[str, Any], pos: torch.Tensor) -> Dict[str, Any]:
    """An engine state whose first len(pos) bodies (and their previous
    poses) and transform rows start at `pos`; the rest keep theirs."""
    n = pos.shape[0]
    phys = state["physics"]
    bodies = phys["bodies"]
    phys = dict(phys, bodies=dict(bodies, pos=torch.cat([pos, bodies["pos"][n:]])),
                prev_pos=torch.cat([pos, phys["prev_pos"][n:]]))
    tf = state["components"]["transform"]
    tf = dict(tf, position=torch.cat([pos, tf["position"][n:]]))
    return dict(state, physics=phys, components=dict(state["components"], transform=tf))


def with_layout(state: Dict[str, Any], cfg: Dict[str, Any]) -> Dict[str, Any]:
    """An engine state in the file's layout: the pile's last boxes static at
    the steps' positions, the characters at theirs (bodies, previous poses
    and transform rows), as the reference builds them."""
    from garden_tpu_torch.physics import world as pw
    phys, comps = state["physics"], state["components"]
    b = phys["bodies"]
    device = b["pos"].device
    n = cfg["n_bodies"]
    steps = torch.as_tensor(ref_engine.step_positions(cfg), device=device)
    walkers = torch.as_tensor(ref_engine.character_positions(cfg), device=device)
    step_rows = torch.arange(n - len(steps), n, device=device)
    chars = torch.nonzero(comps["character"]["has"]).squeeze(-1)
    rows = torch.cat([step_rows, comps["character"]["body"][chars].long()])
    ents = torch.cat([step_rows, chars])
    at = torch.cat([steps, walkers])
    bodies = dict(b, pos=b["pos"].index_copy(0, rows, at),
                  motion=b["motion"].index_fill(0, step_rows, pw.STATIC),
                  layer=b["layer"].index_fill(0, step_rows, pw.LAYER_NON_MOVING),
                  inv_mass=b["inv_mass"].index_fill(0, step_rows, 0.0),
                  inv_inertia=b["inv_inertia"].index_fill(0, step_rows, 0.0))
    phys = dict(phys, bodies=bodies, prev_pos=phys["prev_pos"].index_copy(0, rows, at))
    tf = comps["transform"]
    tf = dict(tf, position=tf["position"].index_copy(0, ents, at))
    return dict(state, physics=phys, components=dict(comps, transform=tf))


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, devices: List):
    from garden_tpu_torch import cuda_build, entry
    from garden_tpu_torch.core.config import ShadowConfig
    device = devices[0]
    if device.type == "cuda":
        names = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
        cuda_build.build_all(names)
        for n in names:
            cuda_build.load(n)
    render = dict(cfg["render"],
                  shadow=ShadowConfig(**combined_step._shadow(cfg["render"]["shadow"])))
    render.pop("tile_size")
    frame, state = entry.build_engine_frame(
        cfg["n_bodies"], cfg["width"], cfg["height"], grid_dim=cfg["physics"]["grid_dim"],
        cfg_overrides=render, device=device, n_characters=cfg["characters"]["count"],
        n_animated=cfg["animated"]["count"])
    require_engine(frame, cfg)
    pos = inputs.positions(cfg, seed, 0, device)
    return Runner(frame, with_layout(with_positions(state, pos), cfg), cfg, pos, device)


def transform_gap(prog: Dict[str, Any], ref: Dict[str, Any]) -> float:
    """The widest gap, in m, of the positions of the live transform rows."""
    tf = ref["components"]["transform"]
    live = ref["entities"]["alive"] & tf["has"]
    got = prog["components"]["transform"]["position"][live]
    return float(torch.max(torch.abs(got.double() - tf["position"][live].double())))


def character_flags(prog: Dict[str, Any], ref: Dict[str, Any]) -> float:
    """How many characters' grounded flag or jump impulse differ."""
    a, b = prog["components"]["character"], ref["components"]["character"]
    bad = (a["grounded"] != b["grounded"]) | (a["jump_impulse"] != b["jump_impulse"])
    return float((bad & b["has"]).sum())


class Runner(combined_step.Runner):
    """`combined_step.Runner` over the engine frame."""

    def spans(self, n: int) -> Dict[str, List[float]]:
        """n steps stage by stage, the device synchronized around each
        stage: host ms of EngineFrame.tick and of EngineFrame.render."""
        out: Dict[str, List[float]] = {"tick": [], "render": []}
        state = self.state
        for _ in range(n):
            combined_step._sync(self.device)
            t0 = time.perf_counter()
            state = self.fn.tick(state, self.cfg["engine"]["dt"])
            combined_step._sync(self.device)
            t1 = time.perf_counter()
            mats = self.fn.instance_matrices(state)
            combined_step._sync(self.device)
            t2 = time.perf_counter()
            frame = self.fn.render(mats, state["frame"])
            combined_step._sync(self.device)
            t3 = time.perf_counter()
            out["tick"].append((t1 - t0) * 1e3)
            out["render"].append((t3 - t2) * 1e3)
            state = dict(state, frame=frame["frame_state"])
        self.state = state
        return out

    def check(self, initial, kept, mode: Optional[str] = None) -> List[Dict[str, float]]:
        """The numbers of each kept step: the program's output against the
        reference's (`engine_frame.EngineFrame`) from the program's input;
        with `mode`, the control (the reference in that precision) in the
        program's place."""
        with precision(None):
            ref = ref_engine.EngineFrame(self.cfg, self.positions.cpu().numpy(), self.device)
        start = (check.differing_leaves(initial, ref.state0)
                 + check.differing_leaves(self.fn.constants, ref.constants)
                 + check.differing_leaves(self.fn.ui_sprites, ref.ui_sprites)
                 + check.differing_leaves(self.fn.ui_atlas, ref.ui_atlas))
        out = []
        for prev, nxt, image in kept:
            with precision(None):
                r_state, r_mats, r_img = ref(prev)
            if mode is None:
                mats = self.fn.instance_matrices(nxt)
                got_state, got_img = nxt, image
            else:
                src = bf16_rounded(prev) if mode == "bf16" else prev
                with precision(mode):
                    got_state, mats, got_img = ref(src)
            nums = check.physics_gaps(got_state["physics"], r_state["physics"])
            nums["mats"] = float(torch.max(torch.abs(mats - r_mats)))
            nums["image_levels"] = check.image_gap(got_img, r_img)
            nums["transform_m"] = transform_gap(got_state, r_state)
            nums["character_flags"] = character_flags(got_state, r_state)
            nums["start_leaves"] = float(start)
            out.append(nums)
        return out
