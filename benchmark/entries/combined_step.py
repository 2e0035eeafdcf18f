"""Entry `combined_step`: `garden_tpu_torch.entry.CombinedStep.__call__`
once a step, one world on one device.

The program's step is `entry.build` at the configuration file's sizes, its
render configuration passed as overrides, its bodies moved to the seeded
positions. The check rebuilds the world and the frame in the reference,
holds the program's initial state and its camera constants to it leaf by
leaf, and then follows the program from its own input of each kept step:
one reference step, whose body state, instance matrices and image are
compared with the program's.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from benchmark import check, inputs
from benchmark.entries._shared import precision, bf16_rounded, require_physics_config
from benchmark.reference import scenes as ref_scenes


def _shadow(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, devices: List):
    from garden_tpu_torch import cuda_build, entry
    from garden_tpu_torch.core.config import ShadowConfig
    device = devices[0]
    if device.type == "cuda":
        names = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
        cuda_build.build_all(names)
        for n in names:
            cuda_build.load(n)
    render = dict(cfg["render"], shadow=ShadowConfig(**_shadow(cfg["render"]["shadow"])))
    tile = render.pop("tile_size")
    step, state = entry.build(cfg["n_bodies"], cfg["width"], cfg["height"],
                              grid_dim=cfg["physics"]["grid_dim"],
                              cell_size=cfg["physics"]["cell_size"], tile_size=tile,
                              cfg_overrides=render, device=device)
    require_physics_config(step.pcfg, cfg)
    pos = inputs.positions(cfg, seed, 0, device)
    state = dict(state, physics=inputs.with_positions(state["physics"], pos))
    return Runner(step, state, cfg, pos, device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Runner:
    worlds = 1

    def __init__(self, fn, state, cfg, pos, device):
        self.fn, self.state, self.cfg, self.device = fn, state, cfg, device
        self.positions = pos
        self.initial = state
        self.prev = self.image = None

    def step(self) -> None:
        self.prev = self.state
        self.state, self.image = self.fn(self.state)

    def snapshot(self):
        return (self.prev, self.state, self.image)

    def spans(self, n: int) -> Dict[str, List[float]]:
        """n steps stage by stage, the device synchronized around each
        stage: host ms of CombinedStep.physics and of CombinedStep.render."""
        out: Dict[str, List[float]] = {"physics": [], "render": []}
        state = self.state
        for _ in range(n):
            _sync(self.device)
            t0 = time.perf_counter()
            phys = self.fn.physics(state["physics"])
            _sync(self.device)
            t1 = time.perf_counter()
            mats = self.fn.instance_matrices(phys)
            _sync(self.device)
            t2 = time.perf_counter()
            frame = self.fn.render(mats, state["frame"])
            _sync(self.device)
            t3 = time.perf_counter()
            out["physics"].append((t1 - t0) * 1e3)
            out["render"].append((t3 - t2) * 1e3)
            state = {"physics": phys, "frame": frame["frame_state"]}
        self.state = state
        return out

    def release(self) -> None:
        self.state = self.prev = self.image = None

    def check(self, initial, kept, mode: Optional[str] = None) -> List[Dict[str, float]]:
        """The numbers of each kept step: the program's output against the
        reference's from the program's input; with `mode`, the control (the
        reference in that precision) in the program's place."""
        ref = ref_scenes.Flagship(self.cfg, self.positions.cpu().numpy(), self.device)
        start = (check.differing_leaves(initial["physics"], ref.state0)
                 + check.differing_leaves(initial["frame"],
                                          ref.renderer.initial_frame_state())
                 + check.differing_leaves(self.fn.constants, ref.constants))
        out = []
        for prev, nxt, image in kept:
            with precision(None):
                r_state, r_mats, r_img = ref(prev)
            if mode is None:
                mats = self.fn.instance_matrices(nxt["physics"])
                got_state, got_img = nxt, image
            else:
                src = bf16_rounded(prev) if mode == "bf16" else prev
                with precision(mode):
                    got_state, mats, got_img = ref(src)
            nums = check.physics_gaps(got_state["physics"], r_state["physics"])
            nums["mats"] = float(torch.max(torch.abs(mats - r_mats)))
            nums["image_levels"] = check.image_gap(got_img, r_img)
            nums["start_leaves"] = float(start)
            out.append(nums)
        return out
