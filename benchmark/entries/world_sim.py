"""Entry `world_sim`: `garden_tpu_torch.entry.CombinedStep.__call__` once a
step, one world on one device, for the combined world sim.

The program's step is `entry.build` at the configuration file's sizes, with
its render switches passed as overrides (clouds, trans-depth, the split
shadow atlas), its material rotation as `box_materials` and its camera as
`camera`, the bodies moved to the seeded positions. It is stepped, timed
and checked as `combined_step` does (`combined_step.Runner`); the check
rebuilds the scene in the reference's `world_sim.WorldSim` in place of
the flagship's.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional

import torch

from benchmark import check, inputs
from benchmark.entries import combined_step
from benchmark.entries._shared import bf16_rounded, precision, require_physics_config
from benchmark.reference import world_sim as ref_world_sim


def require_cloud_layer(cfg: Dict[str, Any]) -> None:
    """Raise unless the program's cloud march takes the file's layer: its
    base, top, coverage and step count are `render_clouds`' defaults."""
    from garden_tpu_torch.render import clouds
    have = {k: p.default for k, p in inspect.signature(clouds.render_clouds).parameters.items()}
    off = {k: (have.get(k), v) for k, v in cfg["clouds"].items() if have.get(k) != v}
    if off:
        raise ValueError(f"the program's cloud layer departs from the file's: {off}")


def materials(cfg: Dict[str, Any]) -> tuple:
    """The file's material rotation as the program's Materials."""
    from garden_tpu_torch.render.mesh import Material
    return tuple(Material(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})
                 for m in cfg["materials"])


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
    tile = render.pop("tile_size")
    cam = cfg["camera"]
    step, state = entry.build(cfg["n_bodies"], cfg["width"], cfg["height"],
                              grid_dim=cfg["physics"]["grid_dim"],
                              cell_size=cfg["physics"]["cell_size"], tile_size=tile,
                              cfg_overrides=render, device=device, box_materials=materials(cfg),
                              camera=(cam["eye"], cam["target"]))
    require_physics_config(step.pcfg, cfg)
    require_cloud_layer(cfg)
    pos = inputs.positions(cfg, seed, 0, device)
    state = dict(state, physics=inputs.with_positions(state["physics"], pos))
    return Runner(step, state, cfg, pos, device)


class Runner(combined_step.Runner):
    """`combined_step.Runner`, checked against the world sim's reference."""

    def check(self, initial, kept, mode: Optional[str] = None) -> List[Dict[str, float]]:
        """The numbers of each kept step: the program's output against the
        reference's (`world_sim.WorldSim`) from the program's input; with
        `mode`, the control (the reference in that precision) in the
        program's place."""
        with precision(None):
            ref = ref_world_sim.WorldSim(self.cfg, self.positions.cpu().numpy(), self.device)
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
