"""Entry `physics_tick`: `garden_tpu_torch.entry.CombinedStep.physics` once a
step, one world on one device, nothing drawn: a dedicated server's tick.

The step is a CombinedStep over `entry.flagship_world` with no renderer,
since its physics needs none; its bodies start at the seeded positions.
The check holds the program's initial state to the reference's, leaf by
leaf, and follows the program from its own input of each kept step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from benchmark import check, inputs
from benchmark.entries._shared import ref_physics_step, require_physics_config
from benchmark.reference import scenes as ref_scenes


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, devices: List):
    from garden_tpu_torch import entry
    device = devices[0]
    world, pcfg, _ = entry.flagship_world(cfg["n_bodies"], cfg["physics"]["grid_dim"],
                                          cfg["physics"]["cell_size"])
    require_physics_config(pcfg, cfg)
    fn = entry.CombinedStep(pcfg, world.shapes.present_types(), None, None, None,
                            cfg["n_bodies"])
    pos = inputs.positions(cfg, seed, 0, device)
    return Runner(fn, inputs.with_positions(world.device_state(device), pos), cfg, pos,
                  device)


class Runner:
    worlds = 1

    def __init__(self, fn, state, cfg, pos, device):
        self.fn, self.state, self.cfg, self.device = fn, state, cfg, device
        self.positions = pos
        self.initial = state
        self.prev = None

    def step(self) -> None:
        self.prev = self.state
        self.state = self.fn.physics(self.state)

    def snapshot(self):
        return (self.prev, self.state)

    def spans(self, n: int) -> Dict[str, List[float]]:
        return {}

    def release(self) -> None:
        self.state = self.prev = None

    def check(self, initial, kept, mode: Optional[str] = None) -> List[Dict[str, float]]:
        ref0, pcfg, types = ref_scenes.physics_world(self.cfg, self.positions.cpu().numpy(),
                                                     self.device)
        start = float(check.differing_leaves(initial, ref0))
        out = []
        for prev, nxt in kept:
            want = ref_physics_step(prev, pcfg, types)
            got = nxt if mode is None else ref_physics_step(prev, pcfg, types, mode)
            out.append(dict(check.physics_gaps(got, want), start_leaves=start))
        return out
