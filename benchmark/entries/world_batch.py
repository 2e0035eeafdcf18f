"""Entry `world_batch`: `garden_tpu_torch.parallel.worlds.WorldBatch.step`
over `physics.world.step`, `worlds` worlds as one shard per device.

Every world is the box stack of `entry.flagship_world` at the
configuration file's body count, its bodies at positions drawn from (seed,
world index). The check rebuilds the worlds in the reference, holds each
world's initial state to it leaf by leaf, and follows every world of each
kept step from the program's own input, on that world's own device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from torch.utils._pytree import tree_map

from benchmark import check, inputs
from benchmark.entries._shared import ref_physics_step, require_physics_config
from benchmark.reference import scenes as ref_scenes


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, devices: List):
    from garden_tpu_torch import entry
    from garden_tpu_torch.parallel.worlds import WorldBatch
    from garden_tpu_torch.physics import world as pw
    world, pcfg, _ = entry.flagship_world(cfg["n_bodies"], cfg["physics"]["grid_dim"],
                                          cfg["physics"]["cell_size"])
    base, types = world.device_state(devices[0]), world.shapes.present_types()
    require_physics_config(pcfg, cfg)
    n = traffic["worlds"]
    wb = WorldBatch(lambda s: pw.step(s, pcfg, 1.0 / 60.0, types), n, devices=devices)
    if len(wb.devices) != len(devices):
        raise ValueError(f"{n} worlds do not divide over {len(devices)} devices")
    pos = [inputs.positions(cfg, seed, w, devices[0]) for w in range(n)]
    batched = wb.stack([inputs.with_positions(base, p) for p in pos])
    return Runner(wb, batched, cfg, pos)


def _world(batched, k: int, row: int):
    return tree_map(lambda x: x[row], batched[k])


class Runner:
    def __init__(self, wb, state, cfg, pos):
        self.wb, self.state, self.cfg, self.positions = wb, state, cfg, pos
        self.worlds = wb.n_worlds
        self.initial = state
        self.prev = None

    def step(self) -> None:
        self.prev = self.state
        self.state = self.wb.step(self.state)

    def snapshot(self):
        return (self.prev, self.state)

    def spans(self, n: int) -> Dict[str, List[float]]:
        return {}

    def release(self) -> None:
        self.state = self.prev = None

    def check(self, initial, kept, mode: Optional[str] = None) -> List[Dict[str, float]]:
        """The numbers of every world of each kept step, on its own device."""
        out = []
        per = self.wb.per
        for k, dev in enumerate(self.wb.devices):
            ref0, pcfg, types = ref_scenes.physics_world(
                self.cfg, self.positions[k * per].cpu().numpy(), dev)
            for row in range(per):
                pos = self.positions[k * per + row].to(dev)
                want0 = dict(ref0, bodies=dict(ref0["bodies"], pos=pos), prev_pos=pos)
                start = float(check.differing_leaves(_world(initial, k, row), want0))
                for prev, nxt in kept:
                    inp = _world(prev, k, row)
                    want = ref_physics_step(inp, pcfg, types)
                    got = (_world(nxt, k, row) if mode is None
                           else ref_physics_step(inp, pcfg, types, mode))
                    out.append(dict(check.physics_gaps(got, want), start_leaves=start))
        return out
