"""The world-batch case shared by the port's world tests
(tests/test_torch_worlds.py, tests/test_torch_multichip.py): the
reference test's world (tests/test_parallel.py: a plane and one sphere at
y=3, 16 body slots), world i lifted 0.1 i m, stepped at 60 Hz, on the JAX
package's `WorldBatch` and on the port's."""

import jax
import jax.numpy as jnp
import torch

from garden_tpu.core.config import PhysicsConfig as JPhysicsConfig
from garden_tpu.parallel.worlds import WorldBatch as JWorldBatch
from garden_tpu.physics import world as jpw
from garden_tpu_torch.core.config import PhysicsConfig
from garden_tpu_torch.physics import world as tpw

DT = 1.0 / 60.0


def world(pw, cfg_cls):
    """tests/test_parallel.py's world: a plane and one sphere, 16 slots."""
    cfg = cfg_cls(max_bodies=16, grid_dim=8)
    w = pw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=pw.STATIC)
    w.add_body(w.shapes.sphere(0.5), position=(0, 3, 0))
    return w, cfg, w.shapes.present_types()


def lift(s, i):
    """World i starts 0.1 * i higher (the reference test's vary_fn)."""
    b = s["bodies"]
    at = torch.zeros(b["pos"].shape, dtype=torch.bool)
    at[1, 1] = True
    pos = torch.where(at, b["pos"] + 0.1 * i.float(), b["pos"])
    return dict(s, bodies=dict(b, pos=pos))


def port_world():
    """(the port's world state on the CPU, its step)."""
    w, cfg, types = world(tpw, PhysicsConfig)
    return w.device_state("cpu"), lambda s: tpw.step(s, cfg, DT, types)


def jax_batch(n_worlds: int, steps: int, devices=None):
    """JAX's WorldBatch of n_worlds lifted worlds over `devices` (default:
    every JAX device), stepped `steps` times, on the host."""
    w, cfg, types = world(jpw, JPhysicsConfig)
    wb = JWorldBatch(lambda s: jpw.step(s, cfg, DT, types), n_worlds=n_worlds,
                     devices=devices)

    def vary(s, i):
        b = s["bodies"]
        return dict(s, bodies=dict(b, pos=b["pos"].at[1, 1].add(0.1 * i.astype(jnp.float32))))

    batched = wb.replicate(w.device_state(), vary_fn=vary)
    for _ in range(steps):
        batched = wb.step(batched)
    return jax.device_get(batched)


def leaves(tree, path=""):
    """(key path, leaf) of a nest of dicts, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]
