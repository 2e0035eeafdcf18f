"""The canonical golden-trajectory scenes, built from the port.

Twin of the JAX package's `tests/golden/scenes.py` (a 1 m sphere drop, an
e = 0.5 bounce, a 5-box stack, a point-joint pendulum, a two-sphere cradle
and a box on a ramp either side of the friction cone), with its analytic
budgets (`tests/golden/test_golden.py`, the contract of
`tests/golden/README.md`) as `check`. It needs no JAX, so the card's smoke
test runs it too.

    curves = simulate("pendulum", device="cuda")
    check("pendulum", curves)        # raises AssertionError on a miss
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from garden_tpu_torch.core.config import PhysicsConfig
from garden_tpu_torch.physics import constraints as con
from garden_tpu_torch.physics import world as pw


def sphere_drop(device):
    """r = 0.5 sphere dropped from rest at y = 5 onto the ground plane."""
    cfg = PhysicsConfig(max_bodies=8, grid_dim=8)
    w = pw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=pw.STATIC)
    w.add_body(w.shapes.sphere(0.5), position=(0.0, 5.0, 0.0))
    track = {"y": lambda s: s["bodies"]["pos"][1, 1],
             "vy": lambda s: s["bodies"]["linvel"][1, 1]}
    return w.device_state(device), cfg, w.shapes.present_types(), track


def bounce_e05(device):
    """r = 0.5 sphere, restitution 0.5, dropped from y = 3."""
    cfg = PhysicsConfig(max_bodies=8, grid_dim=8)
    w = pw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=pw.STATIC)
    w.add_body(w.shapes.sphere(0.5), position=(0.0, 3.0, 0.0), restitution=0.5)
    track = {"y": lambda s: s["bodies"]["pos"][1, 1],
             "vy": lambda s: s["bodies"]["linvel"][1, 1]}
    return w.device_state(device), cfg, w.shapes.present_types(), track


def stack5(device):
    """Five 1 m boxes stacked with 1 mm gaps."""
    cfg = PhysicsConfig(max_bodies=8, grid_dim=8, solver_iterations=16)
    w = pw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=pw.STATIC)
    box = w.shapes.box((0.5, 0.5, 0.5))
    for i in range(5):
        w.add_body(box, position=(0.0, 0.501 + i * 1.001, 0.0), friction=0.6)
    track = {f"y{i}": (lambda s, i=i: s["bodies"]["pos"][1 + i, 1]) for i in range(5)}
    track["x_drift"] = lambda s: torch.amax(torch.abs(s["bodies"]["pos"][1:6, 0::2]))
    return w.device_state(device), cfg, w.shapes.present_types(), track


def pendulum(device):
    """Point-joint pendulum: 1 m arm released horizontal."""
    cfg = PhysicsConfig(max_bodies=8, grid_dim=8, solver_iterations=10)
    w = pw.PhysicsWorld(cfg)
    anchor = w.add_body(w.shapes.sphere(0.1), position=(0.0, 5.0, 0.0),
                        motion=pw.STATIC)
    bob = w.add_body(w.shapes.sphere(0.2), position=(1.0, 5.0, 0.0))
    table = con.ConstraintTable(8)
    table.point(anchor, bob, (0.0, 5.0, 0.0), w._b["pos"][anchor], w._b["quat"][anchor],
                w._b["pos"][bob], w._b["quat"][bob])
    state = w.device_state(device)
    state["constraints"] = table.device_arrays(device)
    track = {"x": lambda s: s["bodies"]["pos"][bob, 0],
             "y": lambda s: s["bodies"]["pos"][bob, 1],
             "speed": lambda s: torch.linalg.vector_norm(s["bodies"]["linvel"][bob])}
    return state, cfg, w.shapes.present_types(), track


def cradle2(device):
    """Two-sphere Newton's cradle: equal masses, head-on elastic impact, no
    gravity and no friction."""
    cfg = PhysicsConfig(max_bodies=8, grid_dim=8, gravity=(0.0, 0.0, 0.0))
    w = pw.PhysicsWorld(cfg)
    a = w.add_body(w.shapes.sphere(0.5), position=(-1.3, 0.0, 0.0),
                   linvel=(2.0, 0.0, 0.0), restitution=1.0, friction=0.0)
    b = w.add_body(w.shapes.sphere(0.5), position=(0.0, 0.0, 0.0),
                   restitution=1.0, friction=0.0)
    track = {"vx_a": lambda s: s["bodies"]["linvel"][a, 0],
             "vx_b": lambda s: s["bodies"]["linvel"][b, 0],
             "x_a": lambda s: s["bodies"]["pos"][a, 0],
             "x_b": lambda s: s["bodies"]["pos"][b, 0]}
    return w.device_state(device), cfg, w.shapes.present_types(), track


def friction_ramp(theta_deg: float, device, mu: float = 0.5):
    """1 m box resting on a plane inclined by theta_deg about z."""
    th = np.deg2rad(theta_deg)
    s, c = float(np.sin(th)), float(np.cos(th))
    cfg = PhysicsConfig(max_bodies=8, grid_dim=8)
    w = pw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((-s, c, 0.0), 0.0), motion=pw.STATIC, friction=mu)
    box = w.shapes.box((0.5, 0.5, 0.5))
    bi = w.add_body(box, position=(-0.501 * s, 0.501 * c, 0.0),
                    rotation=(0.0, 0.0, float(np.sin(th / 2.0)), float(np.cos(th / 2.0))),
                    friction=mu)
    track = {"speed": lambda st: torch.linalg.vector_norm(st["bodies"]["linvel"][bi]),
             "slip": lambda st: (-(st["bodies"]["pos"][bi, 0] + 0.501 * s) * c
                                 - (st["bodies"]["pos"][bi, 1] - 0.501 * c) * s)}
    return w.device_state(device), cfg, w.shapes.present_types(), track


SCENES: Dict[str, Tuple[Callable, int]] = {
    # name -> (make(device), steps)
    "sphere_drop": (sphere_drop, 120),
    "bounce_e05": (bounce_e05, 360),
    "stack5": (stack5, 300),
    "pendulum": (pendulum, 240),
    "cradle2": (cradle2, 60),
    # +-1 deg around the critical angle atan(0.5) = 26.57 deg
    "ramp_hold": (lambda device: friction_ramp(25.57, device), 180),
    "ramp_slide": (lambda device: friction_ramp(27.57, device), 180),
}


def simulate(name: str, device) -> Dict[str, np.ndarray]:
    """Run a canonical scene; returns {curve: (steps,) float32}. The curves
    stay on the device until the run ends."""
    make, steps = SCENES[name]
    state, cfg, types, track = make(device)
    h = 1.0 / cfg.simulation_rate
    curves = {k: [] for k in track}
    for _ in range(steps):
        state = pw.step(state, cfg, h, types)
        for k, fn in track.items():
            curves[k].append(fn(state))
    return {k: torch.stack(v).cpu().numpy().astype(np.float32) for k, v in curves.items()}


# -- the analytic budgets (tests/golden/README.md) ------------------------------------


def _sphere_drop(c):
    h, g, y0, r = 1.0 / 60.0, -9.81, 5.0, 0.5
    for k in (10, 30, 50):        # semi-implicit Euler closed form until impact
        expect = y0 + g * h * h * k * (k + 1) / 2
        if expect > r + 0.1:
            np.testing.assert_allclose(c["y"][k - 1], expect, rtol=1e-5)
    assert abs(c["y"][-1] - r) < 0.02, c["y"][-1]
    assert abs(c["vy"][-1]) < 0.05


def _bounce_e05(c):
    y = c["y"]
    apexes = [float(y[i]) for i in range(1, len(y) - 1)
              if y[i] > y[i - 1] and y[i] >= y[i + 1] and y[i] > 0.55]
    assert len(apexes) >= 2, apexes
    h0 = 3.0 - 0.5
    a1, a2 = apexes[0] - 0.5, apexes[1] - 0.5
    assert 0.8 * 0.25 * h0 < a1 < 1.2 * 0.25 * h0, (a1, 0.25 * h0)
    assert 0.65 * 0.0625 * h0 < a2 < 1.35 * 0.0625 * h0, (a2, 0.0625 * h0)


def _stack5(c):
    for i in range(5):
        got = float(c[f"y{i}"][-1])
        assert abs(got - (0.5 + i * 1.0)) < 0.03 + i * 0.01, (i, got)
    assert float(c["x_drift"][-1]) < 0.05, c["x_drift"][-1]
    tail = np.stack([c[f"y{i}"][-60:] for i in range(5)])
    assert tail.std(axis=1).max() < 5e-3


def _cradle2(c):
    assert abs(c["vx_a"][-1]) < 0.10, c["vx_a"][-1]
    assert abs(c["vx_b"][-1] - 2.0) < 0.10, c["vx_b"][-1]
    np.testing.assert_allclose(c["vx_a"] + c["vx_b"], 2.0, atol=1e-3)


def _ramp_hold(c):
    assert c["speed"][-1] < 0.02, c["speed"][-1]
    assert abs(c["slip"][-1]) < 0.02, c["slip"][-1]


def _ramp_slide(c):
    assert c["speed"][-1] > 0.2, c["speed"][-1]
    assert c["slip"][-1] > 0.1, c["slip"][-1]


def _pendulum(c):
    x, y, speed = c["x"], c["y"], c["speed"]
    arm = np.sqrt(x ** 2 + (y - 5.0) ** 2)
    assert np.all(np.abs(arm[5:] - 1.0) < 0.02), arm.max()
    cross = np.where(np.sign(x[:-1]) != np.sign(x[1:]))[0]
    assert len(cross) >= 2, "pendulum never crossed bottom"
    v_bottom = speed[cross[0]:cross[0] + 2].max()
    v_exp = np.sqrt(2 * 9.81 * 1.0)
    assert 0.94 * v_exp < v_bottom < 1.02 * v_exp, (v_bottom, v_exp)
    half_t = (cross[1] - cross[0]) / 60.0
    assert 0.90 * 1.184 < half_t < 1.10 * 1.184, half_t


_CHECKS = {"sphere_drop": _sphere_drop, "bounce_e05": _bounce_e05, "stack5": _stack5,
           "pendulum": _pendulum, "cradle2": _cradle2, "ramp_hold": _ramp_hold,
           "ramp_slide": _ramp_slide}


def check(name: str, curves: Dict[str, np.ndarray]) -> None:
    """Hold a scene's curves to its analytic budget; AssertionError on a miss."""
    _CHECKS[name](curves)
