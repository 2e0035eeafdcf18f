"""Physics world: the body store, the fixed step and the tick accumulator.

Port of `garden_tpu.physics.world`: `PhysicsWorld` builds the body arrays on
the host with numpy and `device_state` copies them to a device; `step` is a
function of that state dict; `simulate` runs the fixed-rate accumulator with
cascade-lag clamping and keeps the previous pose for `interpolated_pose`.

`collide` has the reference's two branches: where the active pair budget
covers every candidate pair, the candidate layout is the solver layout;
otherwise the first `active_pair_budget` touching pairs of each row are
compacted into it. Each stage runs inside a `torch.profiler` range named
as the reference's `jax.named_scope`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import PhysicsConfig
from garden_tpu_torch.physics import broadphase, constraints, narrowphase, solver
from garden_tpu_torch.physics import shapes as sh

Tensor = torch.Tensor

# motion types
STATIC = 0
KINEMATIC = 1
DYNAMIC = 2

# collision layers
LAYER_NON_MOVING = 0
LAYER_MOVING = 1
LAYER_SENSOR = 2
LAYER_HQ_DEBRIS = 3
LAYER_LQ_DEBRIS = 4
NUM_LAYERS = 5

# the reference's default count of grid-bypassing big-body slots
# (PhysicsConfig.max_globals is what the step reads)
MAX_GLOBALS = 8


def default_layer_table() -> np.ndarray:
    """Which layers collide (the reference's object-layer pair filter)."""
    t = np.zeros((NUM_LAYERS, NUM_LAYERS), dtype=bool)
    for a, b in ((LAYER_NON_MOVING, LAYER_MOVING),
                 (LAYER_NON_MOVING, LAYER_HQ_DEBRIS),
                 (LAYER_NON_MOVING, LAYER_LQ_DEBRIS),
                 (LAYER_MOVING, LAYER_MOVING),
                 (LAYER_MOVING, LAYER_HQ_DEBRIS),
                 (LAYER_MOVING, LAYER_SENSOR),
                 (LAYER_HQ_DEBRIS, LAYER_HQ_DEBRIS)):
        t[a, b] = True
        t[b, a] = True
    return t


def active_pair_budget(config: PhysicsConfig) -> int:
    """Contact pairs kept per body row (max_active_contacts counts points;
    a resting manifold holds up to MAX_POINTS of them)."""
    return max(config.max_active_contacts // 2, 1)


class PhysicsWorld:
    """Host-side assembly of a physics state dict."""

    def __init__(self, config: PhysicsConfig,
                 shape_table: Optional[sh.ShapeTable] = None):
        self.config = config
        self.shapes = shape_table or sh.ShapeTable()
        n = config.max_bodies
        self._b: Dict[str, np.ndarray] = {
            "has": np.zeros((n,), bool),
            "shape": np.zeros((n,), np.int32),
            "motion": np.zeros((n,), np.int32),
            "pos": np.zeros((n, 3), np.float32),
            "quat": np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1)),
            "linvel": np.zeros((n, 3), np.float32),
            "angvel": np.zeros((n, 3), np.float32),
            "inv_mass": np.zeros((n,), np.float32),
            "inv_inertia": np.zeros((n, 3), np.float32),
            "friction": np.full((n,), 0.5, np.float32),
            "restitution": np.zeros((n,), np.float32),
            "layer": np.zeros((n,), np.int32),
            "is_sensor": np.zeros((n,), bool),
            "is_global": np.zeros((n,), bool),
            "linear_factor": np.ones((n, 3), np.float32),
            "angular_factor": np.ones((n, 3), np.float32),
            "entity": np.full((n,), -1, np.int32),
            "ground_cos": np.full((n,), 0.7071, np.float32),
        }
        self._count = 0

    def add_body(self, shape: int, position=(0.0, 0.0, 0.0),
                 rotation=(0.0, 0.0, 0.0, 1.0), motion: int = DYNAMIC,
                 linvel=(0.0, 0.0, 0.0), angvel=(0.0, 0.0, 0.0),
                 friction: float = 0.5, restitution: float = 0.0,
                 layer: Optional[int] = None, is_sensor: bool = False,
                 mass_override: Optional[float] = None,
                 linear_factor=(1.0, 1.0, 1.0), angular_factor=(1.0, 1.0, 1.0),
                 entity: int = -1, ground_cos: float = 0.7071) -> int:
        if self._count >= self.config.max_bodies:
            raise RuntimeError("body capacity exhausted")
        i = self._count
        self._count += 1
        b = self._b
        b["has"][i] = True
        b["shape"][i] = shape
        b["motion"][i] = motion
        b["pos"][i] = position
        b["quat"][i] = rotation
        b["linvel"][i] = linvel
        b["angvel"][i] = angvel
        b["friction"][i] = friction
        b["restitution"][i] = restitution
        b["is_sensor"][i] = is_sensor
        b["entity"][i] = entity
        b["linear_factor"][i] = linear_factor
        b["angular_factor"][i] = angular_factor
        b["ground_cos"][i] = ground_cos
        stype = int(self.shapes.types[shape])
        if layer is None:
            layer = LAYER_MOVING if motion == DYNAMIC else LAYER_NON_MOVING
            if is_sensor:
                layer = LAYER_SENSOR
        b["layer"][i] = layer
        b["is_global"][i] = stype in (sh.PLANE, sh.HEIGHTFIELD, sh.MESH)
        if motion == DYNAMIC and stype == sh.MESH:
            raise ValueError("mesh-shaped bodies must be STATIC/KINEMATIC")
        if motion == DYNAMIC:
            mass, inertia = self.shapes.body_mass_properties(shape)
            if mass_override is not None:
                inertia = inertia * (mass_override / mass)
                mass = mass_override
            b["inv_mass"][i] = 1.0 / mass
            b["inv_inertia"][i] = 1.0 / np.maximum(inertia, 1e-12)
        return i

    def device_state(self, device) -> Dict[str, Any]:
        as_t = lambda a: torch.as_tensor(np.array(a), device=device)
        n = self.config.max_bodies
        bodies = {k: as_t(v) for k, v in self._b.items()}
        bodies["sleep_timer"] = torch.zeros((n,), device=device)
        bodies["sleeping"] = torch.zeros((n,), dtype=torch.bool, device=device)
        k = self.config.max_contacts_per_body + self.config.max_globals
        k_act = min(active_pair_budget(self.config), k)
        ca = (n, k_act * narrowphase.MAX_POINTS)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return {
            "bodies": bodies,
            "prev_pos": as_t(self._b["pos"]),
            "prev_quat": as_t(self._b["quat"]),
            "shapes": self.shapes.device_arrays(device),
            "layer_table": as_t(default_layer_table()),
            # warm-start impulses in the solver's slot layout; `key` holds
            # each kept pair's partner id (pair-level identity)
            "warm": {
                "n": torch.zeros(ca, device=device),
                "t1": torch.zeros(ca, device=device),
                "t2": torch.zeros(ca, device=device),
                "key": torch.full((n, k_act), -1, dtype=torch.int32, device=device),
            },
            "accum": f32(0.0),
            "lag_time": f32(0.0),
            "time": f32(0.0),
            "grounded": torch.zeros((n,), dtype=torch.bool, device=device),
            "touching": torch.full(ca, -1, dtype=torch.int32, device=device),
        }


def candidates(state: Dict[str, Any], config: PhysicsConfig):
    """The broadphase stage: (stype, params, per-body margin, cand_idx,
    cand_valid) with the candidates (N, K) of each body, globals first."""
    b = state["bodies"]
    shapes_t = state["shapes"]
    shape = b["shape"].long()
    stype = shapes_t["type"][shape]
    params = shapes_t["params"][shape]

    # speculative margin grows with speed, clamped so every grid AABB spans
    # at most 2 cells per axis (the broadphase inserts into 2x2x2 cells)
    h = 1.0 / config.simulation_rate
    speed = torch.linalg.vector_norm(b["linvel"], dim=-1)
    margin = config.speculative_margin + speed * h * 1.1
    side = params[:, 0].long()
    hull_ext = shapes_t["hull_ext"][side % shapes_t["hull_ext"].shape[0]]
    comp_ext = shapes_t["comp_ext"][side % shapes_t["comp_ext"].shape[0]]
    aabb_min, aabb_max = broadphase.body_aabbs(
        b["pos"], b["quat"], stype, params, hull_ext=hull_ext, comp_ext=comp_ext)
    span = torch.amax(aabb_max - aabb_min, dim=-1)
    qstep = config.cell_size * config.grid_dim / 1024.0
    margin = torch.minimum(
        margin,
        torch.clamp((2.0 * config.cell_size - span) * 0.5 - qstep - 1e-3,
                    min=config.speculative_margin))
    is_global = b["is_global"] | (
        (span + 2.0 * margin + 2.0 * qstep > 2.0 * config.cell_size)
        & (b["motion"] != DYNAMIC))
    aabb_min = aabb_min - margin[:, None]
    aabb_max = aabb_max + margin[:, None]
    dynamic = b["motion"] == DYNAMIC
    with record_function("broadphase"):
        cand_idx, cand_valid = broadphase.find_candidates(
            b["pos"], aabb_min, aabb_max, active=b["has"], dynamic=dynamic,
            layer=b["layer"], layer_table=state["layer_table"], is_global=is_global,
            cell_size=config.cell_size, grid_dim=config.grid_dim,
            cand_per_cell=config.max_bodies_per_cell,
            max_candidates=config.max_contacts_per_body,
            max_globals=config.max_globals)
    return stype, params, margin, cand_idx, cand_valid


def collide(state: Dict[str, Any], config: PhysicsConfig,
            present_types: Optional[frozenset] = None) -> Dict[str, Tensor]:
    """Broadphase + narrowphase -> per-body contact rows in the solver
    layout (N, K_act * MAX_POINTS)."""
    b = state["bodies"]
    stype, params, margin, cand_idx, cand_valid = candidates(state, config)
    n, k = cand_idx.shape
    pair_i = torch.arange(n, dtype=torch.int32, device=cand_idx.device)
    pair_i = pair_i[:, None].expand(n, k).reshape(-1)
    with record_function("narrowphase"):
        man = narrowphase.generate_contacts(
            b["pos"], b["quat"], stype, params, pair_i, cand_idx.reshape(-1),
            cand_valid.reshape(-1), margin=margin, present_types=present_types,
            tables=state["shapes"])
    # manifolds are in canonical order; rows want row body -> partner
    flip = (man["a"] != pair_i)[:, None, None]
    normal = torch.where(flip, -man["normal"], man["normal"])
    mp = narrowphase.MAX_POINTS
    k_act = min(active_pair_budget(config), k)
    if k_act >= k:
        # the budget covers every candidate: the candidate layout is the
        # solver layout
        s_all = k * mp
        return {
            "point": man["point"].reshape(n, s_all, 3),
            "normal": normal.reshape(n, s_all, 3),
            "pen": man["pen"].reshape(n, s_all),
            "valid": man["valid"].reshape(n, s_all),
            "pair_partner": cand_idx,
            "partner": torch.repeat_interleave(cand_idx, mp, dim=1),
        }
    with record_function("contact_compact"):
        # the first k_act touching pairs of each row, in candidate order
        # (globals first); a kept pair keeps its whole manifold
        pair_ok = torch.any(man["valid"].reshape(n, k, mp), dim=-1)
        ar = torch.arange(k, dtype=torch.int32, device=cand_idx.device)
        rank = torch.where(pair_ok, k - ar[None, :], torch.zeros_like(cand_idx))
        sel = broadphase._first_k(rank, k_act)             # (N, K_act)

        def take(x: Tensor) -> Tensor:
            x = x.reshape(n, k, -1)
            return torch.gather(x, 1, sel[..., None].expand(n, k_act, x.shape[-1]))
        pair_partner = take(cand_idx)[..., 0]
    s_act = k_act * mp
    return {
        "point": take(man["point"]).reshape(n, s_act, 3),
        "normal": take(normal).reshape(n, s_act, 3),
        "pen": take(man["pen"]).reshape(n, s_act),
        "valid": take(man["valid"]).reshape(n, s_act),
        # pair-level partner for row gathers and its slot-level view
        "pair_partner": pair_partner,
        "partner": torch.repeat_interleave(pair_partner, mp, dim=1),
    }


def step(state: Dict[str, Any], config: PhysicsConfig,
         dt: Optional[float] = None,
         present_types: Optional[frozenset] = None) -> Dict[str, Any]:
    """One fixed physics step; returns the new state dict."""
    if dt is None:
        dt = 1.0 / config.simulation_rate
    b = state["bodies"]
    dynamic = (b["motion"] == DYNAMIC) & b["has"]
    dyn3 = dynamic[:, None]
    # gravity before the solve; locked DOFs zero their velocity components
    gravity = m3.constant(tuple(float(g) for g in config.gravity), b["pos"].device)
    linvel = b["linvel"] + torch.where(dyn3, gravity * dt * b["linear_factor"],
                                       torch.zeros_like(b["linvel"]))
    linvel = torch.where(dyn3, linvel * b["linear_factor"], linvel)
    angvel = torch.where(dyn3, b["angvel"] * b["angular_factor"], b["angvel"])
    b = dict(b, linvel=linvel, angvel=angvel)
    state = dict(state, bodies=b)

    with record_function("collide"):
        contacts = collide(state, config, present_types)

    # pair-level warm start: a pair keeps its impulses when the same partner
    # sits in its row again; the points transfer positionally
    mp = narrowphase.MAX_POINTS
    with record_function("warm_match"):
        n_b, k_act = contacts["pair_partner"].shape
        pair_ok = torch.any(contacts["valid"].reshape(n_b, k_act, mp), dim=-1)
        new_key = torch.where(pair_ok, contacts["pair_partner"],
                              torch.full_like(contacts["pair_partner"], -1))
        old_key = state["warm"]["key"]
        match = (new_key[:, :, None] == old_key[:, None, :]) & (new_key >= 0)[:, :, None]
        src = torch.argmax(match.int(), dim=-1)                   # (N, K)
        wpack = torch.stack([state["warm"]["n"], state["warm"]["t1"],
                             state["warm"]["t2"]], dim=-1).reshape(n_b, k_act, mp * 3)
        wc = torch.gather(wpack, 1, src[..., None].expand(n_b, k_act, mp * 3))
        wc = torch.where(match.any(-1)[..., None], wc, torch.zeros_like(wc))
        wc = wc.reshape(n_b, k_act * mp, 3)
        warm_compact = {"n": wc[..., 0], "t1": wc[..., 1], "t2": wc[..., 2]}

    # with the position solve active, contact Baumgarte is off
    vel_baumgarte = 0.0 if config.position_iterations > 0 else config.baumgarte
    with record_function("solve_velocity"):
        linvel, angvel, warm_c = solver.solve_velocity(
            b, contacts, dt, iterations=config.solver_iterations,
            baumgarte=vel_baumgarte, slop=config.penetration_slop,
            warm=warm_compact, gravity=gravity)
    valid = contacts["valid"]
    zero = torch.zeros_like(contacts["pen"])
    warm = {"n": torch.where(valid, warm_c["n"], zero),
            "t1": torch.where(valid, warm_c["t1"], zero),
            "t2": torch.where(valid, warm_c["t2"], zero),
            "key": new_key}

    # joint constraints (Fixed/Point)
    if "constraints" in state:
        with record_function("constraints"):
            linvel, angvel = constraints.solve_constraints(
                dict(b, linvel=linvel, angvel=angvel), state["constraints"], dt,
                iterations=config.solver_iterations // 2 + 1,
                baumgarte=config.baumgarte)

    # integrate (semi-implicit Euler; kinematic bodies keep their velocity)
    with record_function("integrate"):
        moving = (((b["motion"] == DYNAMIC) | (b["motion"] == KINEMATIC))
                  & b["has"])[:, None]
        pos = b["pos"] + torch.where(moving, linvel * dt, torch.zeros_like(linvel))
        quat = torch.where(moving, m3.quat_integrate(b["quat"], angvel, dt), b["quat"])

    # split-impulse penetration correction, from the collide-time depths
    # adjusted by the integration displacement
    if config.position_iterations > 0:
        with record_function("solve_position"):
            pos = solver.solve_position(
                pos, b, contacts, contacts["pen"],
                iterations=config.position_iterations,
                slop=config.penetration_slop, init_disp=pos - b["pos"])
            if "constraints" in state:
                pos = constraints.project_positions(
                    pos, dict(b, quat=quat), state["constraints"],
                    iterations=config.position_iterations)
    with record_function("sleep_misc"):
        b = dict(b, pos=pos, quat=quat,
                 linvel=torch.where(dyn3, linvel, b["linvel"]),
                 angvel=torch.where(dyn3, angvel, b["angvel"]))
        # sleeping: bodies below the motion threshold for sleep_time freeze
        # and hold their pose exactly; contact with a moving partner wakes
        if config.sleep_enabled:
            speed2 = torch.sum(b["linvel"] ** 2, -1) + torch.sum(b["angvel"] ** 2, -1)
            timer = torch.where(speed2 < 0.003, b["sleep_timer"] + dt,
                                torch.zeros_like(speed2))
            sleeping = timer > 0.5
            keep = (sleeping & b["sleeping"])[:, None]
            asleep = sleeping[:, None]
            b = dict(b, sleep_timer=timer, sleeping=sleeping,
                     pos=torch.where(keep, state["bodies"]["pos"], pos),
                     quat=torch.where(keep, state["bodies"]["quat"], quat),
                     linvel=torch.where(asleep, torch.zeros_like(b["linvel"]), b["linvel"]),
                     angvel=torch.where(asleep, torch.zeros_like(b["angvel"]), b["angvel"]))
        # ground support: a contact whose normal (row -> partner) points
        # down within the body's slope limit
        grounded = torch.any(
            valid & (contacts["normal"][..., 1] < -b["ground_cos"][:, None]), dim=1)
        # touching partners, for contact events
        touching = torch.where(valid & (contacts["pen"] > 0.0), contacts["partner"],
                               torch.full_like(contacts["partner"], -1))
    return dict(state, bodies=b, warm=warm, grounded=grounded,
                touching=touching, time=state["time"] + dt)


def _select_tree(did: Tensor, new: Any, old: Any) -> Any:
    """where(did, new, old) over a state tree; leaves the step passed
    through unchanged are kept as they are."""
    if isinstance(new, dict):
        return {k: _select_tree(did, new[k], old[k]) for k in new}
    if new is old:
        return old
    return torch.where(did, new, old)


def simulate(state: Dict[str, Any], config: PhysicsConfig, delta_time,
             max_steps_per_tick: int = 4,
             present_types: Optional[frozenset] = None) -> Dict[str, Any]:
    """Fixed-rate accumulator stepping with cascade-lag recovery: add
    delta_time to the accumulator, run floor(accum / h) fixed steps (at most
    max_steps_per_tick), and once the sim has stayed more than one step
    behind for cascade_lag_threshold seconds, clamp to one step. Every tick
    runs max_steps_per_tick steps and keeps the first nsteps, so nothing is
    read back to the host. Keeps the previous pose for interpolation."""
    h = 1.0 / config.simulation_rate
    accum = state["accum"] + delta_time
    nsteps = torch.floor(accum / h).int()
    lagging = nsteps > 1
    lag_time = torch.where(lagging, state["lag_time"] + delta_time,
                           torch.zeros_like(state["lag_time"]))
    clamp = lag_time > config.cascade_lag_threshold
    nsteps = torch.where(clamp, torch.clamp(nsteps, max=1), nsteps)
    nsteps = torch.clamp(nsteps, max=max_steps_per_tick)
    accum = torch.where(clamp, torch.clamp(accum, max=h), accum)
    stepped = nsteps > 0
    prev_pos = torch.where(stepped, state["bodies"]["pos"], state["prev_pos"])
    prev_quat = torch.where(stepped, state["bodies"]["quat"], state["prev_quat"])
    state = dict(state, prev_pos=prev_pos, prev_quat=prev_quat, lag_time=lag_time)
    for i in range(max_steps_per_tick):
        state = _select_tree(i < nsteps, step(state, config, h, present_types), state)
    return dict(state, accum=accum - nsteps.float() * h)


def interpolated_pose(state: Dict[str, Any], config: PhysicsConfig
                      ) -> Tuple[Tensor, Tensor]:
    """Render pose between fixed steps."""
    h = 1.0 / config.simulation_rate
    alpha = torch.clamp(state["accum"] / h, 0.0, 1.0)
    pos = m3.lerp(state["prev_pos"], state["bodies"]["pos"], alpha)
    quat = m3.quat_slerp(state["prev_quat"], state["bodies"]["quat"], alpha)
    return pos, quat
