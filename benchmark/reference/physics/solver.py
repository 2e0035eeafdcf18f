"""Contact solver: symmetric-row Jacobi impulses with mass splitting.

Port of `garden_tpu.physics.solver`. Contacts live in a (bodies, slots)
layout where a touching pair appears in both bodies' rows, mirrored, so an
impulse is applied by a sum over the row's own slots: no scatter. Partner
attributes come from one gather per pair row ((N, K) partner ids, broadcast
to the MAX_POINTS slots of each pair).

Contact layout (S = K * MAX_POINTS slots per body):
- `pair_partner` int32[N, K]: the other body of each pair
- `point`, `normal` f32[N, S, 3] (normal points row body -> partner)
- `pen` f32[N, S], `valid` bool[N, S]
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from benchmark.reference.core import math3d as m3

Tensor = torch.Tensor


def _orthonormal_tangents(n: Tensor) -> Tuple[Tensor, Tensor]:
    """Two unit tangents with t1(-n) = -t1(n) and t2(-n) = t2(n), so the
    mirrored rows of a pair get mirrored friction frames."""
    ex = m3.constant((1.0, 0.0, 0.0), n.device)
    ey = m3.constant((0.0, 1.0, 0.0), n.device)
    helper = torch.where((torch.abs(n[..., 0]) > 0.9)[..., None], ey, ex)
    t1 = m3.normalize(m3.cross(n, helper))
    t2 = m3.cross(n, t1)
    return t1, t2


def _expander(s_slots: int, k: int):
    rep = s_slots // k

    def expand(x: Tensor) -> Tensor:
        """(N, K, ...) per pair -> (N, S, ...) per slot."""
        return torch.repeat_interleave(x, rep, dim=1) if rep > 1 else x
    return expand


def _matvec3(m: Tensor, v: Tensor) -> Tensor:
    p = m * v[..., None, :]
    return p[..., 0] + p[..., 1] + p[..., 2]


def solve_velocity(
    bodies: Dict[str, Tensor],
    contacts: Dict[str, Tensor],
    dt: float,
    *,
    iterations: int,
    baumgarte: float,
    slop: float,
    restitution_threshold: float = 0.5,
    warm: Optional[Dict[str, Tensor]] = None,
    gravity: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """Solve contact constraints; returns (linvel, angvel, accumulated
    impulses {n, t1, t2} in the (N, S) slot layout)."""
    point = contacts["point"]
    normal = contacts["normal"]
    pen = contacts["pen"]
    partner = contacts["pair_partner"].long()
    expand = _expander(point.shape[1], partner.shape[1])

    is_sensor = bodies["is_sensor"]
    responsive = contacts["valid"] & ~(is_sensor[:, None] | expand(is_sensor[partner]))
    inv_mass = bodies["inv_mass"]
    r = m3.quat_to_mat3(bodies["quat"])
    inv_inertia_w = torch.einsum("nij,nj,nkj->nik", r, bodies["inv_inertia"], r)
    count = torch.sum(responsive.float(), dim=1)
    split = torch.clamp(count, min=1.0)
    pos = bodies["pos"]

    # partner attributes and pre-solve velocities, one row gather
    body_tab = torch.cat(
        [pos, inv_mass[:, None], split[:, None], inv_inertia_w.reshape(-1, 9),
         bodies["angular_factor"], bodies["friction"][:, None],
         bodies["restitution"][:, None], bodies["linvel"], bodies["angvel"]],
        dim=1)                                             # (N, 25)
    par_tab = expand(body_tab[partner])                    # (N, S, 25)
    pos_p = par_tab[..., 0:3]
    inv_mass_p = par_tab[..., 3]
    split_p = par_tab[..., 4]
    inertia_par = par_tab[..., 5:14].reshape(par_tab.shape[:-1] + (3, 3))
    angf_par = par_tab[..., 14:17]
    friction_p = par_tab[..., 17]
    restitution_p = par_tab[..., 18]
    linvel_p0 = par_tab[..., 19:22]
    angvel_p0 = par_tab[..., 22:25]

    r_own = point - pos[:, None, :]
    r_par = point - pos_p
    lin_factor = bodies["linear_factor"]
    ang_factor = bodies["angular_factor"]
    inertia_own = inv_inertia_w[:, None]
    angf_own = ang_factor[:, None, :]

    def k_for(axis: Tensor) -> Tensor:
        """Effective mass denominator along a unit axis (with splitting)."""
        xo = m3.cross(r_own, axis) * angf_own
        xp = m3.cross(r_par, axis) * angf_par
        ang_o = _matvec3(inertia_own, xo)
        ang_p = _matvec3(inertia_par, xp)
        k = (inv_mass[:, None] * split[:, None] + inv_mass_p * split_p
             + m3.dot(xo, ang_o) * split[:, None] + m3.dot(xp, ang_p) * split_p)
        return torch.clamp(k, min=1e-9)

    t1, t2 = _orthonormal_tangents(normal)
    k_n = k_for(normal)
    k_t1 = k_for(t1)
    k_t2 = k_for(t2)
    friction = torch.sqrt(bodies["friction"][:, None] * friction_p)
    restitution = torch.maximum(bodies["restitution"][:, None], restitution_p)

    def rel_vel(linvel: Tensor, angvel: Tensor) -> Tensor:
        """Partner contact-point velocity relative to the own body's."""
        par = expand(torch.cat([linvel, angvel], dim=1)[partner])
        v_own = linvel[:, None, :] + m3.cross(angvel[:, None, :], r_own)
        v_par = par[..., 0:3] + m3.cross(par[..., 3:6], r_par)
        return v_par - v_own

    v_own0 = bodies["linvel"][:, None, :] + m3.cross(bodies["angvel"][:, None, :], r_own)
    v_par0 = linvel_p0 + m3.cross(angvel_p0, r_par)
    vn0 = m3.dot(v_par0 - v_own0, normal)
    zero = torch.zeros_like(pen)
    bounce = torch.where(vn0 < -restitution_threshold, -restitution * vn0, zero)
    if gravity is not None:
        # speculative-restitution energy correction (see the reference)
        g_n = m3.dot(gravity.expand(normal.shape), normal)
        e2 = restitution * restitution
        u2 = e2 * vn0 * vn0 + 2.0 * g_n * pen * (1.0 - e2)
        bounce_c = torch.sqrt(torch.clamp(u2, min=0.0))
        bounce = torch.where(bounce > 0.0, torch.minimum(bounce, bounce_c), zero)
    bias = torch.clamp((baumgarte / dt) * torch.clamp(pen - slop, min=0.0), max=2.0)
    target_vn = torch.where(pen > 0.0, torch.maximum(bounce, bias),
                            torch.where(bounce > 0.0, bounce, pen / dt))

    def apply(linvel, angvel, impulse):
        """Apply impulses (N, S, 3) that the row body receives."""
        dlin = -torch.sum(impulse, dim=1) * inv_mass[:, None] * lin_factor
        torque = -torch.sum(m3.cross(r_own, impulse), dim=1)
        dang = _matvec3(inv_inertia_w, torque) * ang_factor
        return linvel + dlin, angvel + dang

    linvel, angvel = bodies["linvel"], bodies["angvel"]
    if warm is not None:
        acc_n = torch.where(responsive, warm["n"], zero)
        acc_t1 = torch.where(responsive, warm["t1"], zero)
        acc_t2 = torch.where(responsive, warm["t2"], zero)
        linvel, angvel = apply(
            linvel, angvel,
            acc_n[..., None] * normal + acc_t1[..., None] * t1
            + acc_t2[..., None] * t2)
    else:
        acc_n = acc_t1 = acc_t2 = zero

    for _ in range(iterations):
        # one partner fetch per iteration; the friction pass reuses it,
        # corrected by the own body's normal-impulse delta
        v = rel_vel(linvel, angvel)
        vn = m3.dot(v, normal)
        dlam = (target_vn - vn) / k_n
        new_acc = torch.clamp(acc_n + dlam, min=0.0)
        dlam = torch.where(responsive, new_acc - acc_n, zero)
        acc_n = torch.where(responsive, new_acc, acc_n)
        linvel2, angvel2 = apply(linvel, angvel, dlam[..., None] * normal)
        dlin = linvel2 - linvel
        dang = angvel2 - angvel
        v = v - (dlin[:, None, :] + m3.cross(dang[:, None, :], r_own))
        linvel, angvel = linvel2, angvel2

        max_f = friction * acc_n
        dt1 = -m3.dot(v, t1) / k_t1
        new_t1 = torch.clamp(acc_t1 + dt1, -max_f, max_f)
        dt1 = torch.where(responsive, new_t1 - acc_t1, zero)
        acc_t1 = torch.where(responsive, new_t1, acc_t1)
        dt2 = -m3.dot(v, t2) / k_t2
        new_t2 = torch.clamp(acc_t2 + dt2, -max_f, max_f)
        dt2 = torch.where(responsive, new_t2 - acc_t2, zero)
        acc_t2 = torch.where(responsive, new_t2, acc_t2)
        linvel, angvel = apply(linvel, angvel,
                               dt1[..., None] * t1 + dt2[..., None] * t2)
    return linvel, angvel, {"n": acc_n, "t1": acc_t1, "t2": acc_t2}


def solve_position(
    pos: Tensor,
    bodies: Dict[str, Tensor],
    contacts: Dict[str, Tensor],
    pen: Tensor,
    *,
    iterations: int,
    slop: float,
    beta: float = 0.8,
    init_disp: Optional[Tensor] = None,
) -> Tensor:
    """Positional (split-impulse) penetration correction, row-reduced.
    `pen` is the collide-time depth; `init_disp` the displacement applied
    since then."""
    normal = contacts["normal"]
    partner = contacts["pair_partner"].long()
    expand = _expander(normal.shape[1], partner.shape[1])
    is_sensor = bodies["is_sensor"]
    responsive = contacts["valid"] & ~(is_sensor[:, None] | expand(is_sensor[partner]))
    inv_mass = bodies["inv_mass"]
    split = torch.clamp(torch.sum(responsive.float(), dim=1), min=1.0)
    prod = inv_mass * split
    lin_factor = bodies["linear_factor"]
    dtot = init_disp if init_disp is not None else torch.zeros_like(pos)
    zero = torch.zeros_like(pen)
    k = None
    for _ in range(iterations):
        par = expand(torch.cat([dtot, prod[:, None]], dim=1)[partner])
        if k is None:
            k = torch.clamp(prod[:, None] + par[..., 3], min=1e-9)
        rel = m3.dot(par[..., 0:3] - dtot[:, None, :], normal)
        sep = pen - rel
        lam = torch.where(
            responsive,
            torch.clamp(beta * torch.clamp(sep - slop, min=0.0), max=0.1) / k, zero)
        dpos = -torch.sum(lam[..., None] * normal, dim=1) * inv_mass[:, None] * lin_factor
        pos = pos + dpos
        dtot = dtot + dpos
    return pos
