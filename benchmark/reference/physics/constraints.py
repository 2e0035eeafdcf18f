"""Body-to-body constraints: Fixed and Point joints.

Port of `garden_tpu.physics.constraints`: fixed-capacity constraint arrays,
solved with mass-split Jacobi velocity iterations and a positional
projection, as the contacts are.

- POINT: pins an anchor point (in each body's local frame) together, a
  ball-socket joint of 3 velocity constraints.
- FIXED: a point joint plus a relative-orientation lock.

The reference sums each iteration's impulses per body with
`jax.ops.segment_sum`. Float atomics (`index_add_` on a card) would reorder
those sums from run to run, so the port sums with a dense (bodies,
constraints) one-hot product, built once per solve: the same scene gives the
same bits every run. Constraint counts are small, so the product is cheap.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference.core import math3d as m3

Tensor = torch.Tensor

POINT = 0
FIXED = 1
_EYE3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


class ConstraintTable:
    """Host-side assembly of the constraint arrays."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self.kind = np.zeros((capacity,), np.int32)
        self.body_a = np.full((capacity,), -1, np.int32)
        self.body_b = np.full((capacity,), -1, np.int32)
        self.anchor_a = np.zeros((capacity, 3), np.float32)
        self.anchor_b = np.zeros((capacity, 3), np.float32)
        self.rel_quat = np.tile(np.array([0, 0, 0, 1], np.float32), (capacity, 1))
        self.active = np.zeros((capacity,), bool)
        self._count = 0

    def add(self, kind: int, body_a: int, body_b: int,
            anchor_a=(0.0, 0.0, 0.0), anchor_b=(0.0, 0.0, 0.0),
            rel_quat=(0.0, 0.0, 0.0, 1.0)) -> int:
        if self._count >= self.capacity:
            raise RuntimeError("constraint capacity exhausted")
        i = self._count
        self._count += 1
        self.kind[i] = kind
        self.body_a[i] = body_a
        self.body_b[i] = body_b
        self.anchor_a[i] = anchor_a
        self.anchor_b[i] = anchor_b
        self.rel_quat[i] = rel_quat
        self.active[i] = True
        return i

    def point(self, body_a: int, body_b: int, world_point,
              pos_a, quat_a, pos_b, quat_b) -> int:
        """Point constraint at a world-space anchor."""
        wp = np.asarray(world_point, np.float32)

        def local(pos, quat):
            q = torch.as_tensor(np.asarray(quat, np.float32))
            d = torch.as_tensor(wp - np.asarray(pos, np.float32))
            return m3.quat_rotate(m3.quat_conj(q), d).numpy()
        return self.add(POINT, body_a, body_b, local(pos_a, quat_a), local(pos_b, quat_b))

    def device_arrays(self, device) -> Dict[str, Tensor]:
        return {k: torch.as_tensor(np.array(getattr(self, k)), device=device)
                for k in ("kind", "body_a", "body_b", "anchor_a", "anchor_b",
                          "rel_quat", "active")}


def _skew(v: Tensor) -> Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)


def _bodies(cons: Dict[str, Tensor], n_bodies: int):
    """Clamped body indices, the active mask, and the (N, C) one-hot
    matrices that sum per-constraint values onto each body."""
    a = torch.clamp(cons["body_a"], min=0).long()
    b = torch.clamp(cons["body_b"], min=0).long()
    active = cons["active"] & (cons["body_a"] >= 0) & (cons["body_b"] >= 0)
    rows = torch.arange(n_bodies, device=a.device)[:, None]
    return a, b, active, (rows == a[None, :]).float(), (rows == b[None, :]).float()


def solve_constraints(
    bodies: Dict[str, Tensor],
    cons: Dict[str, Tensor],
    dt: float,
    iterations: int = 8,
    baumgarte: float = 0.2,
) -> Tuple[Tensor, Tensor]:
    """Velocity-level constraint solve; returns (linvel, angvel).

    Point: the relative anchor velocity, through the full 3x3 effective
    mass per constraint. Fixed: also drives the relative angular velocity
    (plus an orientation drift bias) to zero. Jacobi across constraints."""
    a, b, active, seg_a, seg_b = _bodies(cons, bodies["pos"].shape[0])
    is_fixed = cons["kind"] == FIXED
    dev = a.device
    eye = m3.constant(_EYE3, dev)

    inv_mass = bodies["inv_mass"]
    r = m3.quat_to_mat3(bodies["quat"])
    inv_inertia_w = torch.einsum("nij,nj,nkj->nik", r, bodies["inv_inertia"], r)

    ra = m3.quat_rotate(bodies["quat"][a], cons["anchor_a"])
    rb = m3.quat_rotate(bodies["quat"][b], cons["anchor_b"])
    pa = bodies["pos"][a] + ra
    pb = bodies["pos"][b] + rb
    bias = (baumgarte / dt) * (pb - pa)             # positional drift (Baumgarte)
    # orientation drift of FIXED joints: relative quat error -> angular bias
    q_err = m3.quat_mul(bodies["quat"][b],
                        m3.quat_conj(m3.quat_mul(bodies["quat"][a], cons["rel_quat"])))
    ang_bias = (2.0 * baumgarte / dt) * q_err[..., :3] * torch.sign(q_err[..., 3:4])

    # the full 3x3 effective mass K = (1/ma + 1/mb) I - [ra]x Ia^-1 [ra]x
    # - [rb]x Ib^-1 [rb]x; impulse = K^-1 c_vel
    ra_x = _skew(ra)
    rb_x = _skew(rb)
    k_mat = ((inv_mass[a] + inv_mass[b])[..., None, None] * eye
             - torch.einsum("cij,cjk,ckl->cil", ra_x, inv_inertia_w[a], ra_x)
             - torch.einsum("cij,cjk,ckl->cil", rb_x, inv_inertia_w[b], rb_x))
    # inactive rows get the identity so the solve stays well-posed
    k_mat = torch.where(active[..., None, None], k_mat, eye)
    k_inv = torch.linalg.inv_ex(k_mat + 1e-9 * eye).inverse   # no host check
    k_ang = torch.clamp(
        torch.diagonal(inv_inertia_w[a], dim1=-2, dim2=-1).sum(-1)
        + torch.diagonal(inv_inertia_w[b], dim1=-2, dim2=-1).sum(-1), min=1e-9)[..., None]
    act3 = active[..., None]
    fixed3 = (active & is_fixed)[..., None]
    zero3 = torch.zeros_like(ra)

    linvel, angvel = bodies["linvel"], bodies["angvel"]
    for _ in range(iterations):
        va = linvel[a] + m3.cross(angvel[a], ra)
        vb = linvel[b] + m3.cross(angvel[b], rb)
        c_vel = (vb - va) + bias
        imp = torch.where(act3, torch.einsum("cij,cj->ci", k_inv, c_vel), zero3)
        dlin = seg_a @ (imp * inv_mass[a][:, None]) - seg_b @ (imp * inv_mass[b][:, None])
        torque = seg_a @ m3.cross(ra, imp) + seg_b @ m3.cross(rb, -imp)
        linvel = linvel + dlin * bodies["linear_factor"]
        angvel = angvel + (torch.einsum("nij,nj->ni", inv_inertia_w, torque)
                           * bodies["angular_factor"])
        # angular lock of FIXED joints
        w_err = (angvel[b] - angvel[a]) + ang_bias
        ang_imp = torch.where(fixed3, w_err / k_ang, zero3)
        torque = seg_a @ ang_imp + seg_b @ (-ang_imp)
        angvel = angvel + (torch.einsum("nij,nj->ni", inv_inertia_w, torque)
                           * bodies["angular_factor"])
    return linvel, angvel


def project_positions(
    pos: Tensor,
    bodies: Dict[str, Tensor],
    cons: Dict[str, Tensor],
    iterations: int = 2,
    beta: float = 0.8,
) -> Tensor:
    """Positional anchor projection: removes the residual anchor separation
    that the velocity-level bias leaves behind."""
    a, b, active, seg_a, seg_b = _bodies(cons, pos.shape[0])
    inv_mass = bodies["inv_mass"]
    ra = m3.quat_rotate(bodies["quat"][a], cons["anchor_a"])
    rb = m3.quat_rotate(bodies["quat"][b], cons["anchor_b"])
    k = torch.clamp(inv_mass[a] + inv_mass[b], min=1e-9)[..., None]
    for _ in range(iterations):
        err = (pos[b] + rb) - (pos[a] + ra)
        corr = torch.where(active[..., None], beta * err / k, torch.zeros_like(err))
        pos = pos + seg_a @ (corr * inv_mass[a][:, None])
        pos = pos - seg_b @ (corr * inv_mass[b][:, None])
    return pos
