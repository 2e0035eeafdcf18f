"""Batched 3D math on tensors: quaternions, matrices, AABBs, frustums.

Port of `garden_tpu.core.math3d`. Conventions are the reference's:
quaternions are (x, y, z, w) Hamilton products; points are transformed by
`apply_mat4`; clip space is right-handed reverse-Z (1 near, 0 far).

The reference's one-hot selects (`select_scalar`, `gather_rows`, ...) exist
only because random gathers are slow on a TPU; the port's `select_scalar`
and `select_row` index instead, and where the reference calls `gather_rows`
the port calls `torch.gather`.
Functions that create tensors take an explicit `device`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

Tensor = torch.Tensor


# -- vectors ------------------------------------------------------------------


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Dot product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def length(v: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: Tensor, eps: float = 1e-12) -> Tensor:
    return v * torch.rsqrt(torch.clamp(dot(v, v), min=eps))[..., None]


def cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def lerp(a: Tensor, b: Tensor, t) -> Tensor:
    return a + (b - a) * t


def saturate(x: Tensor) -> Tensor:
    return torch.clamp(x, 0.0, 1.0)


def reflect(v: Tensor, n: Tensor) -> Tensor:
    return v - 2.0 * dot(v, n)[..., None] * n


def constant(values, device, dtype=torch.float32) -> Tensor:
    """A tensor of Python values (nested tuples) on `device`, built once per
    device and reused: a copy from host memory at every call would hold the
    host until the card has drained its queue. Callers must not write to it.
    None is ever freed: a captured CUDA graph reads it at its address."""
    return _constant(values, str(torch.device(device)), dtype)


@functools.lru_cache(maxsize=None)
def _constant(values, device: str, dtype) -> Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def onehot(idx: Tensor, k: int) -> Tensor:
    """(..., k) float32 one-hot of integer indices."""
    return (idx[..., None] == torch.arange(k, device=idx.device)).float()


def select_scalar(x: Tensor, idx: Tensor) -> Tensor:
    """x[..., idx] for per-row indices: (..., k), (...,) -> (...,)."""
    return torch.gather(x, -1, idx[..., None].long())[..., 0]


def select_row(x: Tensor, idx: Tensor) -> Tensor:
    """x[..., idx, :] for per-row indices: (..., k, d), (...,) -> (..., d)."""
    i = idx[..., None, None].long().expand(idx.shape + (1, x.shape[-1]))
    return torch.gather(x, -2, i)[..., 0, :]


# -- quaternions (x, y, z, w) ------------------------------------------------------


QUAT_IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def quat_identity(shape=(), *, device) -> Tensor:
    return torch.as_tensor(QUAT_IDENTITY, device=device).expand(tuple(shape) + (4,))


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b (apply b's rotation first, then a's)."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_conj(q: Tensor) -> Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    return q * torch.rsqrt(torch.clamp(torch.sum(q * q, dim=-1), min=eps))[..., None]


def quat_from_axis_angle(axis: Tensor, angle) -> Tensor:
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    half = 0.5 * angle
    return torch.cat([normalize(axis) * torch.sin(half)[..., None],
                      torch.cos(half)[..., None]], dim=-1)


def quat_slerp(a: Tensor, b: Tensor, t) -> Tensor:
    """Spherical lerp with an nlerp fallback for nearly parallel quaternions."""
    cos_half = torch.sum(a * b, dim=-1)
    b = torch.where(cos_half[..., None] < 0.0, -b, b)
    cos_half = torch.clamp(torch.abs(cos_half), -1.0, 1.0)
    half = torch.arccos(cos_half)
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half * cos_half, min=0.0))
    near = sin_half < 1e-4
    safe_sin = torch.where(near, torch.ones_like(sin_half), sin_half)
    wa = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * half) / safe_sin)
    wb = torch.where(near, t, torch.sin(t * half) / safe_sin)
    return quat_normalize(wa[..., None] * a + wb[..., None] * b)


def quat_from_euler(euler: Tensor) -> Tensor:
    """XYZ-intrinsic Euler angles (radians) -> quaternion."""
    hx, hy, hz = 0.5 * euler[..., 0], 0.5 * euler[..., 1], 0.5 * euler[..., 2]
    cx, sx = torch.cos(hx), torch.sin(hx)
    cy, sy = torch.cos(hy), torch.sin(hy)
    cz, sz = torch.cos(hz), torch.sin(hz)
    return torch.stack([sx * cy * cz + cx * sy * sz,
                        cx * sy * cz - sx * cy * sz,
                        cx * cy * sz + sx * sy * cz,
                        cx * cy * cz - sx * sy * sz], dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vectors v by unit quaternions q."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def quat_to_mat3(q: Tensor) -> Tensor:
    """Unit quaternion -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_integrate(q: Tensor, omega: Tensor, dt) -> Tensor:
    """First-order orientation update q' = normalize(q + dt/2 (w, 0) q)."""
    wq = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    dq = quat_mul(wq, q) * (0.5 * dt)
    return quat_normalize(q + dq)


# -- matrices -------------------------------------------------------------------


def mat4_identity(shape=(), *, device) -> Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).expand(tuple(shape) + (4, 4))


def matmul(a: Tensor, b: Tensor) -> Tensor:
    return torch.matmul(a, b)


def compose_trs(position: Tensor, rotation: Tensor, scale: Tensor) -> Tensor:
    """Translation/rotation(quat)/scale -> (..., 4, 4) model matrix."""
    r = quat_to_mat3(rotation) * scale[..., None, :]
    top = torch.cat([r, position[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype,
                          device=r.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def apply_mat4(m: Tensor, p: Tensor, w: float = 1.0) -> Tensor:
    """Transform 3D points (w=1) or directions (w=0) by 4x4 matrices."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if m.ndim == 2:
        return torch.stack([m[i, 0] * x + m[i, 1] * y + m[i, 2] * z
                            + m[i, 3] * w for i in range(3)], dim=-1)
    return (torch.einsum("...ij,...j->...i", m[..., :3, :3], p)
            + m[..., :3, 3] * w)


def apply_mat4_h(m: Tensor, p: Tensor) -> Tensor:
    """Transform 3D points to homogeneous 4D clip coordinates."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if m.ndim == 2:
        return torch.stack([m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]
                            for i in range(4)], dim=-1)
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return torch.einsum("...ij,...j->...i", m, ph)


def look_at(eye: Tensor, target: Tensor, up: Tensor) -> Tensor:
    """Right-handed view matrix (the camera looks down -Z in view space)."""
    f = normalize(target - eye)
    s = normalize(cross(f, up))
    u = cross(s, f)
    rot = torch.stack([s, u, -f], dim=-2)
    trans = -torch.einsum("...ij,...j->...i", rot, eye)
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def perspective_reverse_z(fov_y: float, aspect: float, near: float,
                          device) -> Tensor:
    """Infinite-far reverse-Z perspective (depth 1 at near, 0 at infinity)."""
    f = 1.0 / math.tan(0.5 * fov_y)
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 3] = near
    m[3, 2] = -1.0
    return m


def orthographic(left, right, bottom, top, near, far, reverse_z: bool = True,
                 device=None) -> Tensor:
    """Orthographic projection. With reverse_z, depth is 1 at near, 0 at far.
    The bounds may be float32 scalar tensors (their device is used) or
    numbers (then `device` must name it)."""
    b = [x for x in (left, right, bottom, top, near, far) if isinstance(x, Tensor)]
    dev = b[0].device if b else device
    if dev is None:
        raise ValueError("orthographic: no bound is a tensor, so `device` "
                         "must name the device")
    left, right, bottom, top, near, far = (
        torch.as_tensor(x, dtype=torch.float32, device=dev)
        for x in (left, right, bottom, top, near, far))
    m = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    if reverse_z:
        m[2, 2] = 1.0 / (far - near)
        m[2, 3] = far / (far - near)
    else:
        m[2, 2] = -1.0 / (far - near)
        m[2, 3] = -near / (far - near)
    m[3, 3] = 1.0
    return m


def mat4_inverse(m: Tensor) -> Tensor:
    return torch.linalg.inv(m)


# -- AABBs and frustums ---------------------------------------------------------


def aabb_union(min_a: Tensor, max_a: Tensor, min_b: Tensor, max_b: Tensor):
    return torch.minimum(min_a, min_b), torch.maximum(max_a, max_b)


def aabb_overlap(min_a: Tensor, max_a: Tensor, min_b: Tensor, max_b: Tensor) -> Tensor:
    """Batched AABB-AABB overlap test -> bool."""
    return torch.all((min_a <= max_b) & (min_b <= max_a), dim=-1)


def aabb_transform(aabb_min: Tensor, aabb_max: Tensor, position: Tensor,
                   rotation: Tensor):
    """Rotate+translate an AABB; returns the enclosing AABB (|R| extents)."""
    center = 0.5 * (aabb_min + aabb_max)
    extent = 0.5 * (aabb_max - aabb_min)
    r = quat_to_mat3(rotation)
    new_center = quat_rotate(rotation, center) + position
    new_extent = torch.einsum("...ij,...j->...i", torch.abs(r), extent)
    return new_center - new_extent, new_center + new_extent


def frustum_planes(view_proj: Tensor) -> Tensor:
    """Six clip planes (a, b, c, d; inside where ax+by+cz+d >= 0) from a
    view-projection matrix. The reverse-Z infinite far plane is all zeros."""
    r0, r1, r2, r3 = (view_proj[..., 0, :], view_proj[..., 1, :],
                      view_proj[..., 2, :], view_proj[..., 3, :])
    planes = torch.stack([r3 + r0, r3 - r0, r3 + r1, r3 - r1, r2, r3 - r2],
                         dim=-2)
    n = planes[..., :3]
    scale = torch.rsqrt(torch.clamp(torch.sum(n * n, dim=-1), min=1e-20))
    return planes * scale[..., None]


def aabb_outside_frustum(planes: Tensor, aabb_min: Tensor,
                         aabb_max: Tensor) -> Tensor:
    """True where the AABB lies fully outside any (non-degenerate) plane."""
    center = 0.5 * (aabb_min + aabb_max)
    extent = 0.5 * (aabb_max - aabb_min)
    n = planes[..., :3]
    d = planes[..., 3]
    dist = (torch.einsum("...i,pi->...p", center, n)
            + torch.einsum("...i,pi->...p", extent, torch.abs(n)) + d)
    degenerate = torch.all(planes == 0.0, dim=-1)
    return torch.any((dist < 0.0) & ~degenerate, dim=-1)


# -- color ----------------------------------------------------------------------


def srgb_to_linear(c: Tensor) -> Tensor:
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


def linear_to_srgb(c: Tensor) -> Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def luminance(rgb: Tensor) -> Tensor:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
