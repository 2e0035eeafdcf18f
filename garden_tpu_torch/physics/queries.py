"""Ray and shape queries against the body arrays.

Port of `garden_tpu.physics.queries`. One query is tested against every
body analytically and the nearest hit wins:

- `cast_ray`: exact sphere/box/plane/capsule/hull/compound/mesh hits with
  surface normals; heightfields by a fixed-count raymarch.
- `cast_sphere`: a swept sphere, by Minkowski inflation of every shape class
  (inflated face planes for hulls, a fixed-count march for heightfields
  and meshes). On CUDA tensors it launches the hand-written kernel of
  `csrc/queries.cu` (a thread a (cast, body) pair, each computing only its
  body's shape class); on CPU tensors it takes `cast_sphere_plain`. While a
  profiler records, each call charges the open span with `cast_calls` 1 and
  `cast_kernel_calls` 1 when the kernel ran (0 on the CPU).
- `cast_shape`: any table shape swept by conservative advancement over the
  narrowphase's signed pair distances.

Nothing is read back to the host: the nearest hit is picked on the device,
and `cast_shape`'s advancement runs a fixed number of iterations, each a
`torch.where` on the running `done` flag.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.cuda_build import check, launch, on_device, ptr
from garden_tpu_torch.physics import narrowphase as nph
from garden_tpu_torch.physics import shapes as sh

Tensor = torch.Tensor

NO_HIT = 1e30
_UP = (0.0, 1.0, 0.0)


class RayHit(NamedTuple):
    hit: Tensor        # bool
    body: Tensor       # int (-1 if none)
    distance: Tensor   # f32
    point: Tensor      # f32[3]
    normal: Tensor     # f32[3]


def _at(x: Tensor, i: Tensor) -> Tensor:
    """x[i] for a 0-dim index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _rows(x: Tensor, i: Tensor) -> Tensor:
    """x[i] for an index tensor of any shape (0-dim: one row), without
    reading it on the host."""
    return x.index_select(0, i.reshape(-1)).reshape(i.shape + x.shape[1:])


def _col(v):
    """A per-cast tensor with a trailing axis to meet the next axis of the
    (cast, body) arrays; a plain number as it is."""
    return v[..., None] if isinstance(v, Tensor) else v


def _select(conds, vals, default: Tensor) -> Tensor:
    """The first value whose condition holds, else default (jnp.select)."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        while c.ndim < v.ndim:
            c = c[..., None]
        out = torch.where(c, v, out)
    return out


def _safe_div_den(x: Tensor) -> Tensor:
    """x with |x| < 1e-9 replaced by +-1e-9 (keeping the sign)."""
    tiny = torch.where(x < 0, torch.full_like(x, -1e-9), torch.full_like(x, 1e-9))
    return torch.where(torch.abs(x) < 1e-9, tiny, x)


def _ray_sphere(o, d, center, radius):
    oc = o - center
    b = m3.dot(oc, d)
    c = m3.dot(oc, oc) - radius * radius
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    return torch.where((disc >= 0) & (t > 0), t, torch.full_like(t, NO_HIT))


def _ray_box(o, d, center, rot, half):
    """Slab test in the box frame; rot is (..., 3, 3)."""
    ol = torch.einsum("...ji,...j->...i", rot, o - center)
    dl = torch.einsum("...ji,...j->...i", rot, d)
    inv = 1.0 / _safe_div_den(dl)
    t0 = (-half - ol) * inv
    t1 = (half - ol) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = tmax >= torch.clamp(tmin, min=0.0)
    no = torch.full_like(tmin, NO_HIT)
    return torch.where(hit, torch.where(tmin > 0, tmin, no), no)


def _ray_plane(o, d, n, dist):
    denom = m3.dot(d, n)
    small = torch.abs(denom) < 1e-9
    t = -(m3.dot(o, n) + dist) / torch.where(small, torch.full_like(denom, 1e-9), denom)
    return torch.where((torch.abs(denom) > 1e-9) & (t > 0), t, torch.full_like(t, NO_HIT))


def _ray_capsule(o, d, p0, p1, radius):
    """Exact ray against capsule: the infinite cylinder clamped to the
    segment span, and the two sphere caps."""
    axis = p1 - p0
    ll = m3.dot(axis, axis)
    u = axis / torch.sqrt(torch.clamp(ll, min=1e-12))[..., None]
    oc = o - p0
    d_perp = d - u * m3.dot(d, u)[..., None]
    oc_perp = oc - u * m3.dot(oc, u)[..., None]
    a = m3.dot(d_perp, d_perp)
    b = m3.dot(d_perp, oc_perp)
    c = m3.dot(oc_perp, oc_perp) - radius * radius
    disc = b * b - a * c
    t_cyl = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / torch.clamp(a, min=1e-12)
    s = m3.dot(oc + d * t_cyl[..., None], u)
    seg_len = torch.sqrt(torch.clamp(ll, min=1e-12))
    cyl_ok = (disc >= 0) & (a > 1e-12) & (t_cyl > 0) & (s >= 0) & (s <= seg_len)
    t_cyl = torch.where(cyl_ok, t_cyl, torch.full_like(t_cyl, NO_HIT))
    return torch.minimum(t_cyl, torch.minimum(_ray_sphere(o, d, p0, radius),
                                              _ray_sphere(o, d, p1, radius)))


def _hull_world_rows(pos, quat, params, tables):
    hidx = params[..., 0].long() % tables["hull_verts"].shape[0]
    rot = m3.quat_to_mat3(quat)
    verts_w = (torch.einsum("...ij,...kj->...ki", rot, tables["hull_verts"][hidx])
               + pos[..., None, :])
    faces_w = torch.einsum("...ij,...kj->...ki", rot, tables["hull_face_n"][hidx])
    return verts_w, tables["hull_vert_valid"][hidx], faces_w, tables["hull_face_valid"][hidx]


def _hull_support(verts_w, vv, faces_w):
    """Each face plane's offset: max over the valid verts of dot(n_f, v)."""
    dots = torch.einsum("...fi,...pi->...fp", faces_w, verts_w)
    return torch.amax(torch.where(vv[..., None, :], dots, torch.full_like(dots, -1e30)),
                      dim=-1)


def _ray_hull(o, d, pos, quat, params, tables, r=0.0):
    """Ray against a convex polytope by a slab test over its face planes,
    each pushed out by r (0: the hull; r: a conservative swept sphere)."""
    verts_w, vv, faces_w, fv = _hull_world_rows(pos, quat, params, tables)
    d_f = _hull_support(verts_w, vv, faces_w) + r
    no = torch.einsum("...fi,...i->...f", faces_w, o)
    nd = torch.einsum("...fi,...i->...f", faces_w, d)
    # entering planes (nd < 0) give t_near, exiting ones t_far
    t_plane = (d_f - no) / _safe_div_den(nd)
    t_near = torch.amax(torch.where(fv & (nd < 0), t_plane,
                                    torch.full_like(t_plane, -NO_HIT)), dim=-1)
    t_far = torch.amin(torch.where(fv & (nd > 0), t_plane,
                                   torch.full_like(t_plane, NO_HIT)), dim=-1)
    outside_parallel = torch.any(fv & (torch.abs(nd) <= 1e-9) & (no > d_f), dim=-1)
    hit = (t_near <= t_far) & (t_near > 0) & ~outside_parallel
    return torch.where(hit, t_near, torch.full_like(t_near, NO_HIT))


def _ray_heightfield(o, d, pos, quat, params, tables, steps: int = 32,
                     max_distance: float = 1e6):
    """Fixed-count raymarch against the height grid: the first sample below
    the surface, refined by one bisection. The march covers the grid's
    world span, capped at max_distance."""
    rot = m3.quat_to_mat3(quat)
    o_l = torch.einsum("...ji,...j->...i", rot, o - pos)
    d_l = torch.einsum("...ji,...j->...i", rot, d)

    def below(t):
        p = o_l + d_l * t[..., None]
        n_l, p_on, inside = nph._hf_plane_at(p, params, tables)
        return (m3.dot(n_l, p - p_on) < 0.0) & inside

    span = params[..., 1] * torch.maximum(params[..., 2], params[..., 3])
    t_reach = torch.clamp(m3.length(o_l) + (0.5 * span + 1.0) * 1.732, max=max_distance)
    ts = (torch.linspace(0.0, 1.0, steps, device=o.device).reshape((steps,) + (1,) * t_reach.ndim)
          * t_reach)
    shape = o_l.shape[:-1]
    t_hit = torch.full(shape, NO_HIT, device=o.device)
    prev_t = torch.zeros(shape, device=o.device)
    found = torch.zeros(shape, dtype=torch.bool, device=o.device)
    for i in range(steps):
        t = ts[i].expand(shape)
        b = below(t)
        mid = 0.5 * (prev_t + t)
        t_hit = torch.where(b & ~found, torch.where(below(mid), mid, t), t_hit)
        found = found | b
        prev_t = t
    return t_hit


def _compound_children_world_q(pos, quat, params, tables):
    cidx = params[..., 0].long() % tables["comp_type"].shape[0]
    cquat = tables["comp_quat"][cidx]
    q = quat[..., None, :].expand(cquat.shape)
    return (tables["comp_type"][cidx], tables["comp_params"][cidx],
            m3.quat_rotate(q, tables["comp_pos"][cidx]) + pos[..., None, :],
            m3.quat_mul(q, cquat))


def _ray_compound(o, d, pos, quat, params, tables, r=0.0):
    """Ray (inflated by r) against a compound: the nearest child."""
    ctype, cparams, cpos_w, cquat_w = _compound_children_world_q(pos, quat, params, tables)
    t_best = torch.full(pos.shape[:-1], NO_HIT, device=pos.device)
    for k in range(ctype.shape[-1]):
        tk = ctype[..., k]
        pk, qk, prmk = cpos_w[..., k, :], cquat_w[..., k, :], cparams[..., k, :]
        ts = _ray_sphere(o, d, pk, prmk[..., 0] + r)
        tb = _ray_box(o, d, pk, m3.quat_to_mat3(qk), prmk[..., :3] + _col(r))
        axisk = m3.quat_rotate(qk, m3.constant(_UP, pk.device).expand_as(pk))
        tc = _ray_capsule(o, d, pk - axisk * prmk[..., 1:2], pk + axisk * prmk[..., 1:2],
                          prmk[..., 0] + r)
        tkid = _select([tk == sh.SPHERE, tk == sh.BOX, tk == sh.CAPSULE], [ts, tb, tc],
                       torch.full_like(ts, NO_HIT))
        t_best = torch.minimum(t_best, tkid)
    return t_best


def _ray_mesh(o, d, pos, quat, params, tables, steps: int = 32,
              max_t: float = 1e6, inflate=0.0):
    """Ray against a triangle mesh: a fixed-step march through its local
    grid (the ray clipped to the grid's box first), each step testing the
    cell's bucket exactly (Moller-Trumbore). inflate > 0 offsets the
    triangles along their normals (an approximate swept sphere)."""
    rot = m3.quat_to_mat3(quat)
    o_l = torch.einsum("...ji,...j->...i", rot, o - pos)
    d_l = torch.einsum("...ji,...j->...i", rot, d)
    midx = params[..., 0].long() % tables["mesh_info"].shape[0]
    info = tables["mesh_info"][midx]
    origin = info[..., 0:3]
    cell = info[..., 3]
    g_dim = nph._mesh_grid_dim(tables)
    span = cell * g_dim
    inv = 1.0 / _safe_div_den(d_l)
    t0 = (origin - o_l) * inv
    t1 = (origin + span[..., None] - o_l) * inv
    tmin = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=0.0)
    tmax = torch.clamp(torch.amin(torch.maximum(t0, t1), dim=-1), max=max_t)
    misses = tmax <= tmin
    step = (tmax - tmin) / steps
    t_best = torch.full(o_l.shape[:-1], NO_HIT, device=o.device)
    offset = not (isinstance(inflate, (int, float)) and inflate == 0.0)
    for i in range(steps):
        t = tmin + (i + 0.5) * step
        p = o_l + d_l * t[..., None]
        c_idx = torch.clamp(((p - origin) / cell[..., None]).int(), 0, g_dim - 1).long()
        ckey = (c_idx[..., 0] * g_dim + c_idx[..., 1]) * g_dim + c_idx[..., 2]
        bucket = tables["mesh_cells"][midx, ckey]                 # (..., B)
        tri = tables["mesh_tris"][midx[..., None], torch.clamp(bucket, min=0).long()]
        va, vb, vc = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
        if offset:
            off = m3.normalize(m3.cross(vb - va, vc - va)) * inflate
            va, vb, vc = va + off, vb + off, vc + off
        e1 = vb - va
        e2 = vc - va
        dl = d_l[..., None, :]
        pv = m3.cross(dl, e2)
        det = m3.dot(e1, pv)
        inv_det = 1.0 / torch.where(torch.abs(det) < 1e-9, torch.full_like(det, 1e-9), det)
        tv = o_l[..., None, :] - va
        u = m3.dot(tv, pv) * inv_det
        qv = m3.cross(tv, e1)
        v = m3.dot(dl.expand_as(qv), qv) * inv_det
        t_tri = m3.dot(e2, qv) * inv_det
        ok = ((bucket >= 0) & (torch.abs(det) > 1e-9) & (u >= -1e-5) & (v >= -1e-5)
              & (u + v <= 1.0 + 1e-5) & (t_tri > 0.0)
              & (t_tri <= (t + step)[..., None]))    # only hits this step reached
        t_tri = torch.where(ok, t_tri, torch.full_like(t_tri, NO_HIT))
        t_best = torch.minimum(t_best, torch.amin(t_tri, dim=-1))
    return torch.where(misses, torch.full_like(t_best, NO_HIT), t_best)


def _closest_on_segment_single(a0, a1, p):
    d = a1 - a0
    t = m3.dot(p - a0, d) / torch.clamp(m3.dot(d, d), min=1e-12)
    return a0 + d * torch.clamp(t, 0.0, 1.0)[..., None]


def _body_shapes(state):
    b = state["bodies"]
    shape = b["shape"].long()
    return b, state["shapes"], state["shapes"]["type"][shape], state["shapes"]["params"][shape]


def _capsule_axes(b, params):
    axis = m3.quat_rotate(b["quat"], m3.constant(_UP, b["pos"].device).expand_as(b["pos"]))
    return b["pos"] - axis * params[..., 1:2], b["pos"] + axis * params[..., 1:2]


def _face_normal_at(pos, quat, params, tables, p):
    """The hull face whose plane p lies farthest outside of (one point, or
    a leading axis of points and hulls)."""
    verts_w, vv, faces_w, fv = _hull_world_rows(pos, quat, params, tables)
    s_f = torch.einsum("...fi,...i->...f", faces_w, p) - _hull_support(verts_w, vv, faces_w)
    s_f = torch.where(fv, s_f, torch.full_like(s_f, -float("inf")))
    k = torch.argmax(s_f, dim=-1)
    return torch.gather(faces_w, -2, k[..., None, None].expand(k.shape + (1, 3)))[..., 0, :]


def cast_ray(state: Dict[str, Any], origin: Tensor, direction: Tensor,
             max_distance: float = 1e6) -> RayHit:
    """Nearest-hit raycast against all alive bodies."""
    b, shapes_t, stype, params = _body_shapes(state)
    o = origin.expand_as(b["pos"])
    dirn = m3.normalize(direction)
    d = dirn.expand_as(b["pos"])
    rot = m3.quat_to_mat3(b["quat"])
    n_w = m3.quat_rotate(b["quat"], params[..., :3])
    d_w = params[..., 3] - m3.dot(n_w, b["pos"])
    a0, a1 = _capsule_axes(b, params)
    t_sphere = _ray_sphere(o, d, b["pos"], params[..., 0])
    t = _select(
        [stype == sh.SPHERE, stype == sh.BOX, stype == sh.PLANE, stype == sh.CAPSULE,
         stype == sh.HULL, stype == sh.HEIGHTFIELD, stype == sh.COMPOUND,
         stype == sh.MESH],
        [t_sphere, _ray_box(o, d, b["pos"], rot, params[..., :3]),
         _ray_plane(o, d, n_w, d_w), _ray_capsule(o, d, a0, a1, params[..., 0]),
         _ray_hull(o, d, b["pos"], b["quat"], params, shapes_t),
         _ray_heightfield(o, d, b["pos"], b["quat"], params, shapes_t,
                          max_distance=max_distance),
         _ray_compound(o, d, b["pos"], b["quat"], params, shapes_t),
         _ray_mesh(o, d, b["pos"], b["quat"], params, shapes_t, max_t=max_distance)],
        torch.full_like(t_sphere, NO_HIT))
    t = torch.where(b["has"] & (t <= max_distance), t, torch.full_like(t, NO_HIT))

    best = torch.argmin(t)
    t_best = _at(t, best)
    hit = t_best < NO_HIT
    point = origin + dirn * t_best
    # the surface normal at the hit, per shape type
    center = _at(b["pos"], best)
    rot_b = _at(rot, best)
    prm_b = _at(params, best)
    st_b = _at(stype, best)
    p_l = torch.einsum("ji,j->i", rot_b, point - center)
    face = torch.argmin(torch.abs(prm_b[:3]) - torch.abs(p_l))
    n_box = torch.einsum("ij,j->i", rot_b,
                         m3.onehot(face, 3) * torch.sign(m3.select_scalar(p_l, face)))
    n_cap = m3.normalize(point - _closest_on_segment_single(_at(a0, best), _at(a1, best),
                                                            point))
    n_hull = _face_normal_at(center, _at(b["quat"], best), prm_b, shapes_t, point)
    n_hf_l, _, _ = nph._hf_plane_at(p_l, prm_b, shapes_t)
    n_hf = torch.einsum("ij,j->i", rot_b, n_hf_l)
    n_hit = _select(
        [st_b == sh.SPHERE, st_b == sh.PLANE, st_b == sh.BOX, st_b == sh.CAPSULE,
         st_b == sh.HULL, st_b == sh.HEIGHTFIELD],
        [m3.normalize(point - center), _at(n_w, best), n_box, n_cap, n_hull, n_hf],
        m3.normalize(point - center))
    return RayHit(hit=hit, body=torch.where(hit, best, torch.full_like(best, -1)),
                  distance=t_best, point=point, normal=n_hit)


def cast_sphere(state: Dict[str, Any], origin: Tensor, direction: Tensor,
                radius, max_distance=1e6, exclude_body=-1) -> RayHit:
    """Swept-sphere cast: nearest time of impact against all alive bodies,
    by Minkowski inflation of each shape by the radius (boxes by their
    inflated slab, conservative by at most r at the corners).

    Batched: with origin and direction (E, 3), and radius, max_distance and
    exclude_body each a number or an (E,) tensor, E casts run in one pass
    over (E, N) (cast, body) pairs and every field of the hit gains the
    leading E axis; cast e equals the single call with row e's arguments.

    A CUDA origin launches the cast kernel (`cast_sphere_cuda`), a CPU one
    takes `cast_sphere_plain`."""
    fn = on_device("cast_sphere", origin, cast_sphere_cuda, cast_sphere_plain,
                   counter="cast")
    return fn(state, origin, direction, radius, max_distance, exclude_body)


def cast_sphere_plain(state: Dict[str, Any], origin: Tensor, direction: Tensor,
                      radius, max_distance=1e6, exclude_body=-1) -> RayHit:
    """Swept-sphere cast: nearest time of impact against all alive bodies,
    by Minkowski inflation of each shape by the radius (boxes by their
    inflated slab, conservative by at most r at the corners).

    Batched: with origin and direction (E, 3), and radius, max_distance and
    exclude_body each a number or an (E,) tensor, E casts run in one pass
    over (E, N) (cast, body) pairs and every field of the hit gains the
    leading E axis; cast e equals the single call with row e's arguments."""
    b, shapes_t, stype, params = _body_shapes(state)
    lead = origin.shape[:-1]
    bx = lambda x: x.expand(lead + x.shape)       # a body array per cast
    r, md, excl = _col(radius), _col(max_distance), _col(exclude_body)
    rv = _col(r)                                  # against (..., N, 3)
    pos, quat, prm = bx(b["pos"]), bx(b["quat"]), bx(params)
    o = origin[..., None, :].expand(pos.shape)
    dirn = m3.normalize(direction)
    d = dirn[..., None, :].expand(pos.shape)
    up = m3.constant(_UP, o.device)
    rot = m3.quat_to_mat3(b["quat"])
    n_w = m3.quat_rotate(b["quat"], params[..., :3])
    d_w = params[..., 3] - m3.dot(n_w, b["pos"])
    a0, a1 = _capsule_axes(b, params)
    t_sphere = _ray_sphere(o, d, pos, prm[..., 0] + r)
    st = bx(stype)
    t = _select(
        [st == sh.SPHERE, st == sh.BOX, st == sh.PLANE, st == sh.CAPSULE,
         st == sh.HEIGHTFIELD, st == sh.HULL, st == sh.COMPOUND, st == sh.MESH],
        [t_sphere, _ray_box(o, d, pos, bx(rot), prm[..., :3] + rv),
         _ray_plane(o, d, bx(n_w), bx(d_w) + r),
         _ray_capsule(o, d, bx(a0), bx(a1), prm[..., 0] + r),
         # the sphere centre marched against the surface lowered by r
         _ray_heightfield(o - up * rv, d, pos, quat, prm, shapes_t, max_distance=md),
         _ray_hull(o, d, pos, quat, prm, shapes_t, rv),
         _ray_compound(o, d, pos, quat, prm, shapes_t, r=r),
         _ray_mesh(o, d, pos, quat, prm, shapes_t, max_t=md, inflate=_col(rv))],
        torch.full_like(t_sphere, NO_HIT))
    idx = torch.arange(t.shape[-1], device=t.device)
    t = torch.where(bx(b["has"]) & (t <= md) & (idx != excl), t,
                    torch.full_like(t, NO_HIT))

    best = torch.argmin(t, dim=-1)
    t_best = torch.gather(t, -1, best[..., None])[..., 0]
    hit = t_best < NO_HIT
    center_at_hit = origin + dirn * t_best[..., None]
    # the contact normal from the closest point on the uninflated shape
    pos_b = _rows(b["pos"], best)
    rot_b = _rows(rot, best)
    prm_b = _rows(params, best)
    st_b = _rows(stype, best)
    box_l = torch.einsum("...ji,...j->...i", rot_b, center_at_hit - pos_b)
    box_cl = torch.minimum(torch.maximum(box_l, -prm_b[..., :3]), prm_b[..., :3])
    support = _select(
        [st_b == sh.SPHERE, st_b == sh.BOX],
        [pos_b, torch.einsum("...ij,...j->...i", rot_b, box_cl) + pos_b],
        _closest_on_segment_single(_rows(a0, best), _rows(a1, best), center_at_hit))
    n_hull = _face_normal_at(pos_b, _rows(b["quat"], best), prm_b, shapes_t, center_at_hit)
    n_hit = _select([st_b == sh.PLANE, st_b == sh.HEIGHTFIELD, st_b == sh.HULL],
                    [_rows(n_w, best), up.expand_as(pos_b), n_hull],
                    m3.normalize(center_at_hit - support))
    return RayHit(hit=hit, body=torch.where(hit, best, torch.full_like(best, -1)),
                  distance=t_best, point=center_at_hit - n_hit * _col(radius),
                  normal=n_hit)


# -- the kernel (csrc/queries.cu) ----------------------------------------------

def _per_cast(x, lead: tuple, dtype: torch.dtype, dev, name: str) -> Tensor:
    """A per-cast argument, a number or a tensor, as a contiguous (E,)
    tensor of `dtype` on `dev` (a number as a float32 op sees it)."""
    if not isinstance(x, Tensor):
        return torch.full(lead, x, dtype=dtype, device=dev).reshape(-1)
    if x.dtype != dtype or x.device != dev:
        raise ValueError(f"cast_sphere: {name} is {x.dtype} on {x.device}, expected "
                         f"{dtype} on {dev}")
    return torch.broadcast_to(x, lead).contiguous().reshape(-1)


def cast_sphere_cuda(state: Dict[str, Any], origin: Tensor, direction: Tensor,
                     radius, max_distance=1e6, exclude_body=-1) -> RayHit:
    """Launch the swept-sphere cast (csrc/queries.cu: cast_sphere_launch):
    the arguments, batching and hit of `cast_sphere_plain`, one thread a
    (cast, body) pair and one launch a call. The state's arrays are
    contiguous on the origin's card; the origin and direction float32, a
    tensor radius or max_distance float32, a tensor exclude_body int32."""
    b, tab = state["bodies"], state["shapes"]
    dev = origin.device
    if origin.shape[-1:] != (3,) or origin.dtype != torch.float32:
        raise ValueError(f"cast_sphere: origin is {origin.dtype} {tuple(origin.shape)}, "
                         "expected float32 (..., 3)")
    if dev.type != "cuda":
        raise ValueError(f"cast_sphere needs CUDA tensors, got {dev}")
    lead = tuple(origin.shape[:-1])
    e = math.prod(lead)
    n = b["pos"].shape[0]
    if n == 0 or n >= 2 ** 31 or e >= 2 ** 31:
        raise ValueError(f"cast_sphere: {e} casts over {n} bodies")
    if direction.dtype != torch.float32 or direction.device != dev:
        raise ValueError(f"cast_sphere: direction is {direction.dtype} on {direction.device}")
    if not isinstance(exclude_body, Tensor) and not 0 <= exclude_body < n:
        exclude_body = -1   # an index outside the bodies excludes none of them
    o = origin.reshape(e, 3).contiguous()
    d = torch.broadcast_to(direction, lead + (3,)).contiguous().reshape(e, 3)
    r = _per_cast(radius, lead, torch.float32, dev, "radius")
    md = _per_cast(max_distance, lead, torch.float32, dev, "max_distance")
    excl = _per_cast(exclude_body, lead, torch.int32, dev, "exclude_body")
    # a radius of a plain 0 leaves the mesh's triangles unmoved, as
    # cast_sphere_plain's `offset` does
    inflate = isinstance(radius, Tensor) or radius != 0.0

    def table(name, x, dtype, shape):
        check(name, x, dtype, shape, dev, "cast_sphere")
        return ptr(x)

    hv, hf, ct, mt, mc = (tab["hull_verts"], tab["hf_heights"], tab["comp_type"],
                          tab["mesh_tris"], tab["mesh_cells"])
    n_shapes = tab["type"].shape[0]
    n_hulls, hull_nv = hv.shape[:2]
    hull_nf = tab["hull_face_n"].shape[1]
    n_comp, comp_k = ct.shape
    n_mesh, mesh_tris_n = mt.shape[:2]
    mesh_cells_n, mesh_bucket = mc.shape[1:]
    # per cast the complement of its best key and a block counter
    work = torch.zeros(2 * e, dtype=torch.int64, device=dev)
    hit = torch.empty(e, dtype=torch.bool, device=dev)
    body = torch.empty(e, dtype=torch.int64, device=dev)
    distance = torch.empty(e, device=dev)
    point = torch.empty(e, 3, device=dev)
    normal = torch.empty(e, 3, device=dev)
    launch(
        "cast_sphere", dev,
        table("pos", b["pos"], torch.float32, (n, 3)),
        table("quat", b["quat"], torch.float32, (n, 4)),
        table("shape", b["shape"], torch.int32, (n,)),
        table("has", b["has"], torch.bool, (n,)), n,
        table("type", tab["type"], torch.int32, (n_shapes,)),
        table("params", tab["params"], torch.float32, (n_shapes, 4)), n_shapes,
        table("hull_verts", hv, torch.float32, (n_hulls, hull_nv, 3)),
        table("hull_vert_valid", tab["hull_vert_valid"], torch.bool, (n_hulls, hull_nv)),
        table("hull_face_n", tab["hull_face_n"], torch.float32, (n_hulls, hull_nf, 3)),
        table("hull_face_valid", tab["hull_face_valid"], torch.bool, (n_hulls, hull_nf)),
        n_hulls, hull_nv, hull_nf,
        table("hf_heights", hf, torch.float32, (hf.shape[0], hf.shape[1], hf.shape[1])),
        hf.shape[0], hf.shape[1],
        table("comp_type", ct, torch.int32, (n_comp, comp_k)),
        table("comp_params", tab["comp_params"], torch.float32, (n_comp, comp_k, 4)),
        table("comp_pos", tab["comp_pos"], torch.float32, (n_comp, comp_k, 3)),
        table("comp_quat", tab["comp_quat"], torch.float32, (n_comp, comp_k, 4)),
        n_comp, comp_k,
        table("mesh_tris", mt, torch.float32, (n_mesh, mesh_tris_n, 3, 3)),
        table("mesh_cells", mc, torch.int32, (n_mesh, mesh_cells_n, mesh_bucket)),
        table("mesh_info", tab["mesh_info"], torch.float32, (n_mesh, 8)),
        n_mesh, mesh_tris_n, mesh_cells_n, mesh_bucket, nph._mesh_grid_dim(tab),
        ptr(o), ptr(d), ptr(r), ptr(md), ptr(excl), int(inflate), e, ptr(work), ptr(hit),
        ptr(body), ptr(distance), ptr(point), ptr(normal))
    return RayHit(hit=hit.reshape(lead), body=body.reshape(lead),
                  distance=distance.reshape(lead), point=point.reshape(lead + (3,)),
                  normal=normal.reshape(lead + (3,)))


def cast_shape(state: Dict[str, Any], shape_index: int, origin: Tensor,
               rotation: Tensor, direction: Tensor, max_distance: float = 1e6,
               steps: int = 12, exclude_body: int = -1,
               present_types=None) -> RayHit:
    """Swept cast of ShapeTable shape `shape_index` at orientation `rotation`
    from `origin` along `direction`, against every alive body, by
    conservative advancement over the narrowphase's signed pair distances
    (negative penetration is a separation, a lower bound of the distance).
    Sampled kernels (heightfield, mesh) give sampled bounds, so each advance
    is clamped to an eighth of max_distance. `steps` advancement iterations
    run, each a select on the running `done` flag; returns the nearest time
    of impact, the contact normal (swept shape toward the hit body) and the
    contact point."""
    b, shapes_t, stype_all, params_all = _body_shapes(state)
    n = b["pos"].shape[0]
    dev = b["pos"].device
    dirn = m3.normalize(direction)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    pair_i = torch.full((n,), n, dtype=torch.int32, device=dev)
    pair_valid = b["has"] & (idx != exclude_body)
    st = torch.cat([stype_all, shapes_t["type"][shape_index][None]])
    pr = torch.cat([params_all, shapes_t["params"][shape_index][None]])
    quat_all = torch.cat([b["quat"], rotation.to(torch.float32)[None]], dim=0)

    def pair_distances(t):
        pos_all = torch.cat([b["pos"], (origin + dirn * t)[None]], dim=0)
        # a huge margin keeps the raw signed distances ungated
        man = nph.generate_contacts(pos_all, quat_all, st, pr, pair_i, idx, pair_valid,
                                    margin=1e6, present_types=present_types,
                                    tables=shapes_t)
        pen = torch.where(man["pen"] > -1e29, man["pen"],
                          torch.full_like(man["pen"], -1e30))       # (n, 4)
        best_pt = torch.argmax(pen, dim=-1)
        pen_b = torch.amax(pen, dim=-1)
        nrm = m3.select_row(man["normal"], best_pt)
        pt = m3.select_row(man["point"], best_pt)
        # the normal is A -> B in canonical order; flip the rows where the
        # swept shape is B so it points cast -> body
        nrm = torch.where((man["a"] != pair_i)[:, None], -nrm, nrm)
        return pen_b, nrm, pt

    tol = 1e-3
    t = torch.zeros((), device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(steps):
        pen_b, nrm, _ = pair_distances(t)
        sep = torch.clamp(-pen_b, min=0.0)                  # distance lower bound
        vn = m3.dot(dirn.expand_as(nrm), nrm)               # approach rate
        touching = pen_b >= -tol
        adv = torch.where(pair_valid & (vn > 1e-6) & ~touching,
                          sep / torch.clamp(vn, min=1e-6), torch.full_like(sep, NO_HIT))
        hit_now = torch.any(pair_valid & touching)
        dt = torch.clamp(torch.amin(adv), 0.0, max_distance / 8.0)
        t = torch.where(done | hit_now, t, torch.clamp(t + dt, max=max_distance))
        done = done | hit_now
    pen_b, nrm, pt = pair_distances(t)
    pen_b = torch.where(pair_valid, pen_b, torch.full_like(pen_b, -1e30))
    best = torch.argmax(pen_b)
    hit = (_at(pen_b, best) >= -tol) & (t < max_distance)
    return RayHit(hit=hit, body=torch.where(hit, best, torch.full_like(best, -1)),
                  distance=t, point=_at(pt, best), normal=_at(nrm, best))
