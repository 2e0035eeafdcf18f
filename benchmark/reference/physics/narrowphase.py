"""Narrowphase: batched analytic contact generation.

Port of `garden_tpu.physics.narrowphase`. Every pair kernel of the shape
types present runs over the whole candidate pair list, and a select keeps
each pair's own result.

Pairs: sphere, box and capsule against each other and the plane (box-box is
the 15-axis SAT); hull pairs (SAT over both hulls' face normals and the
crosses of their edge directions); heightfield pairs (the surface plane
under candidate points); triangle-mesh pairs (closest point on the
triangles of the point's grid bucket); compound pairs (per-child dispatch,
hull against compound included).

Manifold layout per pair (MAX_POINTS = 4, masked):
- `point`  f32[..., 4, 3]: world contact position
- `normal` f32[..., 4, 3]: unit normal from body A to body B
- `pen`    f32[..., 4]: penetration depth (> 0 overlapping; values in
  (-margin, 0] are speculative contacts)
- `valid`  bool[..., 4]

Two behaviours of the reference are kept on purpose: pairs are evaluated in
canonical (type, index) order, so both rows of a pair get bitwise equal
manifolds; and the top-4 ranking quantizes depth to 1 mm, so a resting
manifold keeps its points while the body rocks by less than that.

Side-table lookups clamp their indices into the table: every kernel of a
present type runs on every pair, and the rows of other types read their
params as indices that may fall outside it (the reference's gathers clamp).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference.core import math3d as m3
from benchmark.reference.physics import shapes as sh

Tensor = torch.Tensor
MAX_POINTS = 4
_FIELDS = ("point", "normal", "pen", "valid")
_CORNER_SIGNS = tuple((sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                      for sz in (-1.0, 1.0))


def _empty_manifold(shape, device) -> Dict[str, Tensor]:
    return {
        "point": torch.zeros(shape + (MAX_POINTS, 3), device=device),
        "normal": torch.zeros(shape + (MAX_POINTS, 3), device=device),
        # finite sentinel, as the reference's
        "pen": torch.full(shape + (MAX_POINTS,), -1e30, device=device),
        "valid": torch.zeros(shape + (MAX_POINTS,), dtype=torch.bool, device=device),
    }


def _manifold(slots) -> Dict[str, Tensor]:
    """A manifold whose first len(slots) points are the given (point,
    normal, pen, valid) and whose others are empty; built out of place, so
    that it batches under vmap."""
    pen0 = slots[0][2]
    empty = _empty_manifold(tuple(pen0.shape), pen0.device)
    out = {}
    for f, field in enumerate(_FIELDS):
        vec = field in ("point", "normal")
        cols = [empty[field][..., i, :] if vec else empty[field][..., i]
                for i in range(MAX_POINTS)]
        cols[:len(slots)] = [torch.broadcast_to(sl[f], cols[0].shape).to(cols[0].dtype)
                             for sl in slots]
        out[field] = torch.stack(cols, dim=-2 if vec else -1)
    return out


def _one_point(point, normal, pen, valid) -> Dict[str, Tensor]:
    return _manifold([(point, normal, pen, valid)])


def _select(shape, device, parts) -> Dict[str, Tensor]:
    """Per-pair select over (condition, manifold) parts; a later part wins
    where conditions overlap, as in the reference."""
    out = _empty_manifold(tuple(shape), device)
    for field in _FIELDS:
        acc = out[field]
        for cond, man in parts:
            c = cond.reshape(cond.shape + (1,) * (acc.ndim - cond.ndim))
            acc = torch.where(c, man[field], acc)
        out[field] = acc
    return out


def _flip(man: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Flip a manifold's normal direction (A <-> B swap)."""
    return dict(man, normal=-man["normal"])


def _expand_margin(margin: Tensor, ndim: int) -> Tensor:
    while margin.ndim < ndim:
        margin = margin[..., None]
    return margin


def _row_index(x: Tensor, size: int) -> Tensor:
    """A float param read as a side-table row, clamped into the table."""
    return torch.clamp(x.long(), 0, size - 1)


def _plane_world(pos_b: Tensor, quat_b: Tensor, params_b: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """Plane local (n, d) -> world (n_w, d_w) with n_w.x + d_w = 0."""
    n_w = m3.quat_rotate(quat_b, params_b[..., :3])
    d_w = params_b[..., 3] - m3.dot(n_w, pos_b)
    return n_w, d_w


def _sign1(x: Tensor) -> Tensor:
    s = torch.sign(x)
    return torch.where(s == 0.0, torch.ones_like(s), s)


def _dot3(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


# -- sphere kernels --------------------------------------------------------------


def sphere_sphere(pa, ra, pb, rb, margin):
    d = pb - pa
    dist = m3.length(d)
    n = d / torch.clamp(dist, min=1e-9)[..., None]
    n = torch.where(dist[..., None] < 1e-9,
                    m3.constant((0.0, 1.0, 0.0), pa.device).expand_as(n), n)
    pen = ra + rb - dist
    # the lever arm is clamped for deep penetrations, so the contact point
    # stays on the body surface even when the centres overlap
    point = pa + n * (ra - 0.5 * torch.clamp(torch.clamp(pen, min=0.0), max=ra))[..., None]
    return _one_point(point, n, pen, pen > -margin)


def sphere_plane(pa, ra, n_w, d_w, margin):
    pen = ra - (m3.dot(n_w, pa) + d_w)
    point = pa - n_w * (ra - 0.5 * torch.clamp(torch.clamp(pen, min=0.0), max=ra))[..., None]
    # normal A (sphere) -> B (plane) points down into the plane
    return _one_point(point, -n_w, pen, pen > -margin)


def sphere_box(pa, ra, pb, qb, half_b, margin):
    """Sphere A against oriented box B."""
    rb = m3.quat_to_mat3(qb)
    c_l = torch.einsum("...ji,...j->...i", rb, pa - pb)       # R^T (pa - pb)
    clamped = torch.minimum(torch.maximum(c_l, -half_b), half_b)
    delta = c_l - clamped
    dist = m3.length(delta)
    outside = dist > 1e-9
    # outside: from the box surface toward the sphere centre
    n_out_l = delta / torch.clamp(dist, min=1e-9)[..., None]
    # inside: out along the axis of least depth
    depth_axis = half_b - torch.abs(c_l)
    axis = torch.argmin(depth_axis, dim=-1)
    sign = _sign1(m3.select_scalar(c_l, axis))
    n_in_l = m3.onehot(axis, 3) * sign[..., None]
    inside_dist = -torch.amin(depth_axis, dim=-1)
    n_l = torch.where(outside[..., None], n_out_l, n_in_l)
    pen = ra - torch.where(outside, dist, inside_dist)
    n_w = torch.einsum("...ij,...j->...i", rb, n_l)           # box -> sphere
    closest_w = torch.einsum("...ij,...j->...i", rb, clamped) + pb
    point = closest_w - n_w * (0.5 * pen)[..., None]
    return _one_point(point, -n_w, pen, pen > -margin)


# -- capsule kernels ---------------------------------------------------------------


def _capsule_segment(p, q, half_height):
    """Capsule world segment endpoints (local Y axis)."""
    axis = m3.quat_rotate(q, m3.constant((0.0, 1.0, 0.0), p.device).expand_as(p))
    return p - axis * half_height[..., None], p + axis * half_height[..., None]


def _closest_on_segment(a0, a1, p):
    d = a1 - a0
    t = m3.dot(p - a0, d) / torch.clamp(m3.dot(d, d), min=1e-12)
    return a0 + d * torch.clamp(t, 0.0, 1.0)[..., None]


def _closest_segment_segment(p1, q1, p2, q2):
    """Closest points between segments (Ericson, RTCD 5.1.9), batched."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = m3.dot(d1, d1)
    e = m3.dot(d2, d2)
    f = m3.dot(d2, r)
    c = m3.dot(d1, r)
    b = m3.dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12,
                    torch.clamp((b * f - c * e) / torch.clamp(denom, min=1e-12), 0.0, 1.0),
                    torch.zeros_like(denom))
    t = (b * s + f) / torch.clamp(e, min=1e-12)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / torch.clamp(a, min=1e-12), 0.0, 1.0)
    return p1 + d1 * s[..., None], p2 + d2 * t_cl[..., None]


def capsule_plane(pa, qa, ra, hha, n_w, d_w, margin):
    """Two sphere contacts at the capsule segment's ends."""
    slots = []
    for e in _capsule_segment(pa, qa, hha):
        pen = ra - (m3.dot(n_w, e) + d_w)
        slots.append((e - n_w * (ra - 0.5 * pen)[..., None], -n_w, pen, pen > -margin))
    return _manifold(slots)


def capsule_capsule(pa, qa, ra, hha, pb, qb, rb, hhb, margin):
    a0, a1 = _capsule_segment(pa, qa, hha)
    b0, b1 = _capsule_segment(pb, qb, hhb)
    ca, cb = _closest_segment_segment(a0, a1, b0, b1)
    return sphere_sphere(ca, ra, cb, rb, margin)


def capsule_sphere(pa, qa, ra, hha, pb, rb, margin):
    a0, a1 = _capsule_segment(pa, qa, hha)
    return sphere_sphere(_closest_on_segment(a0, a1, pb), ra, pb, rb, margin)


def capsule_box(pa, qa, ra, hha, pb, qb, half_b, margin):
    """Sphere-box contacts at both segment ends and at the segment point
    closest to the box centre, merged (the deepest 4)."""
    a0, a1 = _capsule_segment(pa, qa, hha)
    ca = _closest_on_segment(a0, a1, pb)
    return _merge_top4([sphere_box(e, ra, pb, qb, half_b, margin) for e in (a0, a1, ca)])


# -- box kernels ------------------------------------------------------------------


def _box_corners_world(p: Tensor, q: Tensor, half: Tensor) -> Tensor:
    """(..., 8, 3) world corners of oriented boxes."""
    r = m3.quat_to_mat3(q)
    ax = r[..., :, 0] * half[..., 0:1]
    ay = r[..., :, 1] * half[..., 1:2]
    az = r[..., :, 2] * half[..., 2:3]
    s = m3.constant(_CORNER_SIGNS, p.device)
    return (p[..., None, :] + s[:, 0:1] * ax[..., None, :]
            + s[:, 1:2] * ay[..., None, :] + s[:, 2:3] * az[..., None, :])


def _top4_sorted(pen: Tensor, columns: List[Tensor]) -> Tuple[Tensor, List[Tensor]]:
    """The 4 deepest candidates of `pen` (..., n) with their payload
    columns, padded with invalid candidates when fewer than 4 come in.
    Depth ranks in 1 mm buckets; ties keep enumeration order."""
    n = pen.shape[-1]
    if n < MAX_POINTS:
        pad = pen.shape[:-1] + (MAX_POINTS - n,)
        pen = torch.cat([pen, torch.full(pad, -1e30, dtype=pen.dtype,
                                         device=pen.device)], dim=-1)
        columns = [torch.cat([c, torch.zeros(pad, dtype=c.dtype, device=c.device)],
                             dim=-1) for c in columns]
    rank = torch.ceil(pen * 1e3)
    order = torch.sort(-rank, dim=-1, stable=True).indices[..., :MAX_POINTS]
    return (torch.gather(pen, -1, order),
            [torch.gather(c, -1, order) for c in columns])


def _top4_manifold(pen: Tensor, point: Tensor, normal: Tensor,
                   flip_normal: bool = False) -> Dict[str, Tensor]:
    """Manifold of the 4 deepest candidates; pen (..., n) already holds
    -1e30 for invalid candidates, point/normal are (..., n, 3)."""
    cols = [point[..., i] for i in range(3)] + [normal[..., i] for i in range(3)]
    top_pen, out = _top4_sorted(pen, cols)
    nrm = torch.stack(out[3:6], dim=-1)
    return {"pen": top_pen, "point": torch.stack(out[0:3], dim=-1),
            "normal": -nrm if flip_normal else nrm, "valid": top_pen > -1e29}


def _merge_top4(manifolds) -> Dict[str, Tensor]:
    """Merge several manifolds into one, keeping the 4 deepest valid points."""
    pen = torch.cat([torch.where(m["valid"], m["pen"], torch.full_like(m["pen"], -1e30))
                     for m in manifolds], dim=-1)
    point = torch.cat([m["point"] for m in manifolds], dim=-2)
    normal = torch.cat([m["normal"] for m in manifolds], dim=-2)
    return _top4_manifold(pen, point, normal)


def box_plane(pa, qa, half_a, n_w, d_w, margin) -> Dict[str, Tensor]:
    corners = _box_corners_world(pa, qa, half_a)          # (..., 8, 3)
    pen = -(_dot3(corners, n_w[..., None, :]) + d_w[..., None])
    pen = torch.where(pen > -margin[..., None], pen, torch.full_like(pen, -1e30))
    nrm = (-n_w)[..., None, :].expand(corners.shape)
    return _top4_manifold(pen, corners, nrm)


def box_box(pa, qa, half_a, pb, qb, half_b, margin) -> Dict[str, Tensor]:
    """Full-SAT box manifold over 6 face normals and 9 edge-cross axes.

    Face case: per-corner depths past the opposing face, deepest 4 kept.
    Edge case: one contact between the two supporting edges. The edge axis
    wins only when clearly more separating (face bias against flip-flop)."""
    ra = m3.quat_to_mat3(qa)
    rb = m3.quat_to_mat3(qb)
    d = pb - pa
    a_cols = ra.transpose(-1, -2)          # rows = A's axes
    b_cols = rb.transpose(-1, -2)
    axes = torch.cat([a_cols, b_cols], dim=-2)            # (..., 6, 3)

    def proj_radius(cols, half, axis):
        acc = 0.0
        for a_i in range(3):
            acc = acc + half[..., a_i, None] * torch.abs(
                _dot3(cols[..., a_i, None, :], axis))
        return acc

    r_a = proj_radius(a_cols, half_a, axes)
    r_b = proj_radius(b_cols, half_b, axes)
    dist = _dot3(axes, d[..., None, :])
    overlap = r_a + r_b - torch.abs(dist)                 # (..., 6)

    ecross = m3.cross(a_cols[..., :, None, :], b_cols[..., None, :, :])
    ecross = ecross.reshape(ecross.shape[:-3] + (9, 3))
    elen = m3.length(ecross)
    eaxes = ecross / torch.clamp(elen, min=1e-9)[..., None]
    er_a = proj_radius(a_cols, half_a, eaxes)
    er_b = proj_radius(b_cols, half_b, eaxes)
    edist = _dot3(eaxes, d[..., None, :])
    eoverlap = torch.where(elen < 1e-6, torch.full_like(elen, 1e30),
                           er_a + er_b - torch.abs(edist))

    all_overlap = torch.cat([overlap, eoverlap], dim=-1)
    separated = torch.any(all_overlap < -margin[..., None], dim=-1)

    best_face = torch.argmin(overlap, dim=-1)
    face_overlap = m3.select_scalar(overlap, best_face)
    best_edge = torch.argmin(eoverlap, dim=-1)
    edge_overlap = m3.select_scalar(eoverlap, best_edge)
    use_edge = edge_overlap < face_overlap * 0.95 - 0.01

    # face-axis manifold
    n = m3.select_row(axes, best_face) * _sign1(m3.select_scalar(dist, best_face))[..., None]
    rn_a = m3.select_scalar(r_a, best_face)
    rn_b = m3.select_scalar(r_b, best_face)
    corners_a = _box_corners_world(pa, qa, half_a)
    corners_b = _box_corners_world(pb, qb, half_b)
    pen_b = rn_a[..., None] - _dot3(corners_b - pa[..., None, :], n[..., None, :])
    pen_a = rn_b[..., None] + _dot3(corners_a - pb[..., None, :], n[..., None, :])
    pen = torch.cat([pen_b, pen_a], dim=-1)               # (..., 16)
    point = torch.cat([corners_b, corners_a], dim=-2)
    top_pen, cols4 = _top4_sorted(pen, [point[..., 0], point[..., 1], point[..., 2]])
    face_point = torch.stack(cols4, dim=-1)

    # edge-axis contact
    en = m3.select_row(eaxes, best_edge) * _sign1(m3.select_scalar(edist, best_edge))[..., None]
    ei = torch.div(best_edge, 3, rounding_mode="floor")   # edge direction on A
    ej = best_edge % 3                                    # edge direction on B
    dir_a = m3.select_row(a_cols, ei)
    dir_b = m3.select_row(b_cols, ej)
    sup_a = torch.zeros_like(pa)
    sup_b = torch.zeros_like(pb)
    for k in range(3):
        ak = a_cols[..., k, :]
        bk = b_cols[..., k, :]
        sa = _sign1(m3.dot(ak, en))
        sb = _sign1(m3.dot(bk, -en))
        sup_a = sup_a + torch.where((ei == k)[..., None], torch.zeros_like(ak),
                                    (sa * half_a[..., k])[..., None] * ak)
        sup_b = sup_b + torch.where((ej == k)[..., None], torch.zeros_like(bk),
                                    (sb * half_b[..., k])[..., None] * bk)
    ha_i = m3.select_scalar(half_a, ei)
    hb_j = m3.select_scalar(half_b, ej)
    ea0 = pa + sup_a - dir_a * ha_i[..., None]
    ea1 = pa + sup_a + dir_a * ha_i[..., None]
    eb0 = pb + sup_b - dir_b * hb_j[..., None]
    eb1 = pb + sup_b + dir_b * hb_j[..., None]
    ca, cb = _closest_segment_segment(ea0, ea1, eb0, eb1)
    edge_point = 0.5 * (ca + cb)

    # merge
    ue = use_edge[..., None]
    edge_pen = torch.cat([edge_overlap[..., None],
                          torch.full_like(top_pen[..., 1:], -1e30)], dim=-1)
    out_pen = torch.where(ue, edge_pen, top_pen)
    return {
        "pen": out_pen,
        "point": torch.where(ue[..., None], edge_point[..., None, :], face_point),
        "normal": torch.where(ue[..., None], en[..., None, :],
                              n[..., None, :]).expand(face_point.shape),
        "valid": (out_pen > -margin[..., None]) & ~separated[..., None],
    }


# -- convex hull kernels ------------------------------------------------------------
#
# Hulls are point clouds with outward face normals from the side tables. The
# contact follows the box path: SAT over both hulls' face normals plus the
# crosses of each hull's distinct edge directions, then the vertices past
# the opposing support plane.


def _rotate_rows(rot: Tensor, rows: Tensor) -> Tensor:
    """rot (..., 3, 3) applied to each row of rows (..., k, 3)."""
    return torch.einsum("...ij,...kj->...ki", rot, rows)


def _hull_world(p, q, params, tables):
    """World-space hull data of a batch of pairs: verts (..., HV, 3) with
    validity, face normals (..., HF, 3) with validity."""
    hidx = _row_index(params[..., 0], tables["hull_verts"].shape[0])
    rot = m3.quat_to_mat3(q)
    verts_w = _rotate_rows(rot, tables["hull_verts"][hidx]) + p[..., None, :]
    faces_w = _rotate_rows(rot, tables["hull_face_n"][hidx])
    return (verts_w, tables["hull_vert_valid"][hidx], faces_w,
            tables["hull_face_valid"][hidx])


def _cloud_cloud(pts_a, va, axes_a, fa, pts_b, vb, axes_b, fb, d_ab, margin,
                 edges_a=None, ea_valid=None, edges_b=None, eb_valid=None):
    """Generic convex-cloud SAT manifold. pts/axes are world-space with
    validity masks; d_ab = pb - pa orients the normal A -> B. edges_a/edges_b:
    optional (..., E, 3) distinct edge directions, whose pairwise crosses
    join the axis set."""
    axes_list = [axes_a, axes_b]
    valid_list = [fa, fb]
    if edges_a is not None and edges_b is not None:
        cross = m3.cross(edges_a[..., :, None, :], edges_b[..., None, :, :])
        cl = m3.length(cross)
        e_sh = cross.shape[:-3] + (cross.shape[-3] * cross.shape[-2], 3)
        cross = (cross / torch.clamp(cl, min=1e-9)[..., None]).reshape(e_sh)
        cvalid = ((ea_valid[..., :, None] & eb_valid[..., None, :])
                  & (cl > 1e-6)).reshape(e_sh[:-1])
        axes_list.append(cross)
        valid_list.append(cvalid)
    axes = torch.cat(axes_list, dim=-2)                 # (..., F, 3)
    avalid = torch.cat(valid_list, dim=-1)

    def project(pts, valid):
        dots = torch.einsum("...fi,...pi->...fp", axes, pts)
        lo = torch.amin(torch.where(valid[..., None, :], dots,
                                    torch.full_like(dots, 1e30)), dim=-1)
        hi = torch.amax(torch.where(valid[..., None, :], dots,
                                    torch.full_like(dots, -1e30)), dim=-1)
        return lo, hi

    lo_a, hi_a = project(pts_a, va)
    lo_b, hi_b = project(pts_b, vb)
    overlap = torch.minimum(hi_a, hi_b) - torch.maximum(lo_a, lo_b)
    overlap = torch.where(avalid, overlap, torch.full_like(overlap, 1e30))

    separated = torch.any(overlap < -_expand_margin(margin, overlap.ndim - 1)[..., None],
                          dim=-1)
    best = torch.argmin(overlap, dim=-1)
    best_overlap = m3.select_scalar(overlap, best)
    axis = m3.select_row(axes, best)
    n = axis * _sign1(m3.dot(axis, d_ab))[..., None]     # A -> B

    # support planes along n: A's far side toward B, B's far side toward A
    proj_a = torch.einsum("...pi,...i->...p", pts_a, n)
    proj_b = torch.einsum("...pi,...i->...p", pts_b, n)
    sup_a = torch.amax(torch.where(va, proj_a, torch.full_like(proj_a, -1e30)), dim=-1)
    sup_b = torch.amin(torch.where(vb, proj_b, torch.full_like(proj_b, 1e30)), dim=-1)
    pen_b = torch.where(vb, sup_a[..., None] - proj_b, torch.full_like(proj_b, -1e30))
    pen_a = torch.where(va, proj_a - sup_b[..., None], torch.full_like(proj_a, -1e30))
    # each point's depth is capped at the SAT overlap
    pen = torch.minimum(torch.cat([pen_b, pen_a], dim=-1), best_overlap[..., None])
    point = torch.cat([pts_b, pts_a], dim=-2)
    marg = _expand_margin(margin, pen.ndim - 1)[..., None]
    pen = torch.where((pen > -marg) & ~separated[..., None], pen,
                      torch.full_like(pen, -1e30))
    top_pen, cols4 = _top4_sorted(pen, [point[..., 0], point[..., 1], point[..., 2]])
    pt4 = torch.stack(cols4, dim=-1)
    return {"pen": top_pen, "point": pt4,
            "normal": n[..., None, :].expand(pt4.shape),
            "valid": top_pen > -1e29}


def _box_cloud(p, q, half):
    """A box as a point cloud: 8 world corners and 3 face axes, all valid."""
    shape = tuple(p.shape[:-1])
    return (_box_corners_world(p, q, half),
            torch.ones(shape + (8,), dtype=torch.bool, device=p.device),
            m3.quat_to_mat3(q).transpose(-1, -2),
            torch.ones(shape + (3,), dtype=torch.bool, device=p.device))


def _hull_world_edges(q, params, tables):
    """World-rotated distinct edge directions of a hull (..., E, 3)."""
    hidx = _row_index(params[..., 0], tables["hull_edge_dirs"].shape[0])
    return (_rotate_rows(m3.quat_to_mat3(q), tables["hull_edge_dirs"][hidx]),
            tables["hull_edge_valid"][hidx])


def hull_hull(pa, qa, prm_a, pb, qb, prm_b, tables, margin):
    va_pts, va, fa_n, fa = _hull_world(pa, qa, prm_a, tables)
    vb_pts, vb, fb_n, fb = _hull_world(pb, qb, prm_b, tables)
    ea, eav = _hull_world_edges(qa, prm_a, tables)
    eb, ebv = _hull_world_edges(qb, prm_b, tables)
    return _cloud_cloud(va_pts, va, fa_n, fa, vb_pts, vb, fb_n, fb, pb - pa, margin,
                        edges_a=ea, ea_valid=eav, edges_b=eb, eb_valid=ebv)


def box_hull(pa, qa, half_a, pb, qb, prm_b, tables, margin):
    a_pts, av, a_axes, af = _box_cloud(pa, qa, half_a)
    b_pts, bv, b_axes, bf = _hull_world(pb, qb, prm_b, tables)
    eb, ebv = _hull_world_edges(qb, prm_b, tables)
    # the box's edge directions are its 3 axes
    return _cloud_cloud(a_pts, av, a_axes, af, b_pts, bv, b_axes, bf, pb - pa, margin,
                        edges_a=a_axes, ea_valid=af, edges_b=eb, eb_valid=ebv)


def sphere_hull(pa, ra, pb, qb, prm_b, tables, margin):
    """Face-region contact: the hull face plane the sphere centre lies
    farthest outside of."""
    verts_w, vv, faces_w, fv = _hull_world(pb, qb, prm_b, tables)
    dots = torch.einsum("...fi,...pi->...fp", faces_w, verts_w)
    d_f = torch.amax(torch.where(vv[..., None, :], dots, torch.full_like(dots, -1e30)),
                     dim=-1)
    s_f = torch.einsum("...fi,...i->...f", faces_w, pa) - d_f
    s_f = torch.where(fv, s_f, torch.full_like(s_f, -1e30))
    best = torch.argmax(s_f, dim=-1)
    s = m3.select_scalar(s_f, best)
    n = m3.select_row(faces_w, best)
    pen = ra - s
    point = pa - n * (ra - 0.5 * torch.clamp(torch.clamp(pen, min=0.0), max=ra))[..., None]
    return _one_point(point, -n, pen, pen > -margin)


def capsule_hull(pa, qa, ra, hha, pb, qb, prm_b, tables, margin):
    """Both endpoint spheres against the hull (a 2-point manifold)."""
    slots = []
    for e in _capsule_segment(pa, qa, hha):
        src = sphere_hull(e, ra, pb, qb, prm_b, tables, margin)
        slots.append((src["point"][..., 0, :], src["normal"][..., 0, :],
                      src["pen"][..., 0], src["valid"][..., 0]))
    return _manifold(slots)


def hull_plane(pa, qa, prm_a, n_w, d_w, tables, margin):
    """Hull vertices below the plane, deepest 4."""
    verts_w, vv, _, _ = _hull_world(pa, qa, prm_a, tables)
    s = torch.einsum("...pi,...i->...p", verts_w, n_w) + d_w[..., None]
    marg = _expand_margin(margin, s.ndim - 1)[..., None]
    pen = torch.where(vv & (-s > -marg), -s, torch.full_like(s, -1e30))
    nrm = (-n_w)[..., None, :].expand(verts_w.shape)
    return _top4_manifold(pen, verts_w, nrm)


# -- heightfield kernels -------------------------------------------------------------
#
# The heightfield is sampled under candidate points of the other body: each
# sample takes the 2-triangle cell beneath the point and gives a plane
# contact against that triangle (no side-wall contacts).


def _hf_plane_at(p_l, params_b, tables):
    """Local surface plane under local points p_l: (normal_l, point on the
    plane, inside-grid mask). Grid centred on the local origin."""
    shp = p_l.shape[:-1]
    h = tables["hf_heights"]
    hidx = _row_index(params_b[..., 0], h.shape[0]).expand(shp)
    cell = params_b[..., 1].expand(shp)
    nx = params_b[..., 2].expand(shp)
    nz = params_b[..., 3].expand(shp)
    gx = p_l[..., 0] / cell + (nx - 1.0) * 0.5
    gz = p_l[..., 2] / cell + (nz - 1.0) * 0.5
    inside = (gx >= 0.0) & (gx <= nx - 1.0) & (gz >= 0.0) & (gz <= nz - 1.0)
    ix = torch.minimum(torch.clamp(torch.floor(gx), min=0.0), nx - 2.0).int()
    iz = torch.minimum(torch.clamp(torch.floor(gz), min=0.0), nz - 2.0).int()
    fx = torch.clamp(gx - ix, 0.0, 1.0)
    fz = torch.clamp(gz - iz, 0.0, 1.0)
    dim = h.shape[1]
    ixl = torch.clamp(ix.long(), 0, dim - 2)
    izl = torch.clamp(iz.long(), 0, dim - 2)
    h00 = h[hidx, izl, ixl]
    h10 = h[hidx, izl, ixl + 1]
    h01 = h[hidx, izl + 1, ixl]
    h11 = h[hidx, izl + 1, ixl + 1]
    # two triangles per cell, split along fx + fz = 1
    lower = fx + fz <= 1.0
    nrm1 = torch.stack([-(h10 - h00), cell, -(h01 - h00)], dim=-1)
    nrm2 = torch.stack([-(h11 - h01), cell, -(h11 - h10)], dim=-1)
    n_l = m3.normalize(torch.where(lower[..., None], nrm1, nrm2))
    x0 = (ix.float() - (nx - 1.0) * 0.5) * cell
    z0 = (iz.float() - (nz - 1.0) * 0.5) * cell
    p1 = torch.stack([x0, h00, z0], dim=-1)
    p2 = torch.stack([x0 + cell, h11, z0 + cell], dim=-1)
    return n_l, torch.where(lower[..., None], p1, p2), inside


def _points_vs_heightfield(points_w, pvalid, radius, pb, qb, prm_b, tables, margin):
    """Plane contacts of candidate points (..., P, 3) (sphere radius per
    point, 0 for corners and vertices) against the heightfield body at
    (pb, qb); top-4 manifold, normals A -> B (down into the terrain)."""
    rot = m3.quat_to_mat3(qb)
    p_l = torch.einsum("...ji,...pj->...pi", rot, points_w - pb[..., None, :])
    n_l, p_on, inside = _hf_plane_at(p_l, prm_b[..., None, :], tables)
    pen = radius - m3.dot(n_l, p_l - p_on)
    marg = _expand_margin(margin, pen.ndim)
    pen = torch.where(pvalid & inside & (pen > -marg), pen, torch.full_like(pen, -1e30))
    n_w = torch.einsum("...ij,...pj->...pi", rot, n_l)
    point = points_w - n_w * radius[..., None]
    return _top4_manifold(pen, point, n_w, flip_normal=True)


def _all_valid(pts: Tensor) -> Tensor:
    return torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)


def sphere_heightfield(pa, ra, pb, qb, prm_b, tables, margin):
    pts = pa[..., None, :]
    return _points_vs_heightfield(pts, _all_valid(pts), ra[..., None],
                                  pb, qb, prm_b, tables, margin)


def capsule_heightfield(pa, qa, ra, hha, pb, qb, prm_b, tables, margin):
    pts = torch.stack(_capsule_segment(pa, qa, hha), dim=-2)
    return _points_vs_heightfield(pts, _all_valid(pts),
                                  ra[..., None].expand(pts.shape[:-1]),
                                  pb, qb, prm_b, tables, margin)


def box_heightfield(pa, qa, half_a, pb, qb, prm_b, tables, margin):
    pts = _box_corners_world(pa, qa, half_a)
    return _points_vs_heightfield(pts, _all_valid(pts),
                                  torch.zeros(pts.shape[:-1], device=pts.device),
                                  pb, qb, prm_b, tables, margin)


def hull_heightfield(pa, qa, prm_a, pb, qb, prm_b, tables, margin):
    pts, pvalid, _, _ = _hull_world(pa, qa, prm_a, tables)
    return _points_vs_heightfield(pts, pvalid,
                                  torch.zeros(pts.shape[:-1], device=pts.device),
                                  pb, qb, prm_b, tables, margin)


# -- compound kernels ------------------------------------------------------------------
#
# A compound is up to MAX_CHILDREN sphere/box/capsule children at local
# offsets. Its contact is the union of the per-child manifolds, deepest 4
# kept; compound against compound runs every child pair.


def _convex_pair(ta, pa, qa, prm_a, tb, pb, qb, prm_b, margin, present):
    """Manifold between two convex primitives whose types are per-pair
    values in {SPHERE, BOX, CAPSULE}; `present` bounds the kernel set."""
    types = present & {sh.SPHERE, sh.BOX, sh.CAPSULE}
    parts = []
    if sh.SPHERE in types:
        parts.append(((ta == sh.SPHERE) & (tb == sh.SPHERE),
                      sphere_sphere(pa, prm_a[..., 0], pb, prm_b[..., 0], margin)))
    if sh.SPHERE in types and sh.BOX in types:
        parts.append(((ta == sh.SPHERE) & (tb == sh.BOX),
                      sphere_box(pa, prm_a[..., 0], pb, qb, prm_b[..., :3], margin)))
        parts.append(((ta == sh.BOX) & (tb == sh.SPHERE),
                      _flip(sphere_box(pb, prm_b[..., 0], pa, qa, prm_a[..., :3],
                                       margin))))
    if sh.SPHERE in types and sh.CAPSULE in types:
        parts.append(((ta == sh.SPHERE) & (tb == sh.CAPSULE),
                      _flip(capsule_sphere(pb, qb, prm_b[..., 0], prm_b[..., 1],
                                           pa, prm_a[..., 0], margin))))
        parts.append(((ta == sh.CAPSULE) & (tb == sh.SPHERE),
                      capsule_sphere(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                     pb, prm_b[..., 0], margin)))
    if sh.BOX in types:
        parts.append(((ta == sh.BOX) & (tb == sh.BOX),
                      box_box(pa, qa, prm_a[..., :3], pb, qb, prm_b[..., :3], margin)))
    if sh.BOX in types and sh.CAPSULE in types:
        parts.append(((ta == sh.BOX) & (tb == sh.CAPSULE),
                      _flip(capsule_box(pb, qb, prm_b[..., 0], prm_b[..., 1],
                                        pa, qa, prm_a[..., :3], margin))))
        parts.append(((ta == sh.CAPSULE) & (tb == sh.BOX),
                      capsule_box(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                  pb, qb, prm_b[..., :3], margin)))
    if sh.CAPSULE in types:
        parts.append(((ta == sh.CAPSULE) & (tb == sh.CAPSULE),
                      capsule_capsule(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                      pb, qb, prm_b[..., 0], prm_b[..., 1], margin)))
    return _select(pa.shape[:-1], pa.device, parts)


def _compound_children_world(pb, qb, prm_b, tables):
    """World pose and type/params of each compound child slot."""
    cidx = _row_index(prm_b[..., 0], tables["comp_type"].shape[0])
    cquat_l = tables["comp_quat"][cidx]
    qb_k = qb[..., None, :].expand(cquat_l.shape)
    cpos_w = pb[..., None, :] + m3.quat_rotate(qb_k, tables["comp_pos"][cidx])
    return (tables["comp_type"][cidx], tables["comp_params"][cidx], cpos_w,
            m3.quat_mul(qb_k, cquat_l))


def _child(ctype, cparams, cpos_w, cquat_w, k):
    return ctype[..., k], cpos_w[..., k, :], cquat_w[..., k, :], cparams[..., k, :]


def convex_compound(ta, pa, qa, prm_a, pb, qb, prm_b, tables, margin, present):
    """Convex primitive A against compound B: _convex_pair per child, merged."""
    children = _compound_children_world(pb, qb, prm_b, tables)
    mans = []
    for k in range(sh.MAX_CHILDREN):
        tk, pk, qk, prmk = _child(*children, k)
        man = _convex_pair(ta, pa, qa, prm_a, tk, pk, qk, prmk, margin, present)
        man["valid"] = man["valid"] & (tk != sh.EMPTY)[..., None]
        mans.append(man)
    return _merge_top4(mans)


def compound_compound(pa, qa, prm_a, pb, qb, prm_b, tables, margin, present):
    """Compound A against compound B: every child pair through _convex_pair,
    deepest 4 kept."""
    ch_a = _compound_children_world(pa, qa, prm_a, tables)
    ch_b = _compound_children_world(pb, qb, prm_b, tables)
    mans = []
    for i in range(sh.MAX_CHILDREN):
        ti, pi, qi, prmi = _child(*ch_a, i)
        for j in range(sh.MAX_CHILDREN):
            tj, pj, qj, prmj = _child(*ch_b, j)
            man = _convex_pair(ti, pi, qi, prmi, tj, pj, qj, prmj, margin, present)
            man["valid"] = man["valid"] & ((ti != sh.EMPTY) & (tj != sh.EMPTY))[..., None]
            mans.append(man)
    return _merge_top4(mans)


def compound_plane(pa, qa, prm_a, n_w, d_w, tables, margin, present):
    """Compound A against plane B: the plane kernel of each child, merged."""
    children = _compound_children_world(pa, qa, prm_a, tables)
    mans = []
    for k in range(sh.MAX_CHILDREN):
        tk, pk, qk, prmk = _child(*children, k)
        parts = []
        if sh.SPHERE in present:
            parts.append((tk == sh.SPHERE, sphere_plane(pk, prmk[..., 0], n_w, d_w,
                                                        margin)))
        if sh.BOX in present:
            parts.append((tk == sh.BOX, box_plane(pk, qk, prmk[..., :3], n_w, d_w,
                                                  margin)))
        if sh.CAPSULE in present:
            parts.append((tk == sh.CAPSULE, capsule_plane(pk, qk, prmk[..., 0],
                                                          prmk[..., 1], n_w, d_w,
                                                          margin)))
        mans.append(_select(pa.shape[:-1], pa.device, parts))
    return _merge_top4(mans)


def _compound_vs(pa, qa, prm_a, tables, per_child):
    """Merge of per_child(type, pos, quat, params) over A's children, each
    a select among the sphere, box and capsule manifolds it returns."""
    children = _compound_children_world(pa, qa, prm_a, tables)
    mans = []
    for k in range(sh.MAX_CHILDREN):
        tk, pk, qk, prmk = _child(*children, k)
        s_m, b_m, c_m = per_child(pk, qk, prmk)
        mans.append(_select(pa.shape[:-1], pa.device,
                            ((tk == sh.SPHERE, s_m), (tk == sh.BOX, b_m),
                             (tk == sh.CAPSULE, c_m))))
    return _merge_top4(mans)


def compound_heightfield(pa, qa, prm_a, pb, qb, prm_b, tables, margin):
    """Compound A against heightfield B: each child's support points."""
    return _compound_vs(pa, qa, prm_a, tables, lambda pk, qk, prmk: (
        sphere_heightfield(pk, prmk[..., 0], pb, qb, prm_b, tables, margin),
        box_heightfield(pk, qk, prmk[..., :3], pb, qb, prm_b, tables, margin),
        capsule_heightfield(pk, qk, prmk[..., 0], prmk[..., 1], pb, qb, prm_b,
                            tables, margin)))


def hull_compound(pa, qa, prm_a, pb, qb, prm_b, tables, margin, present):
    """Hull A against compound B: each child against the hull with the
    convex-hull kernels, normals flipped to point A (hull) -> B."""
    return _compound_vs(pb, qb, prm_b, tables, lambda pk, qk, prmk: (
        _flip(sphere_hull(pk, prmk[..., 0], pa, qa, prm_a, tables, margin)),
        _flip(box_hull(pk, qk, prmk[..., :3], pa, qa, prm_a, tables, margin)),
        _flip(capsule_hull(pk, qk, prmk[..., 0], prmk[..., 1], pa, qa, prm_a,
                           tables, margin))))


# -- triangle-mesh kernels -----------------------------------------------------------------
#
# Candidate points (sphere centre, capsule points, box corners, hull verts)
# look up their grid cell's bucket and test its triangles with a branch-free
# closest point on the triangle; the deepest 4 contacts survive. One-sided:
# contacts push out of the front (CCW) face, and a back-side capture is
# capped at half a grid cell.


def _closest_on_triangle(p, a, b, c):
    """Branch-free closest point on triangle abc to p (Ericson 5.1.5)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = m3.dot(ab, ap)
    d2 = m3.dot(ac, ap)
    bp = p - b
    d3 = m3.dot(ab, bp)
    d4 = m3.dot(ac, bp)
    cp = p - c
    d5 = m3.dot(ab, cp)
    d6 = m3.dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-12)
    interior = a + ab * (vb / denom)[..., None] + ac * (vc / denom)[..., None]

    def safe(x):
        return torch.where(torch.abs(x) < 1e-12, torch.full_like(x, 1e-12), x)
    on_ab = a + ab * torch.clamp(d1 / safe(d1 - d3), 0.0, 1.0)[..., None]
    on_ac = a + ac * torch.clamp(d2 / safe(d2 - d6), 0.0, 1.0)[..., None]
    on_bc = b + (c - b) * torch.clamp(
        (d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0.0, 1.0)[..., None]

    out = interior
    for cond, val in ((((vc <= 0) & (d1 >= 0) & (d3 <= 0)), on_ab),
                      (((vb <= 0) & (d2 >= 0) & (d6 <= 0)), on_ac),
                      (((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)), on_bc),
                      (((d1 <= 0) & (d2 <= 0)), a),
                      (((d3 >= 0) & (d4 <= d3)), b),
                      (((d6 >= 0) & (d5 <= d6)), c)):
        out = torch.where(cond[..., None], val, out)
    return out


def _mesh_grid_dim(tables) -> int:
    g = tables["mesh_cells"].shape[1]
    g_dim = int(round(g ** (1.0 / 3.0)))
    while g_dim ** 3 < g:
        g_dim += 1
    return g_dim


def _points_vs_mesh(points_w, pvalid, radius, pb, qb, prm_b, tables, margin):
    """Contacts of candidate points (..., P, 3) (sphere radius per point)
    against the mesh body at (pb, qb); top-4 manifold, normals A -> B (into
    the mesh surface)."""
    rot = m3.quat_to_mat3(qb)
    p_l = torch.einsum("...ji,...pj->...pi", rot, points_w - pb[..., None, :])
    shp = p_l.shape[:-1]                          # (..., P)
    midx = _row_index(prm_b[..., 0], tables["mesh_info"].shape[0])[..., None].expand(shp)
    info = tables["mesh_info"][midx]              # (..., P, 8)
    origin = info[..., 0:3]
    cell = info[..., 3]
    g_dim = _mesh_grid_dim(tables)
    c_idx = torch.clamp(((p_l - origin) / cell[..., None]).int(), 0, g_dim - 1).long()
    ckey = (c_idx[..., 0] * g_dim + c_idx[..., 1]) * g_dim + c_idx[..., 2]
    bucket = tables["mesh_cells"][midx, ckey]     # (..., P, B)
    tri = tables["mesh_tris"][midx[..., None], torch.clamp(bucket, min=0).long()]
    a, b_, c_ = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    n_f = m3.normalize(m3.cross(b_ - a, c_ - a))

    pq = p_l[..., None, :]                        # (..., P, 1, 3)
    d = pq - _closest_on_triangle(pq, a, b_, c_)
    dist = m3.length(d)
    side = m3.dot(d, n_f)
    # front side: euclidean distance to the closest point; back side: the
    # distance along the face normal only (a point just under the surface
    # near an internal edge reads as a shallow face contact)
    sdist = torch.where(side >= 0.0, dist, side)
    n_l = torch.where(((dist > 1e-6) & (side > 0.0))[..., None],
                      d / torch.clamp(dist, min=1e-6)[..., None], n_f)
    pen = radius[..., None] - sdist
    back_cap = radius[..., None] + 0.5 * cell[..., None]
    marg = _expand_margin(margin, pen.ndim)
    valid = (bucket >= 0) & pvalid[..., None] & (pen > -marg) & (pen < back_cap)
    # a back-side capture needs the point to project inside the triangle
    lat2 = torch.clamp(dist * dist - side * side, min=0.0)
    lat_eps = 1e-3 * cell[..., None]
    valid = valid & ((side >= 0.0) | (lat2 < lat_eps * lat_eps))

    n_w = torch.einsum("...ij,...pbj->...pbi", rot, n_l)
    point = points_w[..., None, :] - n_w * radius[..., None, None]
    flat = shp[:-1] + (shp[-1] * bucket.shape[-1],)
    pen_f = torch.where(valid, pen, torch.full_like(pen, -1e30)).reshape(flat)
    return _top4_manifold(pen_f, point.reshape(flat + (3,)),
                          n_w.reshape(flat + (3,)), flip_normal=True)


def sphere_mesh(pa, ra, pb, qb, prm_b, tables, margin):
    pts = pa[..., None, :]
    return _points_vs_mesh(pts, _all_valid(pts), ra[..., None], pb, qb, prm_b,
                           tables, margin)


def capsule_mesh(pa, qa, ra, hha, pb, qb, prm_b, tables, margin):
    e0, e1 = _capsule_segment(pa, qa, hha)
    pts = torch.stack([e0, 0.5 * (e0 + e1), e1], dim=-2)
    return _points_vs_mesh(pts, _all_valid(pts), ra[..., None].expand(pts.shape[:-1]),
                           pb, qb, prm_b, tables, margin)


def box_mesh(pa, qa, half_a, pb, qb, prm_b, tables, margin):
    pts = _box_corners_world(pa, qa, half_a)
    return _points_vs_mesh(pts, _all_valid(pts),
                           torch.zeros(pts.shape[:-1], device=pts.device),
                           pb, qb, prm_b, tables, margin)


def hull_mesh(pa, qa, prm_a, pb, qb, prm_b, tables, margin):
    pts, pvalid, _, _ = _hull_world(pa, qa, prm_a, tables)
    return _points_vs_mesh(pts, pvalid, torch.zeros(pts.shape[:-1], device=pts.device),
                           pb, qb, prm_b, tables, margin)


def compound_mesh(pa, qa, prm_a, pb, qb, prm_b, tables, margin):
    """Compound A against mesh B: each child's support points."""
    return _compound_vs(pa, qa, prm_a, tables, lambda pk, qk, prmk: (
        sphere_mesh(pk, prmk[..., 0], pb, qb, prm_b, tables, margin),
        box_mesh(pk, qk, prmk[..., :3], pb, qb, prm_b, tables, margin),
        capsule_mesh(pk, qk, prmk[..., 0], prmk[..., 1], pb, qb, prm_b, tables,
                     margin)))


# -- dispatch ---------------------------------------------------------------------------------


def generate_contacts(
    pos: Tensor, quat: Tensor, stype: Tensor, params: Tensor,
    pair_i: Tensor, pair_j: Tensor, pair_valid: Tensor,
    margin,
    present_types: Optional[frozenset] = None,
    tables: Optional[Dict[str, Tensor]] = None,
) -> Dict[str, Tensor]:
    """Contact manifolds for candidate pairs (P,), each evaluated in
    canonical order type(a) <= type(b), then by index; returns (P, 4, ...)
    manifolds plus the canonical bodies `a`, `b`. `margin` is a number, a
    per-pair tensor or a per-body tensor (N,). `present_types` (from
    ShapeTable.present_types()) prunes the kernels of absent shape types;
    `tables` are the ShapeTable's device arrays, which hull, heightfield,
    compound and mesh pairs read."""
    dev = pos.device
    if not isinstance(margin, Tensor):
        margin = m3.constant(float(margin), dev)
    ti = stype[pair_i.long()]
    tj = stype[pair_j.long()]
    # canonical order by type, then by index: rows (i, j) and (j, i)
    # evaluate the identical pair, so their manifolds match bitwise
    swap = (ti > tj) | ((ti == tj) & (pair_i > pair_j))
    a = torch.where(swap, pair_j, pair_i)
    b = torch.where(swap, pair_i, pair_j)
    al, bl = a.long(), b.long()
    pa, qa, prm_a, ta = pos[al], quat[al], params[al], stype[al]
    pb, qb, prm_b, tb = pos[bl], quat[bl], params[bl], stype[bl]
    if margin.ndim == 1 and margin.shape[0] == pos.shape[0]:
        margin = torch.maximum(margin[al], margin[bl])
    n_w, d_w = _plane_world(pb, qb, prm_b)

    def have(*types) -> bool:
        return present_types is None or all(t in present_types for t in types)

    kernels = []

    def add(cond, man_fn):
        kernels.append((cond, man_fn()))

    if have(sh.SPHERE):
        add((ta == sh.SPHERE) & (tb == sh.SPHERE),
            lambda: sphere_sphere(pa, prm_a[..., 0], pb, prm_b[..., 0], margin))
    if have(sh.SPHERE, sh.BOX):
        add((ta == sh.SPHERE) & (tb == sh.BOX),
            lambda: sphere_box(pa, prm_a[..., 0], pb, qb, prm_b[..., :3], margin))
    if have(sh.SPHERE, sh.CAPSULE):
        add((ta == sh.SPHERE) & (tb == sh.CAPSULE),
            lambda: _flip(capsule_sphere(pb, qb, prm_b[..., 0], prm_b[..., 1],
                                         pa, prm_a[..., 0], margin)))
    if have(sh.SPHERE, sh.PLANE):
        add((ta == sh.SPHERE) & (tb == sh.PLANE),
            lambda: sphere_plane(pa, prm_a[..., 0], n_w, d_w, margin))
    if have(sh.BOX):
        add((ta == sh.BOX) & (tb == sh.BOX),
            lambda: box_box(pa, qa, prm_a[..., :3], pb, qb, prm_b[..., :3], margin))
    if have(sh.BOX, sh.CAPSULE):
        add((ta == sh.BOX) & (tb == sh.CAPSULE),
            lambda: _flip(capsule_box(pb, qb, prm_b[..., 0], prm_b[..., 1],
                                      pa, qa, prm_a[..., :3], margin)))
    if have(sh.BOX, sh.PLANE):
        add((ta == sh.BOX) & (tb == sh.PLANE),
            lambda: box_plane(pa, qa, prm_a[..., :3], n_w, d_w, margin))
    if have(sh.CAPSULE):
        add((ta == sh.CAPSULE) & (tb == sh.CAPSULE),
            lambda: capsule_capsule(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                    pb, qb, prm_b[..., 0], prm_b[..., 1], margin))
    if have(sh.CAPSULE, sh.PLANE):
        add((ta == sh.CAPSULE) & (tb == sh.PLANE),
            lambda: capsule_plane(pa, qa, prm_a[..., 0], prm_a[..., 1], n_w, d_w,
                                  margin))

    # hull pairs
    if have(sh.SPHERE, sh.HULL):
        add((ta == sh.SPHERE) & (tb == sh.HULL),
            lambda: sphere_hull(pa, prm_a[..., 0], pb, qb, prm_b, tables, margin))
    if have(sh.BOX, sh.HULL):
        add((ta == sh.BOX) & (tb == sh.HULL),
            lambda: box_hull(pa, qa, prm_a[..., :3], pb, qb, prm_b, tables, margin))
    if have(sh.CAPSULE, sh.HULL):
        add((ta == sh.CAPSULE) & (tb == sh.HULL),
            lambda: capsule_hull(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                 pb, qb, prm_b, tables, margin))
    if have(sh.HULL):
        add((ta == sh.HULL) & (tb == sh.HULL),
            lambda: hull_hull(pa, qa, prm_a, pb, qb, prm_b, tables, margin))
    if have(sh.HULL, sh.PLANE):
        add((ta == sh.HULL) & (tb == sh.PLANE),
            lambda: hull_plane(pa, qa, prm_a, n_w, d_w, tables, margin))

    # heightfield pairs
    if have(sh.SPHERE, sh.HEIGHTFIELD):
        add((ta == sh.SPHERE) & (tb == sh.HEIGHTFIELD),
            lambda: sphere_heightfield(pa, prm_a[..., 0], pb, qb, prm_b, tables,
                                       margin))
    if have(sh.BOX, sh.HEIGHTFIELD):
        add((ta == sh.BOX) & (tb == sh.HEIGHTFIELD),
            lambda: box_heightfield(pa, qa, prm_a[..., :3], pb, qb, prm_b, tables,
                                    margin))
    if have(sh.CAPSULE, sh.HEIGHTFIELD):
        add((ta == sh.CAPSULE) & (tb == sh.HEIGHTFIELD),
            lambda: capsule_heightfield(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                        pb, qb, prm_b, tables, margin))
    if have(sh.HULL, sh.HEIGHTFIELD):
        add((ta == sh.HULL) & (tb == sh.HEIGHTFIELD),
            lambda: hull_heightfield(pa, qa, prm_a, pb, qb, prm_b, tables, margin))

    # compound pairs
    if have(sh.COMPOUND):
        present = present_types or frozenset((sh.SPHERE, sh.BOX, sh.CAPSULE))
        add(((ta == sh.SPHERE) | (ta == sh.BOX) | (ta == sh.CAPSULE))
            & (tb == sh.COMPOUND),
            lambda: convex_compound(ta, pa, qa, prm_a, pb, qb, prm_b, tables,
                                    margin, present))
        if have(sh.PLANE):
            add((ta == sh.COMPOUND) & (tb == sh.PLANE),
                lambda: compound_plane(pa, qa, prm_a, n_w, d_w, tables, margin,
                                       present))
        if have(sh.HEIGHTFIELD):
            add((ta == sh.COMPOUND) & (tb == sh.HEIGHTFIELD),
                lambda: compound_heightfield(pa, qa, prm_a, pb, qb, prm_b, tables,
                                             margin))
        if have(sh.HULL):
            add((ta == sh.HULL) & (tb == sh.COMPOUND),
                lambda: hull_compound(pa, qa, prm_a, pb, qb, prm_b, tables, margin,
                                      present))
        add((ta == sh.COMPOUND) & (tb == sh.COMPOUND),
            lambda: compound_compound(pa, qa, prm_a, pb, qb, prm_b, tables, margin,
                                      present))

    # triangle-mesh pairs (always the B side: the largest type id)
    if have(sh.SPHERE, sh.MESH):
        add((ta == sh.SPHERE) & (tb == sh.MESH),
            lambda: sphere_mesh(pa, prm_a[..., 0], pb, qb, prm_b, tables, margin))
    if have(sh.BOX, sh.MESH):
        add((ta == sh.BOX) & (tb == sh.MESH),
            lambda: box_mesh(pa, qa, prm_a[..., :3], pb, qb, prm_b, tables, margin))
    if have(sh.CAPSULE, sh.MESH):
        add((ta == sh.CAPSULE) & (tb == sh.MESH),
            lambda: capsule_mesh(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                 pb, qb, prm_b, tables, margin))
    if have(sh.HULL, sh.MESH):
        add((ta == sh.HULL) & (tb == sh.MESH),
            lambda: hull_mesh(pa, qa, prm_a, pb, qb, prm_b, tables, margin))
    if have(sh.COMPOUND, sh.MESH):
        add((ta == sh.COMPOUND) & (tb == sh.MESH),
            lambda: compound_mesh(pa, qa, prm_a, pb, qb, prm_b, tables, margin))

    out = _select(pair_i.shape, dev, kernels)
    out["valid"] = out["valid"] & pair_valid[..., None]
    out["a"] = a
    out["b"] = b
    return out
