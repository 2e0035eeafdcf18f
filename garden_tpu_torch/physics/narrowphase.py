"""Narrowphase: batched analytic contact generation.

Port of `garden_tpu.physics.narrowphase` for the pair kinds of the box
piles the port runs: box-box (15-axis SAT) and box-plane. Every kernel runs
over the whole candidate pair list and a select keeps each pair's result.

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
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.physics import shapes as sh

Tensor = torch.Tensor
MAX_POINTS = 4
_PORTED_TYPES = frozenset((sh.BOX, sh.PLANE))


def _corner_signs(device) -> Tensor:
    return torch.tensor([[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                         for sz in (-1.0, 1.0)], dtype=torch.float32, device=device)


def _empty_manifold(shape, device) -> Dict[str, Tensor]:
    return {
        "point": torch.zeros(shape + (MAX_POINTS, 3), device=device),
        "normal": torch.zeros(shape + (MAX_POINTS, 3), device=device),
        "pen": torch.full(shape + (MAX_POINTS,), -1e30, device=device),
        "valid": torch.zeros(shape + (MAX_POINTS,), dtype=torch.bool, device=device),
    }


def _plane_world(pos_b: Tensor, quat_b: Tensor, params_b: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """Plane local (n, d) -> world (n_w, d_w) with n_w.x + d_w = 0."""
    n_w = m3.quat_rotate(quat_b, params_b[..., :3])
    d_w = params_b[..., 3] - m3.dot(n_w, pos_b)
    return n_w, d_w


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """x[..., idx] along the last axis for per-row indices (...,)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _take_row(x: Tensor, idx: Tensor) -> Tensor:
    """x[..., idx, :] for per-row indices (...,)."""
    i = idx[..., None, None].expand(idx.shape + (1, x.shape[-1]))
    return torch.gather(x, -2, i)[..., 0, :]


def _sign1(x: Tensor) -> Tensor:
    s = torch.sign(x)
    return torch.where(s == 0.0, torch.ones_like(s), s)


def _box_corners_world(p: Tensor, q: Tensor, half: Tensor) -> Tensor:
    """(..., 8, 3) world corners of oriented boxes."""
    r = m3.quat_to_mat3(q)
    ax = r[..., :, 0] * half[..., 0:1]
    ay = r[..., :, 1] * half[..., 1:2]
    az = r[..., :, 2] * half[..., 2:3]
    s = _corner_signs(p.device)
    return (p[..., None, :] + s[:, 0:1] * ax[..., None, :]
            + s[:, 1:2] * ay[..., None, :] + s[:, 2:3] * az[..., None, :])


def _dot3(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _top4_sorted(pen: Tensor, columns: List[Tensor]) -> Tuple[Tensor, List[Tensor]]:
    """The 4 deepest candidates of `pen` (..., n) with their payload
    columns. Depth ranks in 1 mm buckets; ties keep enumeration order."""
    rank = torch.ceil(pen * 1e3)
    order = torch.sort(-rank, dim=-1, stable=True).indices[..., :MAX_POINTS]
    return (torch.gather(pen, -1, order),
            [torch.gather(c, -1, order) for c in columns])


def _top4_manifold(pen: Tensor, point: Tensor, normal: Tensor) -> Dict[str, Tensor]:
    """Manifold of the 4 deepest candidates; pen already holds -1e30 for
    invalid candidates."""
    cols = [point[..., i] for i in range(3)] + [normal[..., i] for i in range(3)]
    top_pen, out = _top4_sorted(pen, cols)
    return {"pen": top_pen, "point": torch.stack(out[0:3], dim=-1),
            "normal": torch.stack(out[3:6], dim=-1), "valid": top_pen > -1e29}


def box_plane(pa, qa, half_a, n_w, d_w, margin) -> Dict[str, Tensor]:
    corners = _box_corners_world(pa, qa, half_a)          # (..., 8, 3)
    pen = -(_dot3(corners, n_w[..., None, :]) + d_w[..., None])
    pen = torch.where(pen > -margin[..., None], pen, torch.full_like(pen, -1e30))
    nrm = (-n_w)[..., None, :].expand(corners.shape)
    return _top4_manifold(pen, corners, nrm)


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
    face_overlap = _take(overlap, best_face)
    best_edge = torch.argmin(eoverlap, dim=-1)
    edge_overlap = _take(eoverlap, best_edge)
    use_edge = edge_overlap < face_overlap * 0.95 - 0.01

    # face-axis manifold
    n = _take_row(axes, best_face) * _sign1(_take(dist, best_face))[..., None]
    rn_a = _take(r_a, best_face)
    rn_b = _take(r_b, best_face)
    corners_a = _box_corners_world(pa, qa, half_a)
    corners_b = _box_corners_world(pb, qb, half_b)
    pen_b = rn_a[..., None] - _dot3(corners_b - pa[..., None, :], n[..., None, :])
    pen_a = rn_b[..., None] + _dot3(corners_a - pb[..., None, :], n[..., None, :])
    pen = torch.cat([pen_b, pen_a], dim=-1)               # (..., 16)
    point = torch.cat([corners_b, corners_a], dim=-2)
    top_pen, cols4 = _top4_sorted(pen, [point[..., 0], point[..., 1], point[..., 2]])
    face_point = torch.stack(cols4, dim=-1)

    # edge-axis contact
    en = _take_row(eaxes, best_edge) * _sign1(_take(edist, best_edge))[..., None]
    ei = torch.div(best_edge, 3, rounding_mode="floor")   # edge direction on A
    ej = best_edge % 3                                    # edge direction on B
    dir_a = _take_row(a_cols, ei)
    dir_b = _take_row(b_cols, ej)
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
    ha_i = _take(half_a, ei)
    hb_j = _take(half_b, ej)
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


def generate_contacts(
    pos: Tensor, quat: Tensor, stype: Tensor, params: Tensor,
    pair_i: Tensor, pair_j: Tensor, pair_valid: Tensor,
    margin: Tensor,
    present_types: frozenset,
) -> Dict[str, Tensor]:
    """Contact manifolds for candidate pairs (P,), each evaluated in
    canonical order type(a) <= type(b), then by index; returns (P, 4, ...)
    manifolds plus the canonical bodies `a`, `b`. `margin` is per body."""
    unported = set(present_types) - _PORTED_TYPES
    if unported:
        names = sorted(unported)
        raise NotImplementedError(
            f"narrowphase pairs for shape types {names} are not ported yet "
            "(ROADMAP Queue 1 item 13, the rest of physics)")
    ti = stype[pair_i]
    tj = stype[pair_j]
    swap = (ti > tj) | ((ti == tj) & (pair_i > pair_j))
    a = torch.where(swap, pair_j, pair_i)
    b = torch.where(swap, pair_i, pair_j)
    al, bl = a.long(), b.long()
    pa, qa, prm_a, ta = pos[al], quat[al], params[al], stype[al]
    pb, qb, prm_b, tb = pos[bl], quat[bl], params[bl], stype[bl]
    pmargin = torch.maximum(margin[al], margin[bl])

    out = _empty_manifold(pair_i.shape, pos.device)
    kernels = []
    if sh.BOX in present_types:
        kernels.append(((ta == sh.BOX) & (tb == sh.BOX),
                        box_box(pa, qa, prm_a[..., :3], pb, qb, prm_b[..., :3],
                                pmargin)))
    if sh.BOX in present_types and sh.PLANE in present_types:
        n_w, d_w = _plane_world(pb, qb, prm_b)
        kernels.append(((ta == sh.BOX) & (tb == sh.PLANE),
                        box_plane(pa, qa, prm_a[..., :3], n_w, d_w, pmargin)))
    for field in ("point", "normal", "pen", "valid"):
        acc = out[field]
        for cond, man in kernels:
            c = cond.reshape(cond.shape + (1,) * (acc.ndim - cond.ndim))
            acc = torch.where(c, man[field], acc)
        out[field] = acc
    out["valid"] = out["valid"] & pair_valid[..., None]
    out["a"] = a
    out["b"] = b
    return out
