"""FXAA 3.11 post-process anti-aliasing.

Port of `garden_tpu.render.fxaa`: luminance edge detection, the edge's
orientation from second-derivative luma contrast, an end-search along the
edge over a fixed schedule of distances (_STEPS) that keeps the first hit
in each direction, the sub-pixel offset from the nearer end, the separate
sub-pixel aliasing lowpass, and a blend with the straddled neighbour.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.shifts import Shifter

Tensor = torch.Tensor

EDGE_THRESHOLD = 1.0 / 8.0
EDGE_THRESHOLD_MIN = 1.0 / 24.0
SUBPIX_QUALITY = 0.75
# march distances in pixels: the 3.11 quality-12 step pattern, 9 taps
_STEPS = (1, 2, 3, 4, 5, 7, 9, 12, 16)


def _luma(rgb: Tensor) -> Tensor:
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def _end_search(edge_luma_pos: Tensor, edge_luma_neg: Tensor, is_neg: Tensor,
                local_avg: Tensor, grad_scaled: Tensor, axis: int):
    """March both ways along the edge (axis 1: along x, axis 0: along y);
    -> (distance -, distance +, end luma -, end luma +). The first tap whose
    luma steps by >= grad_scaled from the local average ends the ray; a ray
    that never ends saturates at the last distance."""
    reach = _STEPS[-1]
    ry, rx = (0, reach) if axis == 1 else (reach, 0)
    pos_at = Shifter(edge_luma_pos, ry, rx)
    neg_at = Shifter(edge_luma_neg, ry, rx)
    dists, lumas = [], []
    for sign in (-1, 1):
        found = torch.zeros(local_avg.shape, dtype=torch.bool, device=local_avg.device)
        dist = torch.full_like(local_avg, float(reach))
        end_luma = torch.zeros_like(local_avg)
        for d in _STEPS:
            dy, dx = (0, sign * d) if axis == 1 else (sign * d, 0)
            tap = torch.where(is_neg, neg_at(-dy, -dx), pos_at(-dy, -dx))
            delta = tap - local_avg
            hit = torch.abs(delta) >= grad_scaled
            new = hit & ~found
            dist = torch.where(new, float(d), dist)
            end_luma = torch.where(new, delta, end_luma)
            found = found | hit
        dists.append(dist)
        lumas.append(end_luma)
    return dists[0], dists[1], lumas[0], lumas[1]


def apply_fxaa(ldr: Tensor) -> Tensor:
    """ldr: (H, W, 3) float in [0, 1] -> antialiased (H, W, 3)."""
    luma = _luma(ldr)
    lum_at = Shifter(luma, 1, 1)
    l_n, l_s, l_w, l_e = lum_at(1, 0), lum_at(-1, 0), lum_at(0, 1), lum_at(0, -1)
    l_nw, l_ne = lum_at(1, 1), lum_at(1, -1)
    l_sw, l_se = lum_at(-1, 1), lum_at(-1, -1)

    l_min = torch.minimum(luma, torch.minimum(torch.minimum(l_n, l_s),
                                              torch.minimum(l_w, l_e)))
    l_max = torch.maximum(luma, torch.maximum(torch.maximum(l_n, l_s),
                                              torch.maximum(l_w, l_e)))
    rng = l_max - l_min
    edge = rng >= torch.clamp(l_max * EDGE_THRESHOLD, min=EDGE_THRESHOLD_MIN)

    # a horizontal edge shows strong luma curvature vertically
    edge_h = (torch.abs(l_nw + l_sw - 2.0 * l_w)
              + 2.0 * torch.abs(l_n + l_s - 2.0 * luma)
              + torch.abs(l_ne + l_se - 2.0 * l_e))
    edge_v = (torch.abs(l_nw + l_ne - 2.0 * l_n)
              + 2.0 * torch.abs(l_w + l_e - 2.0 * luma)
              + torch.abs(l_sw + l_se - 2.0 * l_s))
    horiz = edge_h >= edge_v

    l_perp_neg = torch.where(horiz, l_n, l_w)
    l_perp_pos = torch.where(horiz, l_s, l_e)
    grad_neg = torch.abs(l_perp_neg - luma)
    grad_pos = torch.abs(l_perp_pos - luma)
    is_neg = grad_neg >= grad_pos
    grad_scaled = 0.25 * torch.maximum(grad_neg, grad_pos)
    l_nb = torch.where(is_neg, l_perp_neg, l_perp_pos)
    local_avg = 0.5 * (luma + l_nb)

    eh_neg = 0.5 * (luma + l_n)
    eh_pos = 0.5 * (luma + l_s)
    ev_neg = 0.5 * (luma + l_w)
    ev_pos = 0.5 * (luma + l_e)
    dh_n, dh_p, eh_end_n, eh_end_p = _end_search(
        eh_pos, eh_neg, is_neg, local_avg, grad_scaled, axis=1)
    dv_n, dv_p, ev_end_n, ev_end_p = _end_search(
        ev_pos, ev_neg, is_neg, local_avg, grad_scaled, axis=0)
    dist_n = torch.where(horiz, dh_n, dv_n)
    dist_p = torch.where(horiz, dh_p, dv_p)
    end_n = torch.where(horiz, eh_end_n, ev_end_n)
    end_p = torch.where(horiz, eh_end_p, ev_end_p)

    # sub-pixel offset from the nearer end: 0 at the end, 0.5 mid-edge
    edge_len = dist_n + dist_p
    nearer_neg = dist_n < dist_p
    dist_near = torch.minimum(dist_n, dist_p)
    offset = 0.5 - dist_near / torch.clamp(edge_len, min=1e-6)
    center_below = luma < local_avg
    end_near = torch.where(nearer_neg, end_n, end_p)
    good = (end_near < 0.0) != center_below
    offset = torch.where(good, offset, 0.0)

    # sub-pixel aliasing lowpass: 3x3 luma contrast, squared smoothstep
    l_avg = (2.0 * (l_n + l_s + l_w + l_e) + (l_nw + l_ne + l_sw + l_se)) / 12.0
    sub = torch.clamp(torch.abs(l_avg - luma) / torch.clamp(rng, min=1e-6), 0.0, 1.0)
    sub = (-2.0 * sub + 3.0) * sub * sub
    offset = torch.maximum(offset, sub * sub * SUBPIX_QUALITY)

    # lerp toward the straddled neighbour on the chosen side
    ldr_at = Shifter(ldr, 1, 1)
    nb_h = torch.where(is_neg[..., None], ldr_at(1, 0), ldr_at(-1, 0))
    nb_v = torch.where(is_neg[..., None], ldr_at(0, 1), ldr_at(0, -1))
    nb_rgb = torch.where(horiz[..., None], nb_h, nb_v)
    o = offset[..., None]
    out = ldr * (1.0 - o) + nb_rgb * o
    return torch.where(edge[..., None], out, ldr)
