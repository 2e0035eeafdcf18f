"""SMAA 1x: subpixel morphological antialiasing of the LDR image.

Port of `garden_tpu.render.smaa`, the three passes of Jimenez et al.: luma
edge detection with local-contrast adaptation; blend weights from the
edge runs (fixed-radius searches as products of shifted edge masks, the
coverage of the revectorized edge line evaluated analytically in place of
the AreaTex lookup); neighbourhood blending. Corner pixels on 45-degree
staircases resolve first, 1/8 toward their two outside neighbours, and
skip the orthogonal weights. Every tap is an edge-clamped shift
(`ops/shifts.Shifter`).
"""

from __future__ import annotations

import torch

from garden_tpu_torch.ops.shifts import Shifter

Tensor = torch.Tensor

EDGE_THRESHOLD = 0.1
LOCAL_CONTRAST_FACTOR = 2.0
SEARCH_STEPS = 8


def _luma(img: Tensor) -> Tensor:
    return 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]


def detect_edges(img: Tensor) -> Tensor:
    """(H, W, 2) bool: [left edge, top edge] of each pixel; an edge is
    dropped where a neighbouring contrast is more than twice as strong."""
    l = _luma(img)
    l_at = Shifter(l, 2, 2)
    d_left = torch.abs(l - l_at(0, -1))
    d_top = torch.abs(l - l_at(-1, 0))
    left = d_left >= EDGE_THRESHOLD
    top = d_top >= EDGE_THRESHOLD

    d_right = torch.abs(l - l_at(0, 1))
    d_bottom = torch.abs(l - l_at(1, 0))
    d_leftleft = torch.abs(l_at(0, -1) - l_at(0, -2))
    d_toptop = torch.abs(l_at(-1, 0) - l_at(-2, 0))
    max_l = torch.maximum(torch.maximum(d_right, d_bottom),
                          torch.maximum(d_top, d_leftleft))
    max_t = torch.maximum(torch.maximum(d_right, d_bottom),
                          torch.maximum(d_left, d_toptop))
    left = left & (d_left >= max_l / LOCAL_CONTRAST_FACTOR)
    top = top & (d_top >= max_t / LOCAL_CONTRAST_FACTOR)
    return torch.stack([left, top], dim=-1)


def _runs(edge_at: Shifter, dy: int, dx: int) -> Tensor:
    """Length of the contiguous edge run in direction (dy, dx), up to
    SEARCH_STEPS, not counting the centre pixel."""
    dev = edge_at.p.device
    run = torch.zeros((edge_at.h, edge_at.w), device=dev)
    alive = torch.ones((edge_at.h, edge_at.w), dtype=torch.bool, device=dev)
    for s in range(1, SEARCH_STEPS + 1):
        alive = alive & edge_at(dy * s, dx * s)
        run = run + alive.float()
    return run


def _area(d1: Tensor, d2: Tensor, c1: Tensor, c2: Tensor) -> Tensor:
    """Signed mean across-edge offset over the centre pixel of the line
    from (-d1 - 0.5, c1 / 2) to (d2 + 0.5, c2 / 2): |value| is the blend
    weight, the sign the side. 0 for a straight edge (no crossing)."""
    span = d1 + d2 + 1.0
    t = (d1 + 0.5) / torch.clamp(span, min=1e-6)
    h = c1 * 0.5 + (c2 * 0.5 - c1 * 0.5) * t
    return torch.where((c1 == 0.0) & (c2 == 0.0), 0.0, h)


def _crossings(d1: Tensor, d2: Tensor, cross1, cross2):
    """(c1, c2): at each run's end s, +1 where cross*(s)[0] (the first
    crossing edge) is set, else -1 where cross*(s)[1] is, else 0."""
    c1 = torch.zeros_like(d1)
    c2 = torch.zeros_like(d2)
    for s in range(SEARCH_STEPS + 1):
        end1, end2 = d1 == s, d2 == s
        a1, b1 = cross1(s)
        a2, b2 = cross2(s)
        c1 = torch.where(end1 & a1, 1.0, torch.where(end1 & b1, -1.0, c1))
        c2 = torch.where(end2 & a2, 1.0, torch.where(end2 & b2, -1.0, c2))
    return c1, c2


def blending_weights(edges: Tensor) -> Tensor:
    """(H, W, 4) blend weights [up, down, left, right] of each pixel."""
    left_e = edges[..., 0]   # vertical edge on the pixel's left border
    top_e = edges[..., 1]    # horizontal edge on its top border
    r = SEARCH_STEPS + 1
    le_at = Shifter(left_e, r, r)
    te_at = Shifter(top_e, r, r)

    # horizontal (top) edges: search left and right along the edge; a left
    # edge at the run's end pixel or the one above marks the crossing
    d1 = _runs(te_at, 0, -1)
    d2 = _runs(te_at, 0, 1)
    c1, c2 = _crossings(d1, d2, lambda s: (le_at(-1, -s), le_at(0, -s)),
                        lambda s: (le_at(-1, s + 1), le_at(0, s + 1)))
    h = _area(d1, d2, c1, c2)
    w_up = torch.where(top_e, torch.clamp(h, min=0.0), 0.0)
    w_dn = torch.where(top_e, torch.clamp(-h, min=0.0), 0.0)

    # vertical (left) edges: search up and down
    d1v = _runs(le_at, -1, 0)
    d2v = _runs(le_at, 1, 0)
    c1v, c2v = _crossings(d1v, d2v, lambda s: (te_at(-s, -1), te_at(-s, 0)),
                          lambda s: (te_at(s + 1, -1), te_at(s + 1, 0)))
    v = _area(d1v, d2v, c1v, c2v)
    w_left = torch.where(left_e, torch.clamp(v, min=0.0), 0.0)
    w_right = torch.where(left_e, torch.clamp(-v, min=0.0), 0.0)
    return torch.stack([w_up, w_dn, w_left, w_right], dim=-1)


def _diag_patterns(edges: Tensor):
    """[(on_diag (H, W) bool, (offset 1, offset 2))] for the four corner
    orientations: a corner pixel (two perpendicular border edges) whose
    same-oriented corner repeats at a diagonal neighbour lies on a 45-degree
    staircase; its two outside neighbours are at the offsets."""
    left_e = edges[..., 0]
    top_e = edges[..., 1]
    right_e = Shifter(left_e, 1, 1)(0, 1)    # the next pixel's left edge
    bot_e = Shifter(top_e, 1, 1)(1, 0)       # the next row's top edge
    out = []
    for corner, offs in (
            (left_e & top_e, ((-1, 0), (0, -1))),    # outside up-left
            (right_e & top_e, ((-1, 0), (0, 1))),    # outside up-right
            (left_e & bot_e, ((1, 0), (0, -1))),     # outside down-left
            (right_e & bot_e, ((1, 0), (0, 1)))):    # outside down-right
        c_at = Shifter(corner, 1, 1)
        on_diag = corner & (c_at(1, 1) | c_at(-1, -1) | c_at(1, -1) | c_at(-1, 1))
        out.append((on_diag, offs))
    return out


def neighborhood_blend(img: Tensor, weights: Tensor) -> Tensor:
    """Blend each pixel with its 4 neighbours by its own edge weights and
    the opposing weights stored on the pixels below and to the right."""
    w_at = Shifter(weights, 1, 1)
    w_up, w_dn = weights[..., 0], weights[..., 1]
    w_left, w_right = weights[..., 2], weights[..., 3]
    w_from_below = w_at(1, 0)[..., 0]
    w_from_right = w_at(0, 1)[..., 2]
    total = w_up + w_dn + w_left + w_right + w_from_below + w_from_right
    i_at = Shifter(img, 1, 1)
    blend = (w_up[..., None] * i_at(-1, 0)
             + w_dn[..., None] * i_at(1, 0)
             + w_left[..., None] * i_at(0, -1)
             + w_right[..., None] * i_at(0, 1)
             + w_from_below[..., None] * i_at(1, 0)
             + w_from_right[..., None] * i_at(0, 1))
    t = torch.clamp(total, 0.0, 1.0)[..., None]
    safe = torch.clamp(total, min=1e-6)[..., None]
    return img * (1.0 - t) + (blend / safe) * t


def apply_smaa(img: Tensor) -> Tensor:
    """The SMAA 1x chain on an LDR (H, W, 3) image in [0, 1]: diagonal
    patterns first (7/8 self + 1/16 per outside neighbour), the orthogonal
    weights and the neighbourhood blend for the other pixels."""
    edges = detect_edges(img)
    handled = torch.zeros(img.shape[:2], dtype=torch.bool, device=img.device)
    diag_out = img
    i_at = Shifter(img, 1, 1)
    for on_diag, ((dy1, dx1), (dy2, dx2)) in _diag_patterns(edges):
        target = img * 0.875 + (i_at(dy1, dx1) + i_at(dy2, dx2)) * 0.0625
        diag_out = torch.where(on_diag[..., None], target, diag_out)
        handled = handled | on_diag
    weights = torch.where(handled[..., None], 0.0, blending_weights(edges))
    out = neighborhood_blend(img, weights)
    return torch.where(handled[..., None], diag_out, out)
