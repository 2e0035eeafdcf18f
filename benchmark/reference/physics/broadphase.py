"""Broadphase: uniform spatial grid over sorted, hashed cell keys.

Port of `garden_tpu.physics.broadphase`. The algorithm is the reference's,
so the candidate sets match:

1. each body's AABB quantizes outward to 10 bits per axis and inserts into
   the (up to) 2x2x2 cells it touches; cell keys hash down to O(bodies)
   buckets when the grid is large;
2. one sort of (bucket, body) builds a (bucket, slot) table whose entries
   carry [id | layer | active] and the quantized box;
3. each body reads its 8 cells' entries and filters them densely: quantized
   box overlap, layers, self, activity, and the home-cell rule that keeps a
   pair in exactly one cell (both rows of a pair decide it identically);
4. the first `max_candidates` survivors in slot order are kept, after the
   global bodies (planes), which every body tests.

The reference sorts a packed int32 and compacts with one-hot contractions;
here the sort runs on an int64 pack and the compaction is an index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.reference.core import math3d as m3
from benchmark.reference.physics import shapes as sh

Tensor = torch.Tensor


def body_aabbs(pos: Tensor, quat: Tensor, stype: Tensor, params: Tensor,
               margin: float = 0.0, hull_ext: Optional[Tensor] = None,
               comp_ext: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """World AABBs for all bodies, expanded by `margin`; hull_ext/comp_ext
    are the per-body extents of hull and compound rows."""
    lmin, lmax = sh.local_aabb(stype, params, hull_ext=hull_ext, comp_ext=comp_ext)
    wmin, wmax = m3.aabb_transform(lmin, lmax, pos, quat)
    return wmin - margin, wmax + margin


def _first_k(score: Tensor, k: int) -> Tensor:
    """Indices of the k largest scores along the last axis, lower index
    first on ties (the order `lax.top_k` gives; `torch.topk` does not
    promise it on CUDA)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def find_candidates(
    pos: Tensor,
    aabb_min: Tensor,
    aabb_max: Tensor,
    active: Tensor,
    dynamic: Tensor,
    layer: Tensor,          # int32[N]
    layer_table: Tensor,    # bool[L, L] collision filter table
    is_global: Tensor,      # bool[N] grid-bypassing big bodies
    *,
    cell_size: float,
    grid_dim: int,
    cand_per_cell: int,
    max_candidates: int,
    max_globals: int,
) -> Tuple[Tensor, Tensor]:
    """Return (cand_idx int32[N, K], cand_valid bool[N, K]) with
    K = max_globals + max_candidates, globals first. Grid pairs appear in
    both rows. Invalid slots hold an in-range body id."""
    n = pos.shape[0]
    dev = pos.device
    if 1024 % grid_dim:
        raise ValueError("grid_dim must divide 1024")
    if n > (1 << 17):
        raise ValueError("the packed broadphase entry caps at 131072 bodies")
    half_world = 0.5 * cell_size * grid_dim
    spc = 1024 // grid_dim
    inv_q = 1024.0 / (cell_size * grid_dim)
    qmin = torch.clamp(torch.floor((aabb_min + half_world) * inv_q), 0, 1023).int()
    qmax = torch.clamp(torch.ceil((aabb_max + half_world) * inv_q), 0, 1023).int()

    cmin = torch.div(qmin, spc, rounding_mode="floor")
    cmax = torch.clamp(torch.div(qmax, spc, rounding_mode="floor"), max=grid_dim - 1)
    cmax = torch.minimum(cmax, cmin + 1)       # at most 2 cells per axis

    in_grid = active & ~is_global
    n_cells = grid_dim ** 3 + 2                # + sentinel + spare
    sentinel = n_cells - 1

    # 1. 8 insertion keys per body; uncovered corners map to the sentinel
    offs = m3.constant(tuple((ox, oy, oz) for ox in (0, 1) for oy in (0, 1)
                             for oz in (0, 1)), dev, torch.int32)
    cx8 = cmin[:, 0:1] + offs[None, :, 0]
    cy8 = cmin[:, 1:2] + offs[None, :, 1]
    cz8 = cmin[:, 2:3] + offs[None, :, 2]
    covered = (cx8 <= cmax[:, 0:1]) & (cy8 <= cmax[:, 1:2]) & (cz8 <= cmax[:, 2:3])
    key8 = (cx8 * grid_dim + cy8) * grid_dim + cz8
    key8 = torch.where(covered & in_grid[:, None], key8,
                       torch.full_like(key8, sentinel))

    # 2. hash the cell space to O(bodies) buckets (the reference's uint32
    # multiplicative hash, computed in int64 and masked to 32 bits)
    h_target = 1 << max(int(np.ceil(np.log2(max(4 * n, 1024)))), 1)
    if n_cells <= h_target:
        n_buckets = n_cells
        sentinel_bucket = sentinel
        hkey8 = key8
    else:
        n_buckets = h_target + 1
        sentinel_bucket = h_target
        h = ((key8.long() * 2654435761) & 0xFFFFFFFF) >> 12
        hkey8 = torch.where(key8 >= sentinel,
                            torch.full_like(key8, sentinel_bucket),
                            (h & (h_target - 1)).int())

    body_bits = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    body8 = torch.arange(n, dtype=torch.int64, device=dev)[:, None].expand(n, 8)
    packed = torch.sort(((hkey8.long() << body_bits) | body8).reshape(-1)).values
    key_sorted = packed >> body_bits
    body_sorted = packed & ((1 << body_bits) - 1)

    # 3. (bucket, 3*slot) table of [meta | qmin | qmax] entries; slots past
    # cand_per_cell and the sentinel go to a trash row
    m = key_sorted.shape[0]
    idxs = torch.arange(m, dtype=torch.int64, device=dev)
    run_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           key_sorted[1:] != key_sorted[:-1]])
    seg_start = torch.cummax(torch.where(run_start, idxs, 0), dim=0).values
    slot = idxs - seg_start
    c_per = cand_per_cell

    packed_all = (torch.arange(n, dtype=torch.int32, device=dev)
                  | (layer << 17) | (active.int() << 20))
    pack3 = lambda v: (v[:, 0] << 20) | (v[:, 1] << 10) | v[:, 2]
    entry3 = torch.stack([packed_all, pack3(qmin), pack3(qmax)], -1)
    ent_sorted = entry3[body_sorted]
    trash = n_buckets * 3 * c_per
    base = torch.where((slot < c_per) & (key_sorted < sentinel_bucket),
                       key_sorted * (3 * c_per) + slot,
                       torch.full_like(slot, trash))
    flat_pos = torch.cat([base, base + c_per, base + 2 * c_per])
    flat_val = ent_sorted.T.reshape(-1)
    cell_tab = torch.full((trash + 3 * c_per,), -1, dtype=torch.int32,
                          device=dev).index_put((flat_pos,), flat_val)
    cell_tab = cell_tab[:trash].reshape(n_buckets, 3 * c_per)

    # 4. each body reads its own 8 cells' entries and filters them
    scan_key = torch.where(covered, key8, torch.full_like(key8, sentinel))
    scan_bucket = torch.where(covered, hkey8, torch.full_like(hkey8, sentinel_bucket))
    raw = cell_tab[scan_bucket.long()]                   # (N, 8, 3C)
    meta = raw[:, :, 0:c_per].reshape(n, 8 * c_per)
    qmin_pk = raw[:, :, c_per:2 * c_per].reshape(n, 8 * c_per)
    qmax_pk = raw[:, :, 2 * c_per:3 * c_per].reshape(n, 8 * c_per)
    cand_valid = meta >= 0
    cand = meta & 0x1FFFF
    jlayer = (meta >> 17) & 7
    j_active = cand_valid & (((meta >> 20) & 1) == 1)
    k8c = cand.shape[1]

    n_layers = layer_table.shape[0]
    accept_bits = torch.sum(
        layer_table[layer.long()].int()
        * (1 << torch.arange(n_layers, dtype=torch.int32, device=dev))[None, :],
        dim=-1, dtype=torch.int32)

    i_idx = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    valid = cand_valid & (cand != i_idx)
    valid &= active[:, None] & j_active
    valid &= dynamic[:, None]
    valid &= ((accept_bits[:, None] >> jlayer) & 1) == 1
    home_key = torch.zeros_like(cand)
    for axis, shift in ((0, 20), (1, 10), (2, 0)):
        jq_min = (qmin_pk >> shift) & 0x3FF
        jq_max = (qmax_pk >> shift) & 0x3FF
        iq_min = qmin[:, axis:axis + 1]
        iq_max = qmax[:, axis:axis + 1]
        valid &= (iq_min <= jq_max) & (jq_min <= iq_max)
        home_ax = torch.clamp(
            torch.div(torch.maximum(iq_min, jq_min), spc, rounding_mode="floor"),
            max=grid_dim - 1)
        home_key = home_key * grid_dim + home_ax
    scanned = torch.repeat_interleave(scan_key, c_per, dim=1)
    valid &= home_key == scanned

    # 5. first max_candidates survivors in slot order (the same order in
    # both rows of a pair)
    rank_key = torch.where(
        valid, k8c - torch.arange(k8c, dtype=torch.int32, device=dev)[None, :], 0)
    sel = _first_k(rank_key, max_candidates)
    # empty entries decode to id 0x1FFFF; the reference's gathers clamp such
    # ids to N-1, so clamping here leaves every later result unchanged
    grid_idx = torch.clamp(torch.gather(cand, 1, sel), max=n - 1)
    grid_valid = torch.gather(valid, 1, sel)

    # 6. global bodies: the first `max_globals` by index, tested by everyone
    g_ok = is_global & active
    gidx = _first_k(g_ok.int(), max_globals)
    gvalid = g_ok[gidx]
    gidx_b = gidx[None, :].expand(n, max_globals)
    gvalid_b = (gvalid[None, :] & active[:, None] & dynamic[:, None]
                & ~is_global[:, None]
                & layer_table[layer.long()[:, None], layer.long()[gidx_b]])

    cand_idx = torch.cat([gidx_b.int(), grid_idx], dim=1)
    valid = torch.cat([gvalid_b, grid_valid], dim=1)
    return cand_idx, valid
