"""Body positions from the seed: the only input a run draws.

The bodies stand on a lattice (`lattice`), in the order in which the
configuration's scene adds them. The seed shifts each dynamic body
horizontally by a uniform amount in +-`shift` on x and on z; world `w` of
a batch draws its own shifts from (seed, w). With a lattice gap of
`spacing - 2 * half_extent` and shifts under half of it, no two bodies start
in contact. The ground plane, body 0, stays at the origin.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def lattice(cfg: Dict[str, Any]) -> np.ndarray:
    """(n_bodies - 1, 3) float32 lattice points of the dynamic bodies: axes
    nested in the order `lattice.order` names them, outermost first, each
    `lattice.dims` points long, centred on x and z about `lattice.side`."""
    lat = cfg["bodies"]["lattice"]
    side, sp, y0, extent = lat["side"], lat["spacing"], lat["y0"], lat["dims"]
    n_dyn = cfg["n_bodies"] - 1
    outer, mid, inner = lat["order"]
    if extent["x"] * extent["y"] * extent["z"] < n_dyn:
        raise ValueError(f"a lattice of {extent} holds fewer than {n_dyn} bodies")
    idx = np.stack(np.meshgrid(np.arange(extent[outer]), np.arange(extent[mid]),
                               np.arange(extent[inner]), indexing="ij"),
                   axis=-1).reshape(-1, 3)[:n_dyn]
    at = {a: idx[:, i] for i, a in enumerate((outer, mid, inner))}
    return np.stack([at["x"] * sp - side / 2, y0 + at["y"] * sp, at["z"] * sp - side / 2],
                    axis=-1).astype(np.float32)


def world_seed(seed: int, world: int) -> int:
    """The generator seed of world `world` under run seed `seed`."""
    return (seed % 2 ** 50) * 4096 + world


def positions(cfg: Dict[str, Any], seed: int, world: int, device) -> torch.Tensor:
    """(n_bodies, 3) float32 start positions on `device`: the plane at the
    origin, then the lattice shifted on x and z by the seed."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(world_seed(seed, world))
    n_dyn = cfg["n_bodies"] - 1
    u = torch.rand((n_dyn, 2), generator=gen, device=device, dtype=torch.float32)
    shift = (2.0 * u - 1.0) * cfg["bodies"]["shift"]
    pos = torch.as_tensor(lattice(cfg), device=device)
    pos = pos + torch.stack([shift[:, 0], torch.zeros_like(shift[:, 0]), shift[:, 1]], -1)
    return torch.cat([torch.zeros((1, 3), device=device), pos])


def with_positions(phys: Dict[str, Any], pos: torch.Tensor) -> Dict[str, Any]:
    """A physics state dict whose bodies (and previous poses) start at `pos`."""
    return dict(phys, bodies=dict(phys["bodies"], pos=pos), prev_pos=pos.clone())
