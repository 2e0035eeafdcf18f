"""Contact events: Entered / Stayed / Exited.

Rebuild of the reference's body/contact listener flow (source/system/
physics.cpp:76-170, 1043-1105: Jolt listeners enqueue Event{data1, data2,
BodyEvent} under a mutex, replayed as ECS events "<listener>.Entered" etc.).
The step exports a per-body touching-partner summary (physics/world.py
`touching`); this module diffs two summaries host-side and fires callbacks —
the mutex+replay machinery is unnecessary because the step is pure.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Set, Tuple

import numpy as np
import torch

Pair = Tuple[int, int]


def touching_pairs(touching: np.ndarray) -> Set[Pair]:
    """(N, S) partner summary (an array, or a tensor on any device) ->
    canonical (lo, hi) body-pair set."""
    if isinstance(touching, torch.Tensor):
        touching = touching.cpu().numpy()
    touching = np.asarray(touching)
    n = touching.shape[0]
    pairs: Set[Pair] = set()
    rows, cols = np.nonzero(touching >= 0)
    for i, s in zip(rows, cols):
        j = int(touching[i, s])
        pairs.add((min(int(i), j), max(int(i), j)))
    return pairs


class ContactEvents:
    """Diffs touching sets across steps; fires Entered/Stayed/Exited."""

    def __init__(self) -> None:
        self._prev: Set[Pair] = set()
        self.on_entered: List[Callable[[int, int], None]] = []
        self.on_exited: List[Callable[[int, int], None]] = []
        self.on_stayed: List[Callable[[int, int], None]] = []

    def process(self, touching: np.ndarray) -> Dict[str, List[Pair]]:
        now = touching_pairs(touching)
        entered = sorted(now - self._prev)
        exited = sorted(self._prev - now)
        stayed = sorted(now & self._prev)
        self._prev = now
        for a, b in entered:
            for cb in self.on_entered:
                cb(a, b)
        for a, b in exited:
            for cb in self.on_exited:
                cb(a, b)
        for a, b in stayed:
            for cb in self.on_stayed:
                cb(a, b)
        return {"entered": entered, "exited": exited, "stayed": stayed}
