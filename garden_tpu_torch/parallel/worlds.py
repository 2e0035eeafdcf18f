"""Many worlds stepped as one batch on one device.

Port of `garden_tpu.parallel.worlds`. The reference shards a leading world
axis over a device mesh with `jit(vmap(step))`; here the world axis lives on
one device and `step` is `torch.func.vmap` of the step function, so each
operation of the step runs once for all worlds.

The port's physics step batches under vmap with no per-world loop: every
operation it runs has a batching rule (the step writes no tensor in place
and reads nothing back to the host), so vmap never falls back to looping
over the worlds. The parity test turns vmap's fallback warning into an
error. There is no buffer donation: each step returns new tensors.

Usage:
    wb = WorldBatch(step_fn, n_worlds, device="cuda")
    batched = wb.replicate(state)            # or wb.stack(states)
    batched = wb.step(batched)               # vmap(step_fn) over the worlds
    stats = wb.reduce(batched, fn)           # a reduction over the worlds
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

State = Any

REDUCERS = {"mean": torch.mean, "sum": torch.sum, "max": torch.amax, "min": torch.amin}


class WorldBatch:
    def __init__(self, step_fn: Callable, n_worlds: int, device="cuda"):
        self.n_worlds = n_worlds
        self.device = torch.device(device)
        self._step = torch.func.vmap(step_fn)

    def replicate(self, state: State, vary_fn: Optional[Callable] = None) -> State:
        """One world state copied to every world on the batch's device;
        `vary_fn(state, index)` (vmapped, index a 0-d int32 tensor) can
        decorrelate the worlds."""
        batched = tree_map(
            lambda x: x.to(self.device).expand((self.n_worlds,) + tuple(x.shape)).clone(
                memory_format=torch.contiguous_format),
            state)
        if vary_fn is not None:
            index = torch.arange(self.n_worlds, dtype=torch.int32, device=self.device)
            batched = torch.func.vmap(vary_fn)(batched, index)
        return batched

    def stack(self, states: List[State]) -> State:
        return tree_map(lambda *xs: torch.stack([x.to(self.device) for x in xs]),
                        states[0], *states[1:])

    def step(self, batched: State) -> State:
        return self._step(batched)

    def reduce(self, batched: State, fn: Callable, reducer: str = "mean") -> Any:
        """fn of each world, reduced over the worlds (mean, sum, max or min)."""
        red = REDUCERS[reducer]
        return tree_map(lambda v: red(v, dim=0), torch.func.vmap(fn)(batched))

    def world(self, batched: State, index: int) -> State:
        """One world's state on the host, as numpy arrays."""
        return tree_map(lambda x: x[index].cpu().numpy(), batched)
