"""Many worlds stepped as one batch, sharded over devices and processes.

Port of `garden_tpu.parallel.worlds`. The reference shards a leading world
axis over a device mesh with `jit(vmap(step))`. Here the world axis is cut
into shards, one per entry of `devices`: shard k holds worlds
`k*per .. (k+1)*per - 1` on `devices[k]`, each leaf with a leading world
axis of `per`. A batched state is the list of the shards' states, in
`devices`' order (a one-device batch is a list of one). A device may
repeat, so one card can host several shards; `["cpu"] * 4` runs four on
the CPU. As in the reference, the device list shrinks to a divisor of the
world count, dropping devices from its end.

Under an initialized `torch.distributed` default group the world axis is
split first across the ranks (rank r holds worlds `r*local .. (r+1)*local
- 1`, `local = n_worlds / world_size`), then across each rank's own
devices; `reduce` combines the ranks with one all-reduce. The group's
backend is the caller's: NCCL for one card per rank, gloo where two ranks
share a card or run on the CPU (gloo all-reduces CUDA tensors through the
host).

`step` issues the shards one after another from the calling thread, each
under its own device, and waits on none of them. Every step the port runs
is bound by the host's launch time, so the shards do not overlap today: on
an NVIDIA H100 80GB HBM3 (700 W), 4 shards of 2 bench worlds on 4 cards
took 211.4156 ms a step against 58.6410 ms for the 8 worlds as one batch on
one card (chip_smoke.py phase mc.1; PERF.md). A shard of more
than one world is `torch.func.vmap` of the step. The port's physics step
batches under vmap with no per-world loop: every operation it runs has a
batching rule (the step writes no tensor in place and reads nothing back
to the host), and the parity tests turn vmap's fallback warning into an
error. A shard of exactly one world is stepped by calling the step on that
world, so a step that vmap cannot batch (the combined step, whose kernels
launch through ctypes) runs with one world per shard. There is no buffer
donation: each step returns new tensors.

A step's closure must hold its tensors on its shard's device, where jit
would replicate a closure's constants to every device: so `step_fn` may be
a list of callables, one per entry of `devices` (e.g. `[step.to(d) for d in
devices]` for `entry.CombinedStep`).

Usage:
    wb = WorldBatch(step_fn, n_worlds)          # devices: every visible card
    batched = wb.replicate(state)               # or wb.stack(states)
    batched = wb.step(batched)                  # each shard: vmap(step_fn)
    stats = wb.reduce(batched, fn)              # a reduction over the worlds
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from garden_tpu_torch.physics.world import count_contacts
from garden_tpu_torch.utils import profiler

State = Any

# reducer -> (how a shard's values combine, the all-reduce op across ranks)
REDUCERS = {"mean": (torch.sum, "SUM"), "sum": (torch.sum, "SUM"),
            "max": (torch.amax, "MAX"), "min": (torch.amin, "MIN")}


def _device_guard(device: torch.device):
    """The device guard of a CUDA device (the current device while inside);
    nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _visible_cards() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("WorldBatch: no CUDA card is visible; name the devices "
                           "to run elsewhere, e.g. devices=['cpu'] * 4")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _over_worlds(fn: Callable, per: int) -> Callable:
    """fn mapped over a shard's leading world axis: vmap for more than one
    world, a plain call on the one world otherwise."""
    if per > 1:
        return torch.func.vmap(fn)

    def one(*args):
        out = fn(*tree_map(lambda x: x[0], args))
        return tree_map(lambda x: x[None], out)
    return one


class WorldBatch:
    def __init__(self, step_fn: Union[Callable, Sequence[Callable]], n_worlds: int,
                 devices: Optional[Sequence] = None):
        devices = [torch.device(d) for d in (devices if devices is not None
                                             else _visible_cards())]
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d for d in devices]
        if callable(step_fn):
            step_fn = [step_fn] * len(devices)
        steps = list(step_fn)
        if len(steps) != len(devices):
            raise ValueError(f"WorldBatch: {len(steps)} step functions for "
                             f"{len(devices)} devices")
        self.rank, self.n_ranks = ((dist.get_rank(), dist.get_world_size())
                                   if dist.is_available() and dist.is_initialized()
                                   else (0, 1))
        if n_worlds % self.n_ranks:
            raise ValueError(f"WorldBatch: {n_worlds} worlds do not divide over "
                             f"{self.n_ranks} processes")
        local = n_worlds // self.n_ranks
        # shrink to the largest divisor so each device gets equal worlds
        while local % len(devices):
            devices.pop()
            steps.pop()
        self.n_worlds = n_worlds
        self.devices = devices
        self.per = local // len(devices)
        self.first = self.rank * local          # this rank's first global world
        self._steps = [_over_worlds(f, self.per) for f in steps]

    def _indices(self, k: int) -> range:
        """The global indices of shard k's worlds."""
        start = self.first + k * self.per
        return range(start, start + self.per)

    def replicate(self, state: State, vary_fn: Optional[Callable] = None) -> List[State]:
        """One world state copied to every world, each shard on its device;
        `vary_fn(state, index)` (mapped over the worlds, index a 0-d int32
        tensor holding the world's global index) can decorrelate them, so
        world i is world i of any other sharding."""
        shards = []
        for k, dev in enumerate(self.devices):
            with _device_guard(dev):
                shard = tree_map(lambda x: x.to(dev).expand(
                    (self.per,) + tuple(x.shape)).clone(
                        memory_format=torch.contiguous_format), state)
                if vary_fn is not None:
                    idx = self._indices(k)
                    index = torch.arange(idx.start, idx.stop, dtype=torch.int32, device=dev)
                    shard = _over_worlds(vary_fn, self.per)(shard, index)
            shards.append(shard)
        return shards

    def stack(self, states: List[State]) -> List[State]:
        """All n_worlds world states (global order) -> this rank's shards,
        shard k holding states[i] for its worlds i."""
        if len(states) != self.n_worlds:
            raise ValueError(f"WorldBatch.stack: {len(states)} states for "
                             f"{self.n_worlds} worlds")
        return [tree_map(lambda *xs: torch.stack([x.to(dev) for x in xs]),
                         *[states[i] for i in self._indices(k)])
                for k, dev in enumerate(self.devices)]

    def step(self, batched: List[State]) -> List[Any]:
        """Each shard through its step, issued shard after shard under its
        own device with no wait in between; -> the list of the shards'
        outputs (a step returning (state, image) gives (states, images)
        per shard). The whole runs in the span `worlds.step`, each shard's
        issue in a span `shard` whose device is its card; a shard span
        counts the contact rows of its output (`count_contacts`)."""
        out = []
        with profiler.span("worlds.step"):
            for k, (fn, dev, shard) in enumerate(zip(self._steps, self.devices, batched)):
                with _device_guard(dev), profiler.span("shard", device=dev, shard=k):
                    out.append(fn(shard))
                    count_contacts(out[-1])
        return out

    def reduce(self, batched: List[State], fn: Callable, reducer: str = "mean") -> Any:
        """fn of each world, reduced over all the worlds (mean, sum, max or
        min): on each shard, then over the shards on devices[0], then, under
        a process group, one all-reduce across the ranks."""
        red, op = REDUCERS[reducer]
        parts = []
        for dev, shard in zip(self.devices, batched):
            with _device_guard(dev):
                vals = _over_worlds(fn, self.per)(shard)
                parts.append(tree_map(lambda v: red(v, dim=0), vals))
        first = self.devices[0]
        out = tree_map(lambda *vs: red(torch.stack([v.to(first) for v in vs]), dim=0),
                       *parts)
        if self.n_ranks > 1:
            def all_reduce(v):
                dist.all_reduce(v, op=getattr(dist.ReduceOp, op))
                return v
            out = tree_map(all_reduce, out)
        if reducer == "mean":
            out = tree_map(lambda v: v / self.n_worlds, out)
        return out

    def world(self, batched: List[State], index: int) -> State:
        """World `index` (global) on the host, as numpy arrays; it must be
        one of this rank's worlds."""
        k, row = divmod(index - self.first, self.per)
        if not 0 <= k < len(self.devices):
            raise IndexError(f"WorldBatch.world: world {index} is not on rank "
                             f"{self.rank} (it holds {self.first}.."
                             f"{self.first + self.per * len(self.devices) - 1})")
        return tree_map(lambda x: x[row].cpu().numpy(), batched[k])
