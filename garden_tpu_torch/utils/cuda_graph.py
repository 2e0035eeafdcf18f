"""A step function of a state tree, replayed as CUDA graphs on a card.

`GraphedStep(fn)` calls `fn(tree) -> tree` for a caller that steps a state
many times with one layout, where the host's launch loop, not the card,
sets the pace. `fn` must be a plain function of its input: it writes
nothing in place, reads nothing back to the host and takes no decision on
a tensor's value, so that one captured run stands for every later call.

- The key of a call is the tree's structure and each leaf's shape, dtype
  and device (a leaf that is not a tensor by its value, since a capture
  bakes it in). A tree with a leaf off the card, leaves on two cards, or
  batched leaves (inside `torch.func.vmap`) runs `fn` eagerly, every call.
- The first call with a key runs `fn` eagerly. The second copies its input
  into static buffers, runs `fn` once on a side stream (lazy set-up),
  captures it into a graph with a memory pool of its own and replays it.
  Later calls replay. Capture errors propagate.
- A replay copies every input leaf into the static buffers (one
  `_foreach_copy_` a dtype), replays, and returns fresh tensors copied out
  of the static outputs, so no later replay overwrites a tensor a caller
  holds. An output leaf that `fn` passes through unchanged is the caller's
  own input leaf, as in an eager call. Copies and replay run on the
  caller's current stream of the card, so steps in flight stay ordered.

Each call charges the innermost open span of `utils.profiler` with
`graph_calls` 1 and `graph_replays` 1 when it replayed a graph captured by
an earlier call (0 on eager, warm-up and capture calls). A replay enters
none of the spans `fn` opens: on a card a replayed step's span has no
children.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from garden_tpu_torch.utils import profiler

_SEEN = object()                     # a key called once, eagerly


def _leaf_key(x: Any) -> Tuple:
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), x.dtype, x.device)
    return ("v", type(x), x)


def _card(leaves: List[Any]) -> Optional[torch.device]:
    """The one card all tensor leaves live on, or None where a graph
    cannot stand for the call."""
    devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
    if len(devices) != 1 or torch._C._are_functorch_transforms_active():
        return None
    (device,) = devices
    return device if device.type == "cuda" else None


def _by_dtype(tensors: List[torch.Tensor]) -> List[List[int]]:
    groups: Dict[torch.dtype, List[int]] = collections.defaultdict(list)
    for i, x in enumerate(tensors):
        groups[x.dtype].append(i)
    return list(groups.values())


class _Graph:
    """One captured run of `fn` on one input layout, its static buffers,
    and where each output leaf comes from."""

    def __init__(self, fn: Callable, leaves: List[Any], spec, device: torch.device):
        self.device = device
        self.tensor_at = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        with torch.cuda.device(device):
            self.static_in = [leaves[i].clone() for i in self.tensor_at]
            tree = list(leaves)
            for i, x in zip(self.tensor_at, self.static_in):
                tree[i] = x
            tree = tree_unflatten(tree, spec)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(tree)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                out = fn(tree)
        out_leaves, self.out_spec = tree_flatten(out)
        static_at = {id(x): k for k, x in zip(self.tensor_at, self.static_in)}
        # each output leaf: ("in", input leaf index), ("out", static output
        # index) or ("value", a leaf that is not a tensor)
        self.sources: List[Tuple[str, Any]] = []
        self.static_out: List[torch.Tensor] = []
        first_out: Dict[int, int] = {}
        for x in out_leaves:
            if not isinstance(x, torch.Tensor):
                self.sources.append(("value", x))
            elif id(x) in static_at:
                self.sources.append(("in", static_at[id(x)]))
            else:
                if id(x) not in first_out:
                    first_out[id(x)] = len(self.static_out)
                    self.static_out.append(x)
                self.sources.append(("out", first_out[id(x)]))
        self.in_groups = _by_dtype(self.static_in)
        self.out_groups = _by_dtype(self.static_out)

    def __call__(self, leaves: List[Any]) -> Any:
        with torch.cuda.device(self.device):
            src = [leaves[i] for i in self.tensor_at]
            for group in self.in_groups:
                torch._foreach_copy_([self.static_in[k] for k in group],
                                     [src[k] for k in group])
            self.graph.replay()
            fresh = [torch.empty_like(x) for x in self.static_out]
            for group in self.out_groups:
                torch._foreach_copy_([fresh[k] for k in group],
                                     [self.static_out[k] for k in group])
        out = [leaves[v] if kind == "in" else fresh[v] if kind == "out" else v
               for kind, v in self.sources]
        return tree_unflatten(out, self.out_spec)


class GraphedStep:
    """`fn(tree) -> tree`, replayed as one CUDA graph per input layout on a
    card and called eagerly elsewhere (the module's docstring)."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn
        self.graphs: Dict[Tuple, Any] = {}

    def __call__(self, tree: Any) -> Any:
        leaves, spec = tree_flatten(tree)
        device = _card(leaves)
        graph = None
        if device is not None:
            key = (spec, tuple(_leaf_key(x) for x in leaves))
            graph = self.graphs.get(key)
            if graph is None:
                self.graphs[key] = _SEEN
        replay = isinstance(graph, _Graph)
        profiler.count("graph_calls", 1)
        profiler.count("graph_replays", int(replay))
        if graph is _SEEN:
            graph = self.graphs[key] = _Graph(self.fn, leaves, spec, device)
        return self.fn(tree) if graph is None else graph(leaves)
