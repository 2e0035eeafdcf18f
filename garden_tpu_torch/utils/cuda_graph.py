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
an earlier call (0 on eager, warm-up and capture calls).

A replay enters none of the spans `fn` opens, so the capture records their
layout (`profiler.capture`): at each span's edges it reads the capturing
stream's frontier, the nodes the next captured op will depend on, through
the CUDA driver (ctypes on libcuda, which PyTorch has loaded; nothing is
added to the graph). Once `fn` returns, still inside the capture, it reads
the graph's nodes and edges: where they form one chain, as a capture on
one stream does, a frontier's place in it is the count of device-op nodes
(kernels, memsets, memcpys) captured before the mark, and the chain is also
the order in which a replay runs them. Elsewhere the graph keeps no layout.
While a profiler records, a replay runs inside `profiler.replay(layout)`:
the span `graph_replay` around the launch, with a zero-length record of
each of `fn`'s spans under it, each naming its range of the replay's ops.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from garden_tpu_torch.utils import profiler

_SEEN = object()                     # a key called once, eagerly
# CUgraphNodeType of the device-op nodes
_OP_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_CAPTURE_ACTIVE = 1                  # CU_STREAM_CAPTURE_STATUS_ACTIVE
_P = ctypes.c_void_p
_cu: Any = None


def _driver() -> Optional[ctypes.CDLL]:
    """The CUDA driver's graph queries, declared once; None where the
    driver or a query is missing."""
    global _cu
    if _cu is None:
        _cu = False
        try:
            cu = ctypes.CDLL("libcuda.so.1")
            sizes = ctypes.POINTER(ctypes.c_size_t)
            for name, args in (
                    ("cuStreamGetCaptureInfo_v2",
                     (_P, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
                      ctypes.POINTER(_P), ctypes.POINTER(ctypes.POINTER(_P)), sizes)),
                    ("cuGraphGetNodes", (_P, ctypes.POINTER(_P), sizes)),
                    ("cuGraphGetEdges", (_P, ctypes.POINTER(_P), ctypes.POINTER(_P), sizes)),
                    ("cuGraphNodeGetType", (_P, ctypes.POINTER(ctypes.c_int)))):
                fn = getattr(cu, name)
                fn.argtypes, fn.restype = args, ctypes.c_int
            _cu = cu
        except (OSError, AttributeError):
            pass
    return _cu or None


def _capturing(stream: int, deps=None, n_deps=None) -> Optional[int]:
    """The graph `stream` captures into (a CUgraph), or None."""
    status, graph = ctypes.c_int(), _P()
    err = _driver().cuStreamGetCaptureInfo_v2(_P(stream), ctypes.byref(status), None,
                                               ctypes.byref(graph), deps, n_deps)
    return graph.value if not err and status.value == _CAPTURE_ACTIVE else None


def frontier(stream: int) -> Optional[Tuple[int, ...]]:
    """The nodes the next op captured on `stream` will depend on (none
    before the first); None where `stream` is not capturing."""
    deps, n = ctypes.POINTER(_P)(), ctypes.c_size_t()
    if _capturing(stream, ctypes.byref(deps), ctypes.byref(n)) is None:
        return None
    return tuple(deps[i] for i in range(n.value))


def chain(stream: int) -> Optional[Tuple[Dict[Optional[int], int], List[str]]]:
    """The graph `stream` is capturing, read as one chain: ({node: the
    device-op nodes up to and including it}, the device-op nodes' kinds in
    chain order); None where it is not one chain or `stream` not
    capturing."""
    cu, graph = _driver(), _capturing(stream)
    if graph is None:
        return None
    n, m = ctypes.c_size_t(), ctypes.c_size_t()
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) or cu.cuGraphGetEdges(
            graph, None, None, ctypes.byref(m)):
        return None
    nodes, src, dst = (_P * n.value)(), (_P * m.value)(), (_P * m.value)()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) or cu.cuGraphGetEdges(
            graph, src, dst, ctypes.byref(m)):
        return None
    after = dict(zip(src, dst))
    roots = set(nodes) - set(dst)
    if len(after) != m.value or len(set(dst)) != m.value or len(roots) > 1:
        return None
    node, kind = next(iter(roots), None), ctypes.c_int()
    upto: Dict[Optional[int], int] = {}
    kinds: List[str] = []
    while node is not None:
        if node in upto or cu.cuGraphNodeGetType(_P(node), ctypes.byref(kind)):
            return None
        if kind.value in _OP_KINDS:
            kinds.append(_OP_KINDS[kind.value])
        upto[node] = len(kinds)
        node = after.get(node)
    return (upto, kinds) if len(upto) == n.value else None


def _resolve(layout: Optional[profiler.Layout], stream: int) -> Optional[profiler.Layout]:
    """`layout` with its marks placed on the captured chain; None where
    the graph is no chain or a mark was not read."""
    read = chain(stream) if layout is not None else None
    if read is None:
        return None
    upto, kinds = read
    try:
        return layout.resolve(lambda deps: max((upto[d] for d in deps), default=0), kinds)
    except (KeyError, TypeError):                  # a mark off the chain, or unread
        return None


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
            handle = side.cuda_stream
            layout = None
            with torch.cuda.graph(self.graph, stream=side):
                if _driver() is None:
                    out = fn(tree)
                else:
                    with profiler.capture(lambda: frontier(handle)) as layout:
                        out = fn(tree)
                self.layout = _resolve(layout, handle)
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
            with profiler.replay(self.layout):
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
