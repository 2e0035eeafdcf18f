"""Entity-Component-System over structure-of-arrays device buffers.

Port of `garden_tpu.core.ecs`. A component type is a fixed-capacity
struct-of-arrays: one array per field, indexed by entity id, plus a `has`
mask (a "hole" is `has=False`). Entities are int indices. `EventRegistry`
is the static, priority-ordered list of `(state, ctx) -> state` functions
an event runs in order.

Host code (entity creation, scene loading) mutates numpy staging stores;
`World.device_state()` copies them into a dict of tensors on the world's
device, the state the Engine's step consumes, and `adopt(state)` copies a
stepped state back. Both copy: on the CPU `torch.from_numpy` and
`Tensor.numpy()` share memory, and a host `set_component` must never write
into a state that was already handed out (nor a step into the stores).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
State = Dict[str, Any]

NULL_ENTITY = -1


@dataclasses.dataclass(frozen=True)
class Field:
    """One SoA field of a component: trailing shape, numpy dtype, fill value."""

    shape: Tuple[int, ...] = ()
    dtype: Any = np.float32
    default: Any = 0


@dataclasses.dataclass(frozen=True)
class ComponentDef:
    """Schema for a component type."""

    name: str
    fields: Dict[str, Field]

    def create_store(self, capacity: int) -> Dict[str, np.ndarray]:
        store: Dict[str, np.ndarray] = {
            "has": np.zeros((capacity,), dtype=bool),
        }
        for fname, f in self.fields.items():
            arr = np.empty((capacity,) + tuple(f.shape), dtype=np.dtype(f.dtype))
            arr[...] = np.asarray(f.default, dtype=np.dtype(f.dtype))
            store[fname] = arr
        return store


class EventRegistry:
    """Static ordered event registry.

    Subscribers are pure functions `(state, ctx) -> state`. `run` folds them
    in (priority, insertion) order. Events are declared implicitly on first
    subscribe.
    """

    def __init__(self) -> None:
        self._events: Dict[str, List[Tuple[float, int, Callable]]] = {}
        self._counter = 0

    def subscribe(self, event: str, fn: Callable, priority: float = 0.0) -> None:
        self._events.setdefault(event, []).append((priority, self._counter, fn))
        self._counter += 1
        self._events[event].sort(key=lambda t: (t[0], t[1]))

    def subscribers(self, event: str) -> List[Callable]:
        return [fn for _, _, fn in self._events.get(event, [])]

    def has_event(self, event: str) -> bool:
        return bool(self._events.get(event))

    def run(self, event: str, state: State, ctx: Any = None) -> State:
        for fn in self.subscribers(event):
            state = fn(state, ctx)
        return state


class System:
    """Base class for systems.

    `attach(world)` is called when the system is created; systems then
    subscribe to events on `world.events`. Systems that own a component type
    declare `component` (a ComponentDef).
    """

    component: Optional[ComponentDef] = None

    def attach(self, world: "World") -> None:  # pragma: no cover - trivial
        self.world = world


def to_device(a: np.ndarray, device) -> Tensor:
    """A copy of a host array on `device` (never a view of its memory)."""
    return torch.tensor(np.asarray(a), device=device)


def to_host(t: Tensor) -> np.ndarray:
    """A writable host copy of a tensor (never a view of its memory)."""
    return t.detach().cpu().numpy().copy()


class World:
    """The Manager: owns entities, component stores, systems, and events.

    Host-side entity/component mutation stages into numpy arrays; call
    `device_state()` to materialize the tensor dict the step consumes on
    `device`. After stepping, `adopt(state)` writes results back so host code
    (scene save, inspection) sees them.
    """

    def __init__(self, capacity: int = 4096, device="cuda") -> None:
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self.events = EventRegistry()
        self.systems: Dict[str, System] = {}
        self._defs: Dict[str, ComponentDef] = {}
        self._stores: Dict[str, Dict[str, np.ndarray]] = {}
        self._alive = np.zeros((self.capacity,), dtype=bool)
        self._generation = np.zeros((self.capacity,), dtype=np.int32)
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._initialized = False

    # -- systems ----------------------------------------------------------

    def create_system(self, system: System, name: Optional[str] = None) -> System:
        name = name or type(system).__name__
        if name in self.systems:
            raise ValueError(f"system {name!r} already exists")
        self.systems[name] = system
        if system.component is not None:
            self.register_component(system.component)
        system.attach(self)
        return system

    def get_system(self, name: str) -> System:
        return self.systems[name]

    def systems_of(self, base: type) -> List[System]:
        """All systems that are instances of `base`."""
        return [s for s in self.systems.values() if isinstance(s, base)]

    def initialize(self) -> None:
        """Run PreInit -> Init -> PostInit."""
        if self._initialized:
            raise RuntimeError("already initialized")
        for event in ("PreInit", "Init", "PostInit"):
            for fn in self.events.subscribers(event):
                fn(self)
        self._initialized = True

    # -- components -------------------------------------------------------

    def register_component(self, cdef: ComponentDef) -> None:
        if cdef.name in self._defs:
            raise ValueError(f"component {cdef.name!r} already registered")
        self._defs[cdef.name] = cdef
        self._stores[cdef.name] = cdef.create_store(self.capacity)

    def component_names(self) -> Iterable[str]:
        return self._defs.keys()

    # -- entities ---------------------------------------------------------

    def create_entity(self) -> int:
        if not self._free:
            raise RuntimeError("entity capacity exhausted")
        e = self._free.pop()
        self._alive[e] = True
        return e

    def destroy_entity(self, e: int) -> None:
        if not self._alive[e]:
            raise KeyError(f"entity {e} not alive")
        self._alive[e] = False
        self._generation[e] += 1
        for store in self._stores.values():
            store["has"][e] = False
        self._free.append(e)

    def is_alive(self, e: int) -> bool:
        return bool(self._alive[e])

    def entity_count(self) -> int:
        return int(self._alive.sum())

    def add_component(self, e: int, name: str, **values: Any) -> None:
        store = self._stores[name]
        store["has"][e] = True
        self.set_component(e, name, **values)

    def set_component(self, e: int, name: str, **values: Any) -> None:
        store = self._stores[name]
        cdef = self._defs[name]
        for k, v in values.items():
            if k not in cdef.fields:
                raise KeyError(f"{name} has no field {k!r}")
            store[k][e] = np.asarray(v, dtype=store[k].dtype)

    def remove_component(self, e: int, name: str) -> None:
        self._stores[name]["has"][e] = False

    def has_component(self, e: int, name: str) -> bool:
        return bool(self._stores[name]["has"][e])

    def get_component(self, e: int, name: str) -> Dict[str, Any]:
        store = self._stores[name]
        return {k: np.array(v[e]) for k, v in store.items() if k != "has"}

    # -- state ------------------------------------------------------------

    def device_state(self) -> State:
        """Copy the world into a dict of tensors on the world's device."""
        return {
            "entities": {
                "alive": to_device(self._alive, self.device),
                "generation": to_device(self._generation, self.device),
            },
            "components": {
                name: {k: to_device(v, self.device) for k, v in store.items()}
                for name, store in self._stores.items()
            },
        }

    def adopt(self, state: State) -> None:
        """Write a stepped state back into host-side staging arrays, as
        copies that host code may mutate in place."""
        self._alive = to_host(state["entities"]["alive"])
        self._generation = to_host(state["entities"]["generation"])
        self._stores = {
            name: {k: to_host(v) for k, v in store.items()}
            for name, store in state["components"].items()
        }
        free_mask = ~self._alive
        self._free = list(np.nonzero(free_mask)[0][::-1])


def masked_update(has: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """Apply `new` only where the component exists (broadcast mask over
    trailing dims)."""
    mask = has
    while mask.ndim < new.ndim:
        mask = mask[..., None]
    return torch.where(mask, new, old)
