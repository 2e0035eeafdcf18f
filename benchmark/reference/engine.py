"""Engine: composes systems into one per-tick step + host loop.

Port of `garden_tpu.engine`. Every event subscriber is a pure
`(state, ctx) -> state` function, so running Input -> Update -> Output in
order is the whole tick. `build_step()` returns a plain Python callable
over the state dict: it is functional, never writing into a tensor of its
input state, so one state can be stepped twice and a checkpointed state
resumed. The host loop feeds wall-time deltas and (optionally) sleeps to the
tick-rate cap; signal handlers stop the loop cleanly.

The tick's `delta_time` stays a Python float, applied to float32 tensors
with float32 semantics: no host-to-device copy a tick. Each subscriber runs
inside a `torch.profiler` range named after it (`stage_name`, e.g.
"PhysicsSystem.update"), so traces show the tick by system.
"""

from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, Optional

import torch

from torch.profiler import record_function

from benchmark.reference.core.config import EngineConfig
from benchmark.reference.core.ecs import World


def _require_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Engine: CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def stage_name(fn: Callable) -> str:
    """A subscriber's range name: "<System class>.<method>" for a system's
    method, else the function's name."""
    owner = getattr(fn, "__self__", None)
    return f"{type(owner).__name__}.{fn.__name__}" if owner is not None else fn.__name__


class Engine:
    def __init__(self, config: Optional[EngineConfig] = None, device="cuda"):
        self.config = config or EngineConfig()
        self.world = World(capacity=self.config.capacity, device=_require_device(device))
        self._step = None
        self._running = False
        self._extra_state: Dict[str, Callable[[], Any]] = {}

    @property
    def device(self) -> torch.device:
        return self.world.device

    # -- composition ---------------------------------------------------------

    def create_system(self, system, name: Optional[str] = None):
        return self.world.create_system(system, name)

    def register_state(self, key: str, provider: Callable[[], Any]) -> None:
        """Register an extra state subtree (e.g. 'physics', 'frame')."""
        self._extra_state[key] = provider

    def initialize(self) -> None:
        self.world.initialize()
        # physics system auto-registers its state subtree
        phys = self.world.systems.get("PhysicsSystem")
        if phys is not None and "physics" not in self._extra_state:
            self.register_state("physics", phys.device_state)

    # -- state ----------------------------------------------------------------

    def device_state(self) -> Dict[str, Any]:
        state = self.world.device_state()
        for key, provider in self._extra_state.items():
            state[key] = provider()
        dev = self.world.device
        state["tick"] = torch.zeros((), dtype=torch.int32, device=dev)
        state["time"] = torch.zeros((), dtype=torch.float32, device=dev)
        return state

    # -- the step ---------------------------------------------------------------

    def build_step(self) -> Callable:
        """Input -> Update -> Output as one step function."""
        events = self.world.events

        def step(state: Dict[str, Any], delta_time) -> Dict[str, Any]:
            ctx = {"delta_time": float(delta_time), "time": state["time"],
                   "tick": state["tick"]}
            for event in ("Input", "Update", "Output"):
                for fn in events.subscribers(event):
                    with record_function(stage_name(fn)):
                        state = fn(state, ctx)
            return dict(
                state,
                tick=state["tick"] + 1,
                time=state["time"] + ctx["delta_time"],
            )

        self._step = step
        return self._step

    # -- host loop --------------------------------------------------------------

    def enter_loop(self, state: Dict[str, Any], max_ticks: Optional[int] = None,
                   tick_rate: Optional[int] = None) -> Dict[str, Any]:
        """Run the tick loop at a capped rate until stopped."""
        if self._step is None:
            self.build_step()
        tick_rate = tick_rate or self.config.max_tick_rate
        min_dt = 1.0 / tick_rate if tick_rate > 0 else 0.0
        self._running = True

        def stop(sig, frame):
            self._running = False

        old_handlers = {}
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                old_handlers[sig] = signal.signal(sig, stop)
            except ValueError:  # not on main thread
                pass

        try:
            last = time.monotonic()
            ticks = 0
            while self._running and (max_ticks is None or ticks < max_ticks):
                now = time.monotonic()
                delta = now - last
                if delta < min_dt:
                    time.sleep(min_dt - delta)
                    now = time.monotonic()
                    delta = now - last
                last = now
                state = self._step(state, delta)
                ticks += 1
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        return state

    def run_ticks(self, state: Dict[str, Any], n: int, dt: float) -> Dict[str, Any]:
        """Run n ticks with a fixed delta (deterministic/headless testing)."""
        if self._step is None:
            self.build_step()
        for _ in range(n):
            state = self._step(state, dt)
        return state
