"""Input system: buffered keyboard/mouse/window state.

Rebuild of InputSystem (include/garden/system/input.hpp:95, source/system/
input.cpp): the reference accumulates GLFW callbacks on the OS thread and
swaps double-buffered key/mouse bitmaps into the render thread each tick
(input.cpp:105+). Headless engines have no window, but the same state
machine serves replays, tools, bots and remote input: callers `push_*`
events from any source (terminal, network, scripted), `swap()` runs at
tick start, and queries see a consistent frame snapshot with
pressed/released edge detection.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from garden_tpu_torch.core.ecs import System


class InputSystem(System):
    def __init__(self, window_size: Tuple[int, int] = (1280, 720)):
        # accumulation buffers (the OS-thread side)
        self._pending_down: Set[str] = set()
        self._pending_up: Set[str] = set()
        self._pending_cursor: Optional[Tuple[float, float]] = None
        self._pending_scroll: Tuple[float, float] = (0.0, 0.0)
        self._pending_text: List[str] = []
        self._pending_drops: List[str] = []
        # frame-visible state (the render-thread side)
        self.down: Set[str] = set()
        self.pressed: Set[str] = set()
        self.released: Set[str] = set()
        self.cursor: Tuple[float, float] = (0.0, 0.0)
        self.cursor_delta: Tuple[float, float] = (0.0, 0.0)
        self.scroll: Tuple[float, float] = (0.0, 0.0)
        self.text: str = ""
        self.dropped_files: List[str] = []
        self.window_size = window_size

    def attach(self, world) -> None:
        super().attach(world)

    # -- event producers (any thread/source) --------------------------------

    def push_key_down(self, key: str) -> None:
        self._pending_down.add(key)

    def push_key_up(self, key: str) -> None:
        self._pending_up.add(key)

    def push_cursor(self, x: float, y: float) -> None:
        self._pending_cursor = (x, y)

    def push_scroll(self, dx: float, dy: float) -> None:
        sx, sy = self._pending_scroll
        self._pending_scroll = (sx + dx, sy + dy)

    def push_text(self, s: str) -> None:
        self._pending_text.append(s)

    def push_file_drop(self, path: str) -> None:
        """FileDrop event (input.hpp:93)."""
        self._pending_drops.append(path)

    # -- per-tick swap (the Input event, input.cpp:105+) ----------------------

    def swap(self) -> None:
        self.pressed = {k for k in self._pending_down if k not in self.down}
        self.released = {k for k in self._pending_up if k in self.down}
        self.down = (self.down | self._pending_down) - self._pending_up
        self._pending_down.clear()
        self._pending_up.clear()
        if self._pending_cursor is not None:
            old = self.cursor
            self.cursor = self._pending_cursor
            self.cursor_delta = (self.cursor[0] - old[0], self.cursor[1] - old[1])
            self._pending_cursor = None
        else:
            self.cursor_delta = (0.0, 0.0)
        self.scroll = self._pending_scroll
        self._pending_scroll = (0.0, 0.0)
        self.text = "".join(self._pending_text)
        self._pending_text.clear()
        self.dropped_files = self._pending_drops
        self._pending_drops = []

    # -- queries ---------------------------------------------------------------

    def is_down(self, key: str) -> bool:
        return key in self.down

    def was_pressed(self, key: str) -> bool:
        return key in self.pressed

    def was_released(self, key: str) -> bool:
        return key in self.released
