"""UI widget systems: anchored transforms, triggers, labels, buttons.

Port of `garden_tpu.systems.ui`, host-side as there: widgets emit into the
port's `render/sprites.SpriteBatch` through its `render/text.FontAtlas`.
Rebuild of the UI layer (reference section 2.9: UiTransformSystem with
anchored 2D transforms ui/transform.hpp:89-123, UiTriggerSystem hit testing,
UiLabelSystem, UiButtonSystem, UiCheckboxSystem, UiInputSystem) — widgets
are ECS components; layout resolves anchors against the frame size; hit
testing is a vectorized point-in-rect pass; rendering goes through the
sprite/text composite (render/sprites.py, render/text.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from benchmark.reference.core.ecs import ComponentDef, Field, System
from benchmark.reference.render.sprites import Sprite

# anchor presets (ui/transform.hpp anchor semantics)
ANCHOR_TOP_LEFT = 0
ANCHOR_CENTER = 1
ANCHOR_TOP_RIGHT = 2
ANCHOR_BOTTOM_LEFT = 3
ANCHOR_BOTTOM_RIGHT = 4

UI_TRANSFORM = ComponentDef(
    "ui_transform",
    {
        "position": Field((2,), np.float32, 0.0),   # offset from anchor
        "size": Field((2,), np.float32, (100.0, 24.0)),
        "anchor": Field((), np.int32, ANCHOR_TOP_LEFT),
        "visible": Field((), np.bool_, True),
    },
)

UI_BUTTON = ComponentDef(
    "ui_button",
    {
        "hovered": Field((), np.bool_, False),
        "pressed": Field((), np.bool_, False),
        "enabled": Field((), np.bool_, True),
    },
)

UI_CHECKBOX = ComponentDef(
    "ui_checkbox",
    {"checked": Field((), np.bool_, False)},
)


def resolve_rects(store: Dict[str, np.ndarray], frame_w: float, frame_h: float
                  ) -> np.ndarray:
    """Anchored layout -> screen rects (N, 4) [x, y, w, h]."""
    n = store["position"].shape[0]
    rects = np.zeros((n, 4), np.float32)
    pos = np.asarray(store["position"])
    size = np.asarray(store["size"])
    anchor = np.asarray(store["anchor"])
    ax = np.select(
        [anchor == ANCHOR_TOP_LEFT, anchor == ANCHOR_BOTTOM_LEFT,
         anchor == ANCHOR_CENTER],
        [0.0, 0.0, frame_w / 2 - size[:, 0] / 2],
        default=frame_w - size[:, 0],
    )
    ay = np.select(
        [anchor == ANCHOR_TOP_LEFT, anchor == ANCHOR_TOP_RIGHT,
         anchor == ANCHOR_CENTER],
        [0.0, 0.0, frame_h / 2 - size[:, 1] / 2],
        default=frame_h - size[:, 1],
    )
    rects[:, 0] = ax + pos[:, 0]
    rects[:, 1] = ay + pos[:, 1]
    rects[:, 2:] = size
    return rects



def _component_ids(w, *stores) -> "np.ndarray":
    """Indices of alive entities that have ALL the given component stores —
    a vectorized mask intersection, so per-widget host loops scan only the
    actual widgets instead of the full entity capacity."""
    mask = w._alive.copy()
    for s in stores:
        mask &= np.asarray(s["has"])
    return np.nonzero(mask)[0]


class UiTransformSystem(System):
    component = UI_TRANSFORM


class UiButtonSystem(System):
    """Buttons with hover/press state and click callbacks
    (ui/button.hpp analog). `process` runs host-side with cursor input."""

    component = UI_BUTTON

    def __init__(self) -> None:
        self._on_click: Dict[int, Callable[[int], None]] = {}

    def on_click(self, entity: int, fn: Callable[[int], None]) -> None:
        self._on_click[entity] = fn

    def process(self, cursor: Tuple[float, float], mouse_down: bool,
                frame_size: Tuple[float, float]) -> List[int]:
        """Hit test + state update; returns clicked entities
        (UiTriggerSystem hit testing analog)."""
        w = self.world
        t = w._stores.get("ui_transform")
        b = w._stores.get("ui_button")
        if t is None or b is None:
            return []
        rects = resolve_rects(t, *frame_size)
        cx, cy = cursor
        clicked = []
        for e in _component_ids(w, t, b):
            if not (t["visible"][e] and b["enabled"][e]):
                continue
            x, y, ww, hh = rects[e]
            inside = x <= cx < x + ww and y <= cy < y + hh
            was_pressed = bool(b["pressed"][e])
            b["hovered"][e] = inside
            b["pressed"][e] = inside and mouse_down
            if was_pressed and inside and not mouse_down:
                clicked.append(e)
                cb = self._on_click.get(e)
                if cb:
                    cb(e)
                # checkbox toggle (UiCheckboxSystem)
                c = w._stores.get("ui_checkbox")
                if c is not None and c["has"][e]:
                    c["checked"][e] = not c["checked"][e]
        return clicked


class UiCheckboxSystem(System):
    component = UI_CHECKBOX


UI_LABEL = ComponentDef(
    "ui_label",
    {
        "color": Field((4,), np.float32, 1.0),
        "scale": Field((), np.float32, 1.0),
    },
)

UI_INPUT = ComponentDef(
    "ui_input",
    {
        "focused": Field((), np.bool_, False),
        "cursor": Field((), np.int32, 0),       # caret position
        "max_length": Field((), np.int32, 64),
        "enabled": Field((), np.bool_, True),
    },
)

UI_SCISSOR = ComponentDef(
    "ui_scissor",
    {"enabled": Field((), np.bool_, True)},
)

UI_TRIGGER = ComponentDef(
    "ui_trigger",
    {
        "inside": Field((), np.bool_, False),
        "enabled": Field((), np.bool_, True),
    },
)


class UiLabelSystem(System):
    """Text labels rendered through the FontAtlas into the UI sprite pass
    (UiLabelSystem, reference system/ui/ 625 LoC). Text strings are host
    state (like spawner prefab paths); color/scale are device fields."""

    component = UI_LABEL

    def __init__(self) -> None:
        self._text: Dict[int, str] = {}

    def set_text(self, entity: int, text: str) -> None:
        self._text[entity] = text

    def text(self, entity: int) -> str:
        return self._text.get(entity, "")

    def emit(self, batch, font, frame_size: Tuple[float, float]) -> None:
        """Append label sprites to the batch (text mesh building)."""
        w = self.world
        t = w._stores.get("ui_transform")
        l = w._stores.get("ui_label")
        if t is None or l is None:
            return
        rects = resolve_rects(t, *frame_size)
        scissor = _active_scissor(w, rects)
        for e in _component_ids(w, t, l):
            if not t["visible"][e]:
                continue
            x, y, _, hh = rects[e]
            mark = batch._count
            font.draw(batch, self._text.get(e, ""), x, y,
                      color=tuple(np.asarray(l["color"][e])),
                      scale=float(l["scale"][e]))
            _clip_batch(batch, mark, scissor)


class UiInputSystem(System):
    """Single-line text input: focus via click, append/backspace editing,
    caret (UiInputSystem, reference system/ui/ 436 LoC)."""

    component = UI_INPUT

    def __init__(self) -> None:
        self._text: Dict[int, str] = {}
        self._on_submit: Dict[int, Callable[[int, str], None]] = {}

    def set_text(self, entity: int, text: str) -> None:
        self._text[entity] = text

    def text(self, entity: int) -> str:
        return self._text.get(entity, "")

    def on_submit(self, entity: int, fn: Callable[[int, str], None]) -> None:
        self._on_submit[entity] = fn

    def process_click(self, cursor: Tuple[float, float],
                      frame_size: Tuple[float, float]) -> None:
        """Focus the input under the cursor, blur the rest."""
        w = self.world
        t = w._stores.get("ui_transform")
        s = w._stores.get("ui_input")
        if t is None or s is None:
            return
        rects = resolve_rects(t, *frame_size)
        cx, cy = cursor
        for e in _component_ids(w, t, s):
            if not s["enabled"][e]:
                continue
            x, y, ww, hh = rects[e]
            s["focused"][e] = (x <= cx < x + ww and y <= cy < y + hh)
            if s["focused"][e]:
                s["cursor"][e] = len(self._text.get(e, ""))

    def process_text(self, chars: str) -> None:
        """Type characters into the focused input (InputSystem's char
        accumulation -> UiInput, input.hpp:93 Char events)."""
        w = self.world
        s = w._stores.get("ui_input")
        if s is None:
            return
        for e in _component_ids(w, s):
            if not s["focused"][e]:
                continue
            txt = self._text.get(e, "")
            cur = int(s["cursor"][e])
            for ch in chars:
                if ch == "\b":
                    if cur > 0:
                        txt = txt[:cur - 1] + txt[cur:]
                        cur -= 1
                elif ch == "\n":
                    cb = self._on_submit.get(e)
                    if cb:
                        cb(e, txt)
                elif len(txt) < int(s["max_length"][e]):
                    txt = txt[:cur] + ch + txt[cur:]
                    cur += 1
            self._text[e] = txt
            s["cursor"][e] = cur

    def emit(self, batch, font, frame_size: Tuple[float, float]) -> None:
        """Text + caret sprites for focused inputs."""
        w = self.world
        t = w._stores.get("ui_transform")
        s = w._stores.get("ui_input")
        if t is None or s is None:
            return
        rects = resolve_rects(t, *frame_size)
        scissor = _active_scissor(w, rects)
        for e in _component_ids(w, t, s):
            x, y, ww, hh = rects[e]
            mark = batch._count
            txt = self._text.get(e, "")
            font.draw(batch, txt, x + 2, y)
            if bool(s["focused"][e]):
                cx = x + 2 + font.measure(txt[: int(s["cursor"][e])])
                batch.push(Sprite(cx, y, 1.5, max(hh - 4, 8),
                                  (0, 0, 1, 1), (1, 1, 1, 1)))
            _clip_batch(batch, mark, scissor)


class UiScissorSystem(System):
    """Clip child-widget sprites to the scissor entity's rect
    (UiScissorSystem analog). The first enabled scissor clips everything
    emitted by labels/inputs; nesting is not modeled (single clip rect,
    like one scissor state per draw in the reference UI pass)."""

    component = UI_SCISSOR


class UiTriggerSystem(System):
    """Cursor-region triggers with Enter/Exit callbacks
    (UiTriggerSystem hit testing)."""

    component = UI_TRIGGER

    def __init__(self) -> None:
        self._on_enter: Dict[int, Callable[[int], None]] = {}
        self._on_exit: Dict[int, Callable[[int], None]] = {}

    def on_enter(self, entity: int, fn: Callable[[int], None]) -> None:
        self._on_enter[entity] = fn

    def on_exit(self, entity: int, fn: Callable[[int], None]) -> None:
        self._on_exit[entity] = fn

    def process(self, cursor: Tuple[float, float],
                frame_size: Tuple[float, float]) -> List[Tuple[int, str]]:
        """Hit test; fires Enter/Exit transitions. Returns events."""
        w = self.world
        t = w._stores.get("ui_transform")
        g = w._stores.get("ui_trigger")
        if t is None or g is None:
            return []
        rects = resolve_rects(t, *frame_size)
        cx, cy = cursor
        events: List[Tuple[int, str]] = []
        for e in _component_ids(w, t, g):
            if not g["enabled"][e]:
                continue
            x, y, ww, hh = rects[e]
            inside = x <= cx < x + ww and y <= cy < y + hh
            was = bool(g["inside"][e])
            g["inside"][e] = inside
            if inside and not was:
                events.append((e, "enter"))
                cb = self._on_enter.get(e)
                if cb:
                    cb(e)
            elif was and not inside:
                events.append((e, "exit"))
                cb = self._on_exit.get(e)
                if cb:
                    cb(e)
        return events


def _active_scissor(world, rects: np.ndarray) -> Optional[np.ndarray]:
    """First enabled scissor entity's rect, or None."""
    s = world._stores.get("ui_scissor")
    t = world._stores.get("ui_transform")
    if s is None or t is None:
        return None
    for e in range(world.capacity):
        if world._alive[e] and s["has"][e] and s["enabled"][e] and t["has"][e]:
            return rects[e]
    return None


def _clip_batch(batch, start: int, scissor: Optional[np.ndarray]) -> None:
    """Clip sprites [start, count) to the scissor rect in place (the
    vkCmdSetScissor analog for the host-built sprite list)."""
    if scissor is None:
        return
    sx, sy, sw, sh = scissor
    for i in range(start, batch._count):
        x, y, w, h = batch._rects[i]
        x0, y0 = max(x, sx), max(y, sy)
        x1, y1 = min(x + w, sx + sw), min(y + h, sy + sh)
        if x1 <= x0 or y1 <= y0:
            batch._rects[i] = (0, 0, 0, 0)      # fully clipped
            continue
        # adjust the atlas region proportionally to the clipped quad
        rx, ry, rw, rh = batch._regions[i]
        if w > 0 and h > 0:
            u0 = (x0 - x) / w
            v0 = (y0 - y) / h
            u1 = (x1 - x) / w
            v1 = (y1 - y) / h
            batch._regions[i] = (rx + u0 * rw, ry + v0 * rh,
                                 max((u1 - u0) * rw, 1e-3),
                                 max((v1 - v0) * rh, 1e-3))
        batch._rects[i] = (x0, y0, x1 - x0, y1 - y0)
