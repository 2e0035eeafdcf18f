"""The port's UI widget systems against the JAX package's on the CPU.

Both packages build the same widgets (anchored transforms, labels, two
buttons, a checkbox, a trigger, an input box, a scissor), drive them with
the same cursor, click and text sequence, and emit labels and inputs
through their FontAtlas into a SpriteBatch. Rects, widget stores, the
clicked and entered/exited lists, callbacks, input text and every emitted
sprite (rect, atlas region, colour) must agree in every bit. The glyph
file the engine frame's HUD uses (`text.DEFAULT_GLYPHS`) must rebuild the
PIL font's atlas and layout exactly. All host-side: serial time ~5 s.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import numpy as np
import pytest

from garden_tpu.core import ecs as jecs
from garden_tpu.render import sprites as jsprites
from garden_tpu.render import text as jtext
from garden_tpu.systems import ui as jui
from garden_tpu_torch.core import ecs as tecs
from garden_tpu_torch.render import sprites as tsprites
from garden_tpu_torch.render import text as ttext
from garden_tpu_torch.systems import ui as tui

FRAME = (320.0, 200.0)
SYSTEMS = ("UiTransformSystem", "UiButtonSystem", "UiCheckboxSystem", "UiLabelSystem",
           "UiInputSystem", "UiScissorSystem", "UiTriggerSystem")


def _world(ecs, ui, with_scissor):
    """The widget world -> (world, {name: entity}, callback log)."""
    w = ecs.World(capacity=16) if ecs is jecs else ecs.World(capacity=16, device="cpu")
    for name in SYSTEMS:
        w.create_system(getattr(ui, name)())
    log = []
    ids = {}

    def widget(name, pos, size, anchor, *components):
        e = w.create_entity()
        w.add_component(e, "ui_transform", position=pos, size=size, anchor=anchor)
        for c in components:
            w.add_component(e, c)
        ids[name] = e
        return e

    widget("title", (4.0, 2.0), (120.0, 16.0), ui.ANCHOR_TOP_LEFT, "ui_label")
    widget("score", (-4.0, 2.0), (80.0, 16.0), ui.ANCHOR_TOP_RIGHT, "ui_label")
    widget("play", (0.0, 0.0), (60.0, 20.0), ui.ANCHOR_CENTER, "ui_button", "ui_label")
    widget("quit", (0.0, -30.0), (60.0, 20.0), ui.ANCHOR_BOTTOM_RIGHT, "ui_button")
    widget("vsync", (8.0, -30.0), (70.0, 20.0), ui.ANCHOR_BOTTOM_LEFT, "ui_button",
           "ui_checkbox", "ui_label")
    widget("zone", (10.0, 40.0), (50.0, 50.0), ui.ANCHOR_TOP_LEFT, "ui_trigger")
    widget("name", (8.0, -4.0), (150.0, 20.0), ui.ANCHOR_BOTTOM_LEFT, "ui_input")
    if with_scissor:
        widget("clip", (0.0, 0.0), (200.0, 190.0), ui.ANCHOR_TOP_LEFT, "ui_scissor")
    labels, inputs = w.systems["UiLabelSystem"], w.systems["UiInputSystem"]
    labels.set_text(ids["title"], "Garden: AVAWAY")
    labels.set_text(ids["score"], "Score 1234")
    labels.set_text(ids["play"], "Play")
    labels.set_text(ids["vsync"], "[ ] VSync")
    w.set_component(ids["score"], "ui_label", color=(1.0, 0.5, 0.25, 0.9), scale=1.5)
    inputs.set_text(ids["name"], "ab")
    inputs.on_submit(ids["name"], lambda e, s: log.append(("submit", int(e), s)))
    w.systems["UiButtonSystem"].on_click(ids["play"], lambda e: log.append(("click", int(e))))
    w.systems["UiTriggerSystem"].on_enter(ids["zone"], lambda e: log.append(("enter", int(e))))
    w.systems["UiTriggerSystem"].on_exit(ids["zone"], lambda e: log.append(("exit", int(e))))
    return w, ids, log


def _drive(w, ids, log, sprites, text):
    """The same input sequence on either package -> a record of what the
    systems returned and emitted."""
    buttons, checks = w.systems["UiButtonSystem"], w._stores["ui_checkbox"]
    triggers, inputs = w.systems["UiTriggerSystem"], w.systems["UiInputSystem"]
    rects = tui.resolve_rects if sprites is tsprites else jui.resolve_rects
    rec = [rects(w._stores["ui_transform"], *FRAME).tolist()]
    play = rects(w._stores["ui_transform"], *FRAME)[ids["play"]]
    vsync = rects(w._stores["ui_transform"], *FRAME)[ids["vsync"]]
    name = rects(w._stores["ui_transform"], *FRAME)[ids["name"]]
    inside = lambda r: (float(r[0]) + 3.0, float(r[1]) + 3.0)
    for cursor, down in ((inside(play), True), (inside(play), False), (inside(vsync), True),
                         (inside(vsync), False), ((30.0, 60.0), False), ((300.0, 5.0), True)):
        rec.append((buttons.process(cursor, down, FRAME), triggers.process(cursor, FRAME),
                    [bool(checks["checked"][e]) for e in ids.values()]))
    inputs.process_click(inside(name), FRAME)
    inputs.process_text("cd\b\bxyz\n")
    rec.append((inputs.text(ids["name"]), int(w._stores["ui_input"]["cursor"][ids["name"]]),
                list(log)))
    atlas = sprites.TextureAtlas(256)
    font = text.FontAtlas(atlas)
    batch = sprites.SpriteBatch(atlas, capacity=128)
    w.systems["UiLabelSystem"].emit(batch, font, FRAME)
    w.systems["UiInputSystem"].emit(batch, font, FRAME)
    rec.append(batch._count)
    return rec, batch, atlas


@pytest.mark.parametrize("with_scissor", [False, True])
def test_widgets_match(with_scissor):
    jw, jids, jlog = _world(jecs, jui, with_scissor)
    tw, tids, tlog = _world(tecs, tui, with_scissor)
    assert jids == tids
    jrec, jb, ja = _drive(jw, jids, jlog, jsprites, jtext)
    trec, tb, ta = _drive(tw, tids, tlog, tsprites, ttext)
    assert jrec == trec
    for k in ("_rects", "_regions", "_colors"):
        np.testing.assert_array_equal(getattr(jb, k), getattr(tb, k), err_msg=k)
    np.testing.assert_array_equal(ja.data, ta.data)
    for name in jw._stores:
        for k in jw._stores[name]:
            np.testing.assert_array_equal(jw._stores[name][k], tw._stores[name][k],
                                          err_msg=f"{name}.{k}")
    # the sequence exercised what it is for: a click, a toggle, an enter and
    # exit, a submit, the caret, and (with the scissor) clipped sprites
    assert ("click", tids["play"]) in tlog and ("enter", tids["zone"]) in tlog
    assert ("exit", tids["zone"]) in tlog and ("submit", tids["name"], "abxyz") in tlog
    assert tw._stores["ui_checkbox"]["checked"][tids["vsync"]]
    clipped = (tb._rects[:tb._count, 2] == 0).sum()
    assert (clipped > 0) == with_scissor


def test_glyph_file_rebuilds_the_font():
    pil = ttext.FontAtlas(tsprites.TextureAtlas(256))
    filed = ttext.FontAtlas.load_glyphs(tsprites.TextureAtlas(256))
    np.testing.assert_array_equal(pil.atlas.data, filed.atlas.data)
    assert pil.glyphs == filed.glyphs and pil.kerning == filed.kerning
    assert (pil.size, pil.ascent, pil.descent) == (filed.size, filed.ascent, filed.descent)
    batches = []
    for font in (pil, filed):
        b = tsprites.SpriteBatch(font.atlas, capacity=64)
        font.draw(b, "Hello, World! [x] 0.75", 3.0, 7.0, color=(1, 0, 0, 1), scale=1.5)
        batches.append(b)
    np.testing.assert_array_equal(batches[0]._rects, batches[1]._rects)
    np.testing.assert_array_equal(batches[0]._regions, batches[1]._regions)
    assert pil.measure("AVAV x") == filed.measure("AVAV x")
