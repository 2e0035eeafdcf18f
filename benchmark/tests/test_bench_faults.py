"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a small size: the program, the window, the kept steps and the
check against the reference, with the committed limits. The faults each
cell can have: a step that returns its state unchanged; half of a batch
left out (the worlds cells); an answer altered where it is produced (a
body's position; in the frame cell, a pixel); in the frame cell, a camera
set for another scene. The cells exchange nothing
between cards, so no exchange can be left out.
"""

import pytest
import torch
from torch.utils._pytree import tree_map

from benchmark import harness
from benchmark.tests.conftest import cells, tiny

# (cell, devices): the worlds cells also as two shards, one per device
WORLD_CELLS = [(c, d) for c in cells("world_batch") for d in (1, 2)]
CELLS = [("flagship_1080p.play", 1), ("flagship_1080p.headless", 1)] + WORLD_CELLS


def run(cell, devices=1):
    loaded = tiny(harness.load_cell(cell), worlds=2 * devices, devices=devices)
    seconds = 3.0 if cell == "flagship_1080p.play" else 0.5
    return harness.run_cell(cell, 2 ** 31 + 77, seconds, False, ["cpu"] * devices, 0.0,
                            loaded)


@pytest.mark.parametrize("cell,devices", CELLS)
def test_sound_run_is_correct(cell, devices):
    res = run(cell, devices)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


@pytest.mark.parametrize("cell,devices", CELLS)
def test_state_returned_unchanged(cell, devices, monkeypatch):
    from garden_tpu_torch.physics import world
    monkeypatch.setattr(world, "step", lambda state, *a, **k: state)
    res = run(cell, devices)
    assert not res["correct"]
    assert res["checks"]["time_s"]["value"] > res["checks"]["time_s"]["limit"]


@pytest.mark.parametrize("cell,devices", WORLD_CELLS)
def test_half_the_batch_left_out(cell, devices, monkeypatch):
    from garden_tpu_torch.parallel.worlds import WorldBatch
    full = WorldBatch.step

    def half(self, batched):
        out = full(self, batched)
        keep = self.per // 2
        return [tree_map(lambda new, old: torch.cat([new[:keep], old[keep:]]), o, b)
                for o, b in zip(out, batched)]
    monkeypatch.setattr(WorldBatch, "step", half)
    assert not run(cell, devices)["correct"]


@pytest.mark.parametrize("cell,devices", CELLS)
def test_body_moved_where_the_step_produces_it(cell, devices, monkeypatch):
    from garden_tpu_torch.physics import world
    step = world.step

    def moved(state, *a, **k):
        out = step(state, *a, **k)
        pos = out["bodies"]["pos"].clone()
        pos[1, 0] += 0.01
        return dict(out, bodies=dict(out["bodies"], pos=pos))
    monkeypatch.setattr(world, "step", moved)
    res = run(cell, devices)
    assert not res["correct"]
    assert res["checks"]["pos_m"]["value"] > res["checks"]["pos_m"]["limit"]


def test_pixel_altered_where_the_frame_is_produced(monkeypatch):
    from garden_tpu_torch.render.deferred import DeferredRenderer
    render = DeferredRenderer.render

    def altered(self, *a, **k):
        out = render(self, *a, **k)
        img = out["image"].clone()
        img[5, 7] = (img[5, 7].int() + 40).clamp(0, 255).to(img.dtype)
        return dict(out, image=img)
    monkeypatch.setattr(DeferredRenderer, "render", altered)
    res = run("flagship_1080p.play")
    assert not res["correct"]
    assert res["checks"]["image_levels"]["value"] > res["checks"]["image_levels"]["limit"]


def test_camera_of_another_scene(monkeypatch):
    from garden_tpu_torch import entry
    camera = entry._flagship_camera
    monkeypatch.setattr(entry, "_flagship_camera",
                        lambda side, *a, **k: camera(side + 3, *a, **k))
    res = run("flagship_1080p.play")
    assert not res["correct"]
    assert res["checks"]["start_leaves"]["value"] > res["checks"]["start_leaves"]["limit"]
