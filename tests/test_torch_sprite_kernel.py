"""The HUD composite kernel (`csrc/sprites.cu`) and the dispatch in
`render/sprites.py` that chooses it, and the metric that reads the
dispatch (`benchmark/metrics/ui_kernel_pct.engine.py`).

On the CPU: `composite_sprites` takes `composite_sprites_plain`, which gives
the bits of the benchmark's frozen plain loop
(`benchmark/reference/render/sprites.py`) on hand-made sprites, the feature
frame's HUD, -0.0 and NaN pixels and non-finite texels and colours, and
keeps the public function's signature; each call charges `ui_calls` 1,
`ui_kernel_calls` 0 and `ui_pixels` a full frame a sprite to its span; the
kernel's cull on the host (`sprites.tile_pairs`) keeps a sprite in a tile
exactly when the loop's rect test passes at one of the tile's pixels, or
when its colour could make a texel's product leave the finite floats; the
atlas's bound is read once a version of the atlas; the CUDA wrapper refuses
CPU tensors and wrong dtypes (no fallback); `cuda_build` declares the
kernel; `ui_kernel_pct.engine` reads 100, a share, 0 and None from
hand-made span records.

On a card (`gpu`; run with
`python -m pytest --noconftest -m gpu tests/test_torch_sprite_kernel.py -q`):
the kernel against the plain loop on the same card, in every bit: the
engine cell's 82-sprite HUD over its own 1920x1080 LDR frame, the feature
frame's HUD at 1920x1080, and the hand-made cases (fractional, off-frame
and partly off-frame rects, a width below 1e-6, overlaps whose order
matters, 600 sprites over three of the kernel's passes, a count of 0 and a
count at capacity, an image seeded with -0.0 and NaN, inf and NaN texels
and colours, a colour whose product with a texel overflows). One call is
one launch, with no host synchronization; `ui_pixels` is the host cull's
count.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import inspect
import json
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import harness, spans
from benchmark.entries import engine_frame
from benchmark.reference.render import sprites as ref_sprites
from garden_tpu_torch import cuda_build, entry
from garden_tpu_torch.render import sprites
from garden_tpu_torch.utils import profiler

CELL = "engine_frame_1080p.engine"
SEED = 2 ** 31 + 1234
W, H = 100, 37          # the hand-made frame: partial tiles on both edges


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _hand_batch(capacity=16, fill=False):
    """(atlas, batch): the hand-made sprites over a 64-texel atlas, each a
    case of the kernel's cull; with `fill`, white squares up to capacity."""
    rng = np.random.default_rng(3)
    atlas = sprites.TextureAtlas(64)
    tex = atlas.add(rng.uniform(0, 1, (12, 10, 4)).astype(np.float32))
    glyph = atlas.add(rng.uniform(0, 1, (7, 5, 4)).astype(np.float32))
    batch = sprites.SpriteBatch(atlas, capacity)

    def push(x, y, w, h, region=tex, color=(1.0, 1.0, 1.0, 1.0)):
        batch.push(sprites.Sprite(x, y, w, h, region, color))
    push(3.25, 2.5, 17.75, 9.5, color=(0.9, 0.5, 0.3, 0.8))       # fractional
    push(-20.0, -4.0, 30.5, 12.25)                                 # partly off, top left
    push(W - 6.5, H - 3.0, 40.0, 40.0, glyph)                      # partly off, bottom right
    push(W + 5.0, 10.0, 8.0, 8.0)                                  # off the right
    push(10.0, -30.0, 8.0, 8.0)                                    # off the top
    push(40.0, 20.0, 1e-7, 5.0)                                    # width below 1e-6
    push(48.0, 16.0, 0.0, 0.0)                                     # empty
    push(12.0, 6.0, 20.0, 10.0, glyph, color=(0.2, 0.9, 0.1, 0.6))  # overlaps: order
    push(14.0, 7.0, 20.0, 10.0, color=(0.8, 0.1, 0.7, 0.7))
    push(31.0, 7.0, 1.0, 1.0, glyph)                               # the last column of a tile
    push(64.0, 24.0, 0.5, 0.5)                                     # one pixel centre
    push(0.0, 0.0, float(W), float(H), atlas.white, color=(0.1, 0.2, 0.3, 0.05))
    while fill and batch.count < capacity:
        i = batch.count
        push(float(i * 7 % W), float(i * 5 % H), 3.0, 2.0, atlas.white, (0.5, 0.4, 0.3, 0.5))
    return atlas, batch


def _many_batch(n=600):
    """(atlas, batch): n seeded sprites over the hand-made frame, more than
    two of the kernel's passes of 256."""
    rng = np.random.default_rng(11)
    atlas = sprites.TextureAtlas(64)
    tex = atlas.add(rng.uniform(0, 1, (16, 16, 4)).astype(np.float32))
    batch = sprites.SpriteBatch(atlas, n)
    for _ in range(n):
        x, y = rng.uniform(-10, W + 5), rng.uniform(-10, H + 5)
        w, h = rng.uniform(0, 12, 2)
        batch.push(sprites.Sprite(x, y, w, h, tex, tuple(rng.uniform(0, 1, 4))))
    return atlas, batch


def _image(h, w, device, seed=5):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(0, 1, (h, w, 3)), dtype=torch.float32, device=device)


def _variant(name, device):
    """(image, atlas, sprites) of a hand-made case on `device`."""
    capacity = {"count_capacity": 16}.get(name, 24)
    atlas, batch = (_many_batch() if name == "many"
                    else _hand_batch(capacity, fill=name == "count_capacity"))
    img = _image(H, W, device)
    if name == "negative_zero":
        rng = np.random.default_rng(7)
        flat = img.view(-1)
        flat[torch.as_tensor(rng.choice(flat.numel(), 400, replace=False))] = -0.0
        flat[torch.as_tensor(rng.choice(flat.numel(), 40, replace=False))] = float("nan")
    data = atlas.data
    if name in ("atlas_inf", "atlas_nan"):
        data = data.copy()
        # a texel of the white square, which every sprite samples above and
        # left of its rect (its region's clamped corner), and one inside
        data[0, 0, 1] = data[3, 4, 1] = np.inf if name == "atlas_inf" else np.nan
    if name == "color_overflow":
        data = data.copy()
        data[:12, :10] *= 1e10
    arrays = batch.device_arrays(device)
    if name in ("color_inf", "color_nan", "color_overflow"):
        value = {"color_inf": float("-inf"), "color_nan": float("nan"),
                 "color_overflow": 1e30}[name]
        arrays["colors"][3, 0] = value          # off the frame: every tile keeps it
        arrays["colors"][5, 3] = value
    if name == "count_zero":
        arrays["count"] = 0
    if name == "negative_zero":   # no full-frame sprite: the -0.0 outside every rect stays
        arrays["count"] -= 1      # for a kernel that skips the dropped sprites
    assert name != "count_capacity" or arrays["count"] == batch.capacity
    return img, torch.as_tensor(data, device=device), arrays


VARIANTS = ["hand", "many", "count_zero", "count_capacity", "negative_zero", "atlas_inf",
            "atlas_nan", "color_inf", "color_nan", "color_overflow"]


def _spans(fn):
    """fn() inside a recorded root step -> {span name: counters}."""
    first = profiler.RECORDER.next_step
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.span("step"):
            fn()
    return {s["name"]: s["counters"] for s in profiler.recorded() if s["step"] >= first}


# -- the CPU: the plain path ---------------------------------------------------

@pytest.mark.parametrize("name", VARIANTS + ["feature_hud"])
def test_cpu_tensors_give_the_plain_reference_bits(name):
    if name == "feature_hud":
        atlas, batch = entry.hud(256, 128, seed=1)
        img, at, arrays = _image(128, 256, "cpu"), atlas.device("cpu"), batch.device_arrays("cpu")
    else:
        img, at, arrays = _variant(name, "cpu")
    launches = dict(cuda_build.launches)
    got = sprites.composite_sprites(img, at, arrays)
    want = ref_sprites.composite_sprites(img, at, arrays)
    assert _same_bits(got, want)
    assert _same_bits(sprites.composite_sprites_plain(img, at, arrays), want)
    assert cuda_build.launches == launches
    if name == "count_zero":
        assert got is img
    elif name == "negative_zero":   # the blend of alpha 0 turns -0.0 into +0.0
        neg = (img == 0) & torch.signbit(img)
        assert int(neg.sum()) > 300 and not bool(((got == 0) & torch.signbit(got)).any())
    else:
        assert (got != img).any()


def test_plain_version_keeps_the_signature():
    sig = inspect.signature(sprites.composite_sprites)
    assert inspect.signature(sprites.composite_sprites_plain) == sig
    assert inspect.signature(sprites.composite_sprites_cuda) == sig
    assert inspect.signature(ref_sprites.composite_sprites) == sig


def test_cpu_calls_are_charged_as_plain_calls():
    img, at, arrays = _variant("hand", "cpu")
    n = arrays["count"]

    def calls():
        with profiler.span("ui"):
            sprites.composite_sprites(img, at, arrays)
        with profiler.span("none"):
            sprites.composite_sprites(img, at, dict(arrays, count=0))
    by = _spans(calls)
    ui = by["ui"]
    assert (ui["ui_calls"], ui["ui_kernel_calls"]) == (1, 0)
    assert ui["ui_pixels"] == n * H * W                  # a full frame a sprite
    assert ui["ui_pixels_covered"] == int(sprites.covered_pixels(arrays["rects"][:n], W, H))
    assert (by["none"]["ui_calls"], by["none"]["ui_pixels"]) == (1, 0)
    assert "ui_calls" not in by["step"]


def _inside_any(rects, width, height):
    """(tiles_y, tiles_x, n): the loop's own rect test at some pixel of
    each tile, by brute force over the frame."""
    xs = torch.arange(width, dtype=torch.float32)[None, None, :]
    ys = torch.arange(height, dtype=torch.float32)[None, :, None]
    rx, ry, rw, rh = (rects[:, k, None, None] for k in range(4))
    inside = (xs >= rx) & (xs < rx + rw) & (ys >= ry) & (ys < ry + rh)     # (n, H, W)
    ty, tx = -(-height // sprites.TILE_H), -(-width // sprites.TILE_W)
    pad = torch.zeros(rects.shape[0], ty * sprites.TILE_H, tx * sprites.TILE_W, dtype=torch.bool)
    pad[:, :height, :width] = inside
    tiles = pad.view(-1, ty, sprites.TILE_H, tx, sprites.TILE_W)
    return tiles.any(4).any(2).permute(1, 2, 0)


def _tile_area(width, height):
    cols = torch.clamp(width - torch.arange(0, width, sprites.TILE_W), max=sprites.TILE_W)
    rows = torch.clamp(height - torch.arange(0, height, sprites.TILE_H), max=sprites.TILE_H)
    return rows[:, None] * cols[None, :]


@pytest.mark.parametrize("width,height", [(W, H), (64, 16), (33, 9)])
def test_the_host_cull_is_the_loops_rect_test_per_tile(width, height):
    """Edges exactly on a tile's first and last columns, just past them, at
    a pixel centre, NaN and infinite rects, negative and huge sizes; the
    colours that force a sprite into every tile."""
    rng = np.random.default_rng(2)
    ends = [0.0, 31.0, 31.5, 32.0, 32.000004, 31.999998, 7.0, 8.0, 8.5, -0.5, -1e-7,
            float(width), width - 1e-5, float(height), 1e30, -1e30]
    rows = []
    for _ in range(300):
        x, y = rng.choice(ends), rng.choice(ends)
        rows.append((x, y, rng.choice(ends + [1.0, 0.5, 1e-7, -2.0]) if rng.random() < 0.6
                     else rng.uniform(-3, 40), rng.choice([1.0, 0.5, 2.0, 9.0, -1.0, 0.0])))
    rows += [(float("nan"), 1.0, 4.0, 4.0), (1.0, 1.0, float("nan"), 4.0),
             (float("-inf"), 0.0, float("inf"), 4.0), (float("-inf"), 0.0, 40.0, 4.0),
             (2.0, 2.0, float("inf"), float("inf")), (5.0, 3.0, 3.0, 3.0)]
    rects = torch.tensor(rows, dtype=torch.float32)
    colors = torch.full((rects.shape[0], 4), 0.5)
    want = _inside_any(rects, width, height)
    assert want.any() and not want.all()
    area = _tile_area(width, height)
    got = sprites.tile_pairs(rects, colors, 1.0, width, height)
    assert torch.equal(got, want.sum(-1) * area)
    colors[-1] = torch.tensor([0.5, float("inf"), 0.5, 0.5])
    colors[-2, 3] = float("nan")
    colors[-3, 0] = 1e30
    forced = torch.zeros(rects.shape[0], dtype=torch.bool)
    forced[-2:] = True
    for amax, forced_too in ((1.0, 0), (1e10, 1)):
        f = forced.clone()
        f[-3] = bool(forced_too)
        assert torch.equal(sprites.tile_pairs(rects, colors, amax, width, height),
                           (want | f).sum(-1) * area)
    # an atlas with a non-finite texel keeps every sprite everywhere
    full = sprites.tile_pairs(rects, colors, float("inf"), width, height)
    assert torch.equal(full, rects.shape[0] * area)


def test_atlas_max_is_read_once_a_version():
    atlas = torch.tensor(np.random.default_rng(1).uniform(-2, 1, (8, 8, 4)), dtype=torch.float32)
    with mock.patch.object(torch, "isfinite", wraps=torch.isfinite) as spy:
        assert sprites.atlas_max(atlas) == float(atlas.abs().max())
        assert sprites.atlas_max(atlas) == float(atlas.abs().max())
        assert spy.call_count == 1
        atlas[1, 2, 3] = 7.5
        assert sprites.atlas_max(atlas) == 7.5 and spy.call_count == 2
        atlas[0, 0, 0] = float("nan")
        assert sprites.atlas_max(atlas) == float("inf")
        spy.reset_mock()
    key = id(atlas)
    del atlas
    assert key not in sprites._atlas_max


def test_sprite_kernel_is_declared():
    source, _ = cuda_build.KERNELS["composite_sprites"]
    assert source == "sprites" and "sprites" in cuda_build.SOURCES
    assert "composite_sprites" in cuda_build.launches


def test_cuda_wrapper_refuses_cpu_and_wrong_dtypes():
    img, at, arrays = _variant("hand", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        sprites.composite_sprites_cuda(img, at, arrays)
    with pytest.raises(ValueError, match="float32"):
        sprites.composite_sprites_cuda(img.double(), at, arrays)
    with pytest.raises(ValueError, match="float32"):
        sprites.composite_sprites_cuda(img[..., :2], at, arrays)


def test_other_devices_have_no_path():
    img, at, arrays = _variant("hand", "cpu")
    with pytest.raises(ValueError, match="no path"):
        sprites.composite_sprites(img.to("meta"), at, arrays)


# -- the metric: ui_kernel_pct.engine ------------------------------------------

METRIC = "ui_kernel_pct.engine"
RANGES = [(0, 1000, "bench.step"), (10, 990, "step"), (600, 980, "render"),
          (900, 970, "ui")]


def _span(i, name, parent, **counters):
    start, end = next((r[0], r[1]) for r in RANGES if r[2] == name)
    return {"id": i, "name": name, "start_ns": start - 1, "end_ns": end + 1,
            "parent": parent, "step": 3, "device": 0, "attrs": {},
            "counters": dict({"syncs": 0}, **counters)}


def _run():
    return harness.Run(prof=([(0, 910, 930, "composite_sprites_kernel", 1)], [(910, 1)],
                             RANGES),
                       devices=[torch.device("cuda", 0)], traffic={"trace_steps": 1},
                       worlds=1, config=harness.load_cell(CELL)["config"],
                       peaks=json.loads((harness.BENCH / "peaks.json").read_text()),
                       kind="NVIDIA H100 80GB HBM3", power_limit_w=700.0)


def _read(monkeypatch, ui, render=None):
    recorded = [_span(0, "step", None), _span(1, "render", 0, **(render or {})),
                _span(2, "ui", 1, **ui)]
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    return harness.reader(METRIC)(_run())


@pytest.mark.parametrize("calls,kernel,want", [(1, 1, 100.0), (1, 0, 0.0)])
def test_metric_reads_the_kernels_share(monkeypatch, calls, kernel, want):
    got = _read(monkeypatch, {"ui_calls": calls, "ui_kernel_calls": kernel})
    assert got["value"] == pytest.approx(want)
    assert (got["ui_kernel_calls"], got["ui_calls"]) == (float(kernel), float(calls))
    assert got["by_span"] == {"ui": {"ui_kernel_calls": float(kernel), "ui_calls": float(calls)}}


def test_metric_counts_plain_calls_against_it(monkeypatch):
    got = _read(monkeypatch, {"ui_calls": 3, "ui_kernel_calls": 3},
                render={"ui_calls": 1, "ui_kernel_calls": 0})
    assert got["value"] == pytest.approx(75.0)
    assert set(got["by_span"]) == {"render", "ui"}


@pytest.mark.parametrize("recorded", ["bare", "none", "untraced"])
def test_metric_reads_none_without_the_counters(monkeypatch, recorded):
    if recorded == "bare":   # the parent's program: the span and its pixels, not the calls
        assert _read(monkeypatch, {"ui_pixels": 82 * 2073600, "ui_pixels_covered": 2660}) is None
    elif recorded == "none":
        monkeypatch.setattr(spans, "recorded", lambda: None)
        assert harness.reader(METRIC)(_run()) is None
    else:
        monkeypatch.setattr(spans, "recorded", lambda: [_span(0, "step", None, ui_calls=1)])
        run = _run()
        run.prof = None
        assert harness.reader(METRIC)(run) is None


def test_metric_reports_in_the_engine_cell():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    got = [m for m in spec["per_layer"] if m["name"] == METRIC]
    assert len(got) == 1 and got[0]["workloads"] == [CELL]
    assert got[0]["moves"] == "step_p95_ms" and got[0]["layer"] == "render"
    assert got[0]["source"] == "program_counter" and spec["per_layer"][-1] == got[0]
    assert METRIC in {m["name"] for m in harness.metrics_of(spec, CELL, "per_layer")}


# -- the card: the kernel against the plain loop -------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _check_card(img, at, arrays):
    """The kernel's output against the plain loop's on the card, in every
    bit, and the pairs it counts against the host cull -> (pairs, the
    frame's pixels times the count)."""
    h, w = img.shape[:2]
    n = int(arrays["count"])
    want = sprites.composite_sprites_plain(img, at, arrays)
    by = _spans(lambda: sprites.composite_sprites(img, at, arrays))
    got = sprites.composite_sprites(img, at, arrays)
    assert _same_bits(got, want)
    pairs = int(by["step"]["ui_pixels"])
    host = int(sprites.tile_pairs(arrays["rects"][:n], arrays["colors"][:n],
                                  sprites.atlas_max(at), w, h).sum())
    assert pairs == host and (by["step"]["ui_calls"], by["step"]["ui_kernel_calls"]) == (1, 1)
    return pairs, n * h * w


@pytest.mark.gpu
def test_kernel_matches_the_plain_loop_on_the_engine_hud(cuda):
    """The engine cell's HUD over the LDR frame its first step composites."""
    cell = harness.load_cell(CELL)
    run = engine_frame.build(cell["config"], cell["traffic"], SEED, [cuda])
    seen = []
    with mock.patch.object(sprites, "composite_sprites", wraps=sprites.composite_sprites) as spy:
        run.fn(run.state)
        seen = spy.call_args_list[-1].args
    ldr, at, arrays = seen
    assert tuple(ldr.shape) == (1080, 1920, 3) and arrays["count"] == 82
    neg = int(((ldr == 0) & torch.signbit(ldr)).sum())
    pairs, full = _check_card(ldr, at, arrays)
    print(f"engine HUD: 82 sprites over 1920x1080, -0.0 channels in the LDR frame {neg}, "
          f"pairs tested {pairs} of {full} ({100.0 * pairs / full:.4f}%)")
    assert 0 < pairs < 0.05 * full


@pytest.mark.gpu
def test_kernel_matches_the_plain_loop_on_the_feature_hud(cuda):
    atlas, batch = entry.hud(1920, 1080, seed=4)
    img = _image(1080, 1920, cuda)
    pairs, full = _check_card(img, atlas.device(cuda), batch.device_arrays(cuda))
    assert batch.count == 48 and 0 < pairs < full


@pytest.mark.gpu
@pytest.mark.parametrize("name", VARIANTS)
def test_kernel_matches_the_plain_loop_on_hand_made_cases(cuda, name):
    img, at, arrays = _variant(name, cuda)
    if name == "count_zero":
        assert sprites.composite_sprites(img, at, arrays) is img
        return
    pairs, full = _check_card(img, at, arrays)
    if name in ("atlas_inf", "atlas_nan"):
        assert pairs == full
    else:
        assert pairs < full


@pytest.mark.gpu
def test_one_call_is_one_launch_and_no_sync(cuda):
    img, at, arrays = _variant("hand", cuda)
    sprites.composite_sprites(img, at, arrays)      # builds the library, reads the atlas
    torch.cuda.synchronize()
    before = cuda_build.launches["composite_sprites"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        sprites.composite_sprites(img, at, arrays)
        sprites.composite_sprites(img, at, dict(arrays, count=3))
        sprites.composite_sprites(img, at, dict(arrays, count=0))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_build.launches["composite_sprites"] == before + 2


@pytest.mark.gpu
def test_kernel_calls_are_charged(cuda):
    img, at, arrays = _variant("hand", cuda)
    sprites.composite_sprites(img, at, arrays)
    torch.cuda.synchronize()

    def calls():
        with profiler.span("ui"):
            sprites.composite_sprites(img, at, arrays)
    ui = _spans(calls)["ui"]
    assert (ui["ui_calls"], ui["ui_kernel_calls"], ui["syncs"]) == (1, 1, 0)
    n = arrays["count"]
    assert int(ui["ui_pixels_covered"]) == int(sprites.covered_pixels(arrays["rects"][:n], W, H))
