"""2D sprites and UI quads from one texture atlas.

Port of `garden_tpu.render.sprites`: a host-side shelf-packed RGBA atlas
(`TextureAtlas`), a fixed-capacity sprite list baked to device tensors
(`SpriteBatch`, with nine-slice panels), and `composite_sprites`, which
blends the sprites over an LDR image in push order, each sampling its
atlas region at the nearest texel.

On CUDA tensors `composite_sprites` launches the hand-written kernel of
`csrc/sprites.cu` (a block a TILE_H x TILE_W tile of the frame, a thread a
pixel, the sprites culled against the tile; `tile_pairs` is its cull on the
host); on CPU tensors it takes `composite_sprites_plain`, a full-frame pass
a sprite. Both give the same bits. While a profiler records, each call
charges the open span with `ui_calls` 1 and `ui_kernel_calls` 1 when it
took the kernel (0 on the CPU).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Tuple

import numpy as np
import torch

from garden_tpu_torch.cuda_build import check, kept_ptr, launch, on_device, ptr
from garden_tpu_torch.utils import profiler

Tensor = torch.Tensor


class TextureAtlas:
    """Host-side packed RGBA atlas (shelf packing)."""

    def __init__(self, size: int = 512):
        self.size = size
        self.data = np.zeros((size, size, 4), np.float32)
        self._shelf_y = 0
        self._shelf_x = 0
        self._shelf_h = 0
        # a solid white 2x2 region for untextured sprites
        self.white = self.add(np.ones((2, 2, 4), np.float32))

    def add(self, image: np.ndarray) -> Tuple[int, int, int, int]:
        """Pack an (h, w), (h, w, 3) or (h, w, 4) float image -> its (x, y,
        w, h) region."""
        if image.ndim == 2:
            image = np.stack([image] * 3 + [np.ones_like(image)], -1)
        if image.shape[-1] == 3:
            image = np.concatenate([image, np.ones(image.shape[:2] + (1,), image.dtype)],
                                   -1)
        h, w = image.shape[:2]
        if self._shelf_x + w > self.size:
            self._shelf_y += self._shelf_h
            self._shelf_x = 0
            self._shelf_h = 0
        if self._shelf_y + h > self.size:
            raise RuntimeError("atlas full")
        x, y = self._shelf_x, self._shelf_y
        self.data[y:y + h, x:x + w] = image
        self._shelf_x += w
        self._shelf_h = max(self._shelf_h, h)
        return (x, y, w, h)

    def device(self, device) -> Tensor:
        return torch.as_tensor(self.data, device=device)


@dataclasses.dataclass
class Sprite:
    """One screen-space quad (pixels, y down)."""

    x: float
    y: float
    w: float
    h: float
    region: Tuple[int, int, int, int]       # atlas rect
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


class SpriteBatch:
    """Fixed-capacity sprite list, baked to device tensors per frame."""

    def __init__(self, atlas: TextureAtlas, capacity: int = 256):
        self.atlas = atlas
        self.capacity = capacity
        self.clear()

    def clear(self) -> None:
        self._rects = np.zeros((self.capacity, 4), np.float32)
        self._regions = np.zeros((self.capacity, 4), np.float32)
        self._colors = np.zeros((self.capacity, 4), np.float32)
        self._count = 0

    @property
    def count(self) -> int:
        return self._count

    def push(self, sprite: Sprite) -> None:
        """Append a sprite; over capacity it is dropped."""
        if self._count >= self.capacity:
            return
        i = self._count
        self._count += 1
        self._rects[i] = (sprite.x, sprite.y, sprite.w, sprite.h)
        self._regions[i] = sprite.region
        self._colors[i] = sprite.color

    def push_nine_slice(self, x, y, w, h, region, border: float,
                        color=(1, 1, 1, 1)) -> None:
        """A 3x3 panel: corners `border` pixels square, edges and centre
        stretched; the region's corners are a third of its shorter side."""
        rx, ry, rw, rh = region
        b = border
        rb = min(rw, rh) // 3
        xs = [(x, b), (x + b, w - 2 * b), (x + w - b, b)]
        ys = [(y, b), (y + b, h - 2 * b), (y + h - b, b)]
        us = [(rx, rb), (rx + rb, rw - 2 * rb), (rx + rw - rb, rb)]
        vs = [(ry, rb), (ry + rb, rh - 2 * rb), (ry + rh - rb, rb)]
        for iy in range(3):
            for ix in range(3):
                self.push(Sprite(xs[ix][0], ys[iy][0], xs[ix][1], ys[iy][1],
                                 (us[ix][0], vs[iy][0], us[ix][1], vs[iy][1]), color))

    def device_arrays(self, device) -> Dict[str, Any]:
        """rects, regions, colors (capacity, 4) on `device` and count, under
        the reference's keys; count stays a host int, so that the
        composite's loop needs no read from the device."""
        t = lambda a: torch.as_tensor(a, device=device)
        return {"rects": t(self._rects), "regions": t(self._regions),
                "colors": t(self._colors), "count": self._count}


def covered_pixels(rects: Tensor, width: int, height: int) -> Tensor:
    """The pixels of a width x height frame whose centre test
    (`composite_sprites`' `inside`: x >= rx and x < rx + rw on the integer
    columns, the same on the rows) puts them inside each rect (n, 4), summed
    over the rects: a 0-d int64 tensor on their device."""
    x0, y0 = rects[:, 0], rects[:, 1]
    x1, y1 = x0 + rects[:, 2], y0 + rects[:, 3]

    def span(lo, hi, n):
        first = torch.clamp(torch.ceil(lo), min=0.0)
        end = torch.clamp(torch.ceil(hi), max=float(n))
        return torch.clamp(end - first, min=0.0).long()

    return (span(x0, x1, width) * span(y0, y1, height)).sum()


def composite_sprites(image: Tensor, atlas: Tensor, sprites: Dict[str, Any]) -> Tensor:
    """Alpha-blend the sprites over the LDR image (H, W, 3) in push order:
    inside its rect each samples the atlas (A, A, 4) region at the nearest
    texel, tinted by its colour. The first `count` slots are blended. The
    open span counts the pixels inside a rect (`ui_pixels_covered`,
    `covered_pixels`, a 0-d device tensor) and the (pixel, sprite) pairs the
    path tests (`ui_pixels`).

    A CUDA image launches the composite kernel (`composite_sprites_cuda`), a
    CPU one takes `composite_sprites_plain`."""
    fn = on_device("composite_sprites", image, composite_sprites_cuda,
                   composite_sprites_plain, counter="ui")
    if profiler.recording():
        h, w = image.shape[:2]
        n = int(sprites["count"])
        profiler.count("ui_pixels_covered", covered_pixels(sprites["rects"][:n], w, h))
    return fn(image, atlas, sprites)


def composite_sprites_plain(image: Tensor, atlas: Tensor, sprites: Dict[str, Any]) -> Tensor:
    """`composite_sprites` as one full-frame pass a sprite over the first
    `count` slots. The reference loops over the capacity and masks the
    slots past the count; those hold colour 0, so they blend alpha 0 and
    change nothing: the same bits. `ui_pixels` is a full frame a sprite (a
    host int)."""
    h, w = image.shape[:2]
    a = atlas.shape[0]
    dev = image.device
    if profiler.recording():
        profiler.count("ui_pixels", int(sprites["count"]) * h * w)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    out = image
    for i in range(int(sprites["count"])):
        rx, ry, rw, rh = sprites["rects"][i].unbind()
        inside = (xs >= rx) & (xs < rx + rw) & (ys >= ry) & (ys < ry + rh)
        u = (xs - rx) / torch.clamp(rw, min=1e-6)
        v = (ys - ry) / torch.clamp(rh, min=1e-6)
        gx, gy, gw, gh = sprites["regions"][i].unbind()
        tx = torch.clamp((gx + u * gw).int(), 0, a - 1)
        ty = torch.clamp((gy + v * gh).int(), 0, a - 1)
        texel = atlas[ty.long(), tx.long()]                    # (H, W, 4)
        color = sprites["colors"][i]
        rgb = texel[..., :3] * color[:3]
        alpha = texel[..., 3] * color[3] * inside
        out = out * (1.0 - alpha[..., None]) + rgb * alpha[..., None]
    return out


# -- the kernel (csrc/sprites.cu) ----------------------------------------------

TILE_W, TILE_H = 32, 8     # a block's tile of the frame (csrc/sprites.cu: kTileW, kTileH)

# atlas -> (a weak reference to it, its version, its largest |texel|)
_atlas_max: Dict[int, Tuple[Any, int, float]] = {}


def atlas_max(atlas: Tensor) -> float:
    """The largest |texel| of `atlas`, inf where it holds a non-finite
    value. Read from the atlas's device once a version of the tensor (one
    host synchronization on a card), then kept while the tensor lives."""
    key = id(atlas)
    hit = _atlas_max.get(key)
    if hit is not None and hit[0]() is atlas and hit[1] == atlas._version:
        return hit[2]
    value = (float(torch.where(torch.isfinite(atlas), atlas.abs(), torch.inf).amax())
             if atlas.numel() else 0.0)
    _atlas_max[key] = (weakref.ref(atlas, lambda _, k=key: _atlas_max.pop(k, None)),
                       atlas._version, value)
    return value


def tile_pairs(rects: Tensor, colors: Tensor, amax: float, width: int, height: int
               ) -> Tensor:
    """The kernel's cull on the host: the (pixel, sprite) pairs each TILE_H
    x TILE_W tile of a width x height frame tests, (tiles_y, tiles_x) int64,
    over the sprites' rects and colours (n, 4). A tile keeps a sprite when
    one of its pixels is inside the rect (the loop's comparisons at the
    first column and row that pass the lower test), or when texel x colour
    could leave the finite floats for some |texel| <= amax."""
    def reaches(s, e, lo, hi):   # (tiles, n): some integer in [lo, hi] is >= s and < e
        return (hi[:, None] >= s) & (torch.fmax(lo[:, None], torch.ceil(s)) < e)

    def tiles(n, size):
        lo = torch.arange(0, n, size, dtype=torch.float32)
        return lo, torch.clamp(lo + size, max=float(n)) - 1.0

    rects, colors = rects.cpu(), colors.cpu()
    (x_lo, x_hi), (y_lo, y_hi) = tiles(width, TILE_W), tiles(height, TILE_H)
    cols = reaches(rects[:, 0], rects[:, 0] + rects[:, 2], x_lo, x_hi)
    rows = reaches(rects[:, 1], rects[:, 1] + rects[:, 3], y_lo, y_hi)
    forced = ~torch.isfinite(colors.abs() * amax).all(-1)
    keep = (rows[:, None, :] & cols[None, :, :]) | forced
    area = (y_hi - y_lo + 1).long()[:, None] * (x_hi - x_lo + 1).long()[None, :]
    return keep.sum(-1) * area


def composite_sprites_cuda(image: Tensor, atlas: Tensor, sprites: Dict[str, Any]) -> Tensor:
    """Launch the composite (csrc/sprites.cu: composite_sprites_launch): the
    arguments and bits of `composite_sprites_plain`, one launch a call and
    none for a count of 0, which returns the image. The image (H, W, 3), the
    atlas (A, A, 4) and the rects, regions and colors (capacity, 4) are
    float32 on one card; the atlas and the sprite arrays contiguous.
    `ui_pixels` is the kernel's own count of the pairs its tiles test (a 0-d
    device tensor), made only while recording."""
    dev = image.device
    if image.dim() != 3 or image.shape[-1] != 3 or image.dtype != torch.float32:
        raise ValueError(f"composite_sprites: image is {image.dtype} {tuple(image.shape)}, "
                         "expected float32 (H, W, 3)")
    if dev.type != "cuda":
        raise ValueError(f"composite_sprites needs CUDA tensors, got {dev}")
    h, w = image.shape[:2]
    a = atlas.shape[0]
    cap = sprites["rects"].shape[0]
    n = int(sprites["count"])
    if not 0 <= n <= cap or a == 0:
        raise ValueError(f"composite_sprites: {n} of {cap} sprites over a {a}-texel atlas")
    # the kernel reads each row of these as one float4
    for name, x, shape in (("atlas", atlas, (a, a, 4)), ("rects", sprites["rects"], (cap, 4)),
                           ("regions", sprites["regions"], (cap, 4)),
                           ("colors", sprites["colors"], (cap, 4))):
        check(name, x, torch.float32, shape, dev, "composite_sprites")
        if x.data_ptr() % 16:
            raise ValueError(f"composite_sprites: {name} is not 16-byte aligned")
    recording = profiler.recording()
    if n == 0:
        if recording:
            profiler.count("ui_pixels", 0)
        return image
    image = image.contiguous()
    out = torch.empty_like(image)
    pairs = (torch.empty(-(-h // TILE_H), -(-w // TILE_W), dtype=torch.int32, device=dev)
             if recording else None)
    launch("composite_sprites", dev, ptr(image), ptr(atlas), ptr(sprites["rects"]),
           ptr(sprites["regions"]), ptr(sprites["colors"]), n, h, w, a, atlas_max(atlas),
           ptr(out), kept_ptr(pairs))
    if recording:
        profiler.count("ui_pixels", pairs.sum())
    return out
