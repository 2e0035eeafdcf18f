"""2D sprites and UI quads from one texture atlas.

Port of `garden_tpu.render.sprites`: a host-side shelf-packed RGBA atlas
(`TextureAtlas`), a fixed-capacity sprite list baked to device tensors
(`SpriteBatch`, with nine-slice panels), and `composite_sprites`, which
blends the sprites over an LDR image in push order, each sampling its
atlas region at the nearest texel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

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
    texel, tinted by its colour. The loop runs over the first `count`
    slots. The reference loops over the capacity and masks the slots past
    the count; those hold colour 0, so they blend alpha 0 and change
    nothing: the same bits. The open span counts the pixels the loop
    passes over, a full frame a sprite (`ui_pixels`, a host int), and those
    inside a rect (`ui_pixels_covered`, `covered_pixels`, a 0-d device
    tensor)."""
    h, w = image.shape[:2]
    a = atlas.shape[0]
    dev = image.device
    if profiler.recording():
        n = int(sprites["count"])
        profiler.count("ui_pixels", n * h * w)
        profiler.count("ui_pixels_covered", covered_pixels(sprites["rects"][:n], w, h))
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
