"""Edge-clamped shifted reads for dense screen-space passes.

Port of `garden_tpu.ops.shifts`. HBAO, FXAA, PCF taps and the bilateral
upsample read fixed-offset copies of an image with edge-clamp semantics;
`Shifter` pads once to the largest tap radius and serves each tap as a
slice (a view) of the padded tensor.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def edge_pad(img: Tensor, pad_y: tuple, pad_x: tuple) -> Tensor:
    """Pad the two leading (row, column) axes by repeating the edge rows
    and columns: pad_y = (top, bottom), pad_x = (left, right). Works for
    any dtype (bool included) and any number of trailing channel axes."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    iy = torch.clamp(torch.arange(-pad_y[0], h + pad_y[1], device=dev), 0, h - 1)
    ix = torch.clamp(torch.arange(-pad_x[0], w + pad_x[1], device=dev), 0, w - 1)
    return img.index_select(0, iy).index_select(1, ix)


class Shifter:
    """`Shifter(img, ry, rx)(dy, dx)[y, x] == img[clamp(y + dy), clamp(x + dx)]`
    for any |dy| <= ry, |dx| <= rx. Pads once at construction; each call
    is one slice."""

    def __init__(self, img: Tensor, ry: int, rx: int):
        self.h, self.w = img.shape[0], img.shape[1]
        self.ry, self.rx = int(ry), int(rx)
        self.p = (img if self.ry == 0 and self.rx == 0
                  else edge_pad(img, (self.ry, self.ry), (self.rx, self.rx)))

    def __call__(self, dy: int, dx: int) -> Tensor:
        dy, dx = int(dy), int(dx)
        assert abs(dy) <= self.ry and abs(dx) <= self.rx, \
            f"tap ({dy},{dx}) outside padded radius ({self.ry},{self.rx})"
        return self.p[self.ry + dy:self.ry + dy + self.h,
                      self.rx + dx:self.rx + dx + self.w]
