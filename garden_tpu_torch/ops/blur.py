"""Blurs, 2x decimation and upsampling of screen-space images.

Port of `garden_tpu.ops.blur`: the box and depth-aware (bilateral) blurs; on
the frame path, the 2x mean
decimation behind every half-res pass, the tent upsample of the sky and
specular ambient, the depth-guided (joint bilateral) upsample of the
shadow and AO factors, and the refraction pass's GGX blur chain (gaussian
blur, mean-pool downsample) with the linear upsample it samples through.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from garden_tpu_torch.ops.shifts import Shifter, edge_pad

Tensor = torch.Tensor


def gaussian_kernel(radius: int, sigma: Optional[float] = None) -> np.ndarray:
    """Normalized float32 gaussian taps, 2 * radius + 1 of them."""
    sigma = sigma or max(radius / 2.0, 1e-3)
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: Tensor, radius: int = 2, sigma: Optional[float] = None) -> Tensor:
    """Separable gaussian blur of (H, W[, C]) with edge clamping: a row pass,
    then a column pass, each summing its taps in kernel order."""
    k = gaussian_kernel(radius, sigma)
    at = Shifter(img, 0, radius)
    out = torch.zeros_like(img)
    for i, wgt in enumerate(k):
        out = out + at(0, radius - i) * float(wgt)
    at = Shifter(out, radius, 0)
    out = torch.zeros_like(img)
    for i, wgt in enumerate(k):
        out = out + at(radius - i, 0) * float(wgt)
    return out


def box_blur(img: Tensor, radius: int = 1) -> Tensor:
    """Separable box blur of (H, W[, C]) with edge clamping."""
    n = 2 * radius + 1
    at = Shifter(img, 0, radius)
    out = torch.zeros_like(img)
    for d in range(-radius, radius + 1):
        out = out + at(0, -d)
    at = Shifter(out / n, radius, 0)
    out = torch.zeros_like(img)
    for d in range(-radius, radius + 1):
        out = out + at(-d, 0)
    return out / n


def bilateral_blur(img: Tensor, guide_depth: Tensor, radius: int = 2,
                   depth_sigma: float = 0.1) -> Tensor:
    """Depth-aware blur of (H, W[, C]): gaussian taps weighted by
    exp(-|depth - centre depth| / depth_sigma), summed row by row."""
    k = gaussian_kernel(radius)
    g_at = Shifter(guide_depth, radius, radius)
    i_at = Shifter(img, radius, radius)
    acc = torch.zeros_like(img)
    wacc = torch.zeros(img.shape[:2] + (1,) * (img.ndim - 2), dtype=img.dtype,
                       device=img.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            wgt = float(k[dy + radius] * k[dx + radius])
            dw = torch.exp(-torch.abs(g_at(-dy, -dx) - guide_depth) / depth_sigma)
            w = wgt * dw
            while w.ndim < img.ndim:
                w = w[..., None]
            acc = acc + i_at(-dy, -dx) * w
            wacc = wacc + w
    return acc / torch.clamp(wacc, min=1e-6)


def downsample2x(img: Tensor) -> Tensor:
    """(H, W[, C]) -> (H//2, W//2[, C]) mean pool of each 2x2 block (an odd
    last row or column is dropped)."""
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    x = img[:h, :w]
    return x.reshape((h // 2, 2, w // 2, 2) + tuple(x.shape[2:])).mean(dim=(1, 3))


def ggx_blur_chain(img: Tensor, levels: int = 4) -> List[Tensor]:
    """Progressively blurred half-size chain [img, level 1, ...] for the
    refraction pass's roughness-driven blur."""
    chain = [img]
    for _ in range(levels):
        chain.append(downsample2x(gaussian_blur(chain[-1], radius=1)))
    return chain


def upsample_linear(img: Tensor, th: int, tw: int) -> Tensor:
    """(h, w, C) -> (th, tw, C) bilinear, half-pixel centres, edge-clamped:
    for upscales the samples of `jax.image.resize(img, (th, tw, C),
    "linear")`, which sums kernel weights where this lerps."""
    x = img.permute(2, 0, 1)[None]
    up = torch.nn.functional.interpolate(x, size=(th, tw), mode="bilinear",
                                         align_corners=False)
    return up[0].permute(1, 2, 0)


def decimate2x(img: Tensor) -> Tensor:
    """(H, W[, C]) -> (H//2, W//2[, C]) mean of each 2x2 block; an odd last
    row or column is dropped (the reference's VALID window over
    shape & ~1). The four taps add in row-major order, as its window
    reduction does."""
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    x = img[:h, :w]
    return (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) * 0.25


def _tent3x3(up: Tensor) -> Tensor:
    """3x3 tent (1 2 1 / 2 4 2 / 1 2 1) / 16 with edge clamping."""
    h, w = up.shape[0], up.shape[1]
    p = edge_pad(up, (1, 1), (1, 1))
    return (p[0:h, 0:w] + 2 * p[0:h, 1:w + 1] + p[0:h, 2:w + 2]
            + 2 * p[1:h + 1, 0:w] + 4 * p[1:h + 1, 1:w + 1] + 2 * p[1:h + 1, 2:w + 2]
            + p[2:h + 2, 0:w] + 2 * p[2:h + 2, 1:w + 1] + p[2:h + 2, 2:w + 2]) / 16.0


def upsample2x_to(x: Tensor, th: int, tw: int) -> Tensor:
    """(h, w[, C]) -> (th, tw[, C]): repeat each pixel 2x2, edge-pad or crop
    to the target, then a 3x3 tent."""
    up = x.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    if up.shape[0] < th or up.shape[1] < tw:
        up = edge_pad(up, (0, max(th - up.shape[0], 0)),
                      (0, max(tw - up.shape[1], 0)))
    return _tent3x3(up[:th, :tw])


def bilateral_upsample_to(x: Tensor, guide_lo: Tensor, guide_full: Tensor,
                          th: int, tw: int) -> Tensor:
    """Depth-guided upsample of a low-res factor `x` (h, w[, c]) to
    (th, tw[, c]) with a low-res guide (h, w) and the full-res guide
    (th, tw): six taps of the repeated low-res neighbourhood, each weighted
    by 1 / (|guide - guide_full| / max(|guide_full|, 1) + 1e-3)."""
    chan = x.ndim == 3
    if not chan:
        x = x[..., None]

    def up_to(a, h, w):
        while a.shape[0] < h or a.shape[1] < w:
            a = a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        return a[:h, :w]

    x_at = Shifter(up_to(x, th, tw), 1, 1)
    g_at = Shifter(up_to(guide_lo[..., None], th, tw)[..., 0], 1, 1)
    eps = 1e-3
    acc = torch.zeros((th, tw, x.shape[-1]), dtype=x.dtype, device=x.device)
    wsum = torch.zeros((th, tw, 1), dtype=x.dtype, device=x.device)
    scale = torch.clamp(torch.abs(guide_full), min=1.0)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1), (0, -1), (-1, 0)):
        w = 1.0 / (torch.abs(g_at(dy, dx) - guide_full) / scale + eps)
        acc = acc + x_at(dy, dx) * w[..., None]
        wsum = wsum + w[..., None]
    out = acc / torch.clamp(wsum, min=1e-9)
    return out if chan else out[..., 0]
