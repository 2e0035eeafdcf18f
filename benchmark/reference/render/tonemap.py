"""Tone mapping and auto exposure.

Port of `garden_tpu.render.tonemap`: a 256-bin log-luminance histogram on
an 8x-downsampled plane, a trimmed-mean average, temporal adaptation, the
ACES and Uchimura curves, and sRGB quantization. Inputs may be bfloat16
(the reference's post chain runs in bf16); the arithmetic then rounds to
bf16 where the reference's does.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.core import math3d as m3

Tensor = torch.Tensor

MIN_LOG_LUM = -10.0
MAX_LOG_LUM = 6.0


def aces(x: Tensor) -> Tensor:
    """ACES filmic fit (Narkowicz)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def uchimura(x: Tensor, p: float = 1.0, a: float = 1.0, m: float = 0.22,
             l: float = 0.4, c: float = 1.33, b: float = 0.0) -> Tensor:
    """Uchimura (Gran Turismo) curve."""
    l0 = ((p - m) * l) / a
    s0 = m + l0
    s1 = m + a * l0
    c2 = (a * p) / (p - s1)
    cp = -c2 / p
    t = torch.clamp((x - m) / max(l0, 1e-6), 0.0, 1.0)
    w0 = 1.0 - t ** 2 * (3.0 - 2.0 * t)
    w0 = torch.where(x < m, 1.0, torch.where(x > s0, 0.0, w0))
    w2 = torch.where(x > s0, 1.0, 0.0)
    w1 = 1.0 - w0 - w2
    toe = m * torch.pow(torch.clamp(x, min=1e-9) / m, c) + b
    linear = m + a * (x - m)
    shoulder = p - (p - s1) * torch.exp(cp * (x - s0))
    return torch.clamp(toe * w0 + linear * w1 + shoulder * w2, 0.0, 1.0)


def luminance_histogram(hdr: Tensor, bins: int = 256) -> Tensor:
    """Log-luminance histogram (float counts) of an 8x8-box-averaged plane."""
    lum = m3.luminance(hdr)
    if lum.ndim == 2 and lum.shape[0] >= 16 and lum.shape[1] >= 16:
        h8, w8 = (lum.shape[0] // 8) * 8, (lum.shape[1] // 8) * 8
        lum = lum[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8).mean(dim=(1, 3))
    log_lum = torch.where(lum > 1e-6, torch.log2(torch.clamp(lum, min=1e-6)),
                          torch.full_like(lum, MIN_LOG_LUM))
    t = (log_lum - MIN_LOG_LUM) / (MAX_LOG_LUM - MIN_LOG_LUM)
    bucket = torch.clamp((t * bins).int(), 0, bins - 1)
    return torch.bincount(bucket.reshape(-1), minlength=bins).float()


def average_luminance_from_histogram(hist: Tensor, low_cut: float = 0.5,
                                     high_cut: float = 0.95) -> Tensor:
    """Trimmed-mean luminance: bins overlapping the [low, high] population
    band count, the dark and bright tails do not."""
    bins = hist.shape[0]
    total = torch.sum(hist)
    cdf = torch.cumsum(hist, dim=0)
    keep = (cdf >= total * low_cut) & (cdf - hist <= total * high_cut)
    centers = MIN_LOG_LUM + (torch.arange(bins, dtype=torch.float32, device=hist.device)
                             + 0.5) / bins * (MAX_LOG_LUM - MIN_LOG_LUM)
    w = hist * keep
    mean_log = torch.sum(centers * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.exp2(mean_log)


def adapt_exposure(prev_avg_lum: Tensor, target_avg_lum: Tensor,
                   delta_time: Tensor, speed_up: float = 3.0,
                   speed_down: float = 1.0) -> Tensor:
    """Temporal eye adaptation toward the target luminance."""
    speed = torch.where(target_avg_lum > prev_avg_lum, speed_up, speed_down)
    t = 1.0 - torch.exp(-delta_time * speed)
    return prev_avg_lum + (target_avg_lum - prev_avg_lum) * t


def exposure_from_luminance(avg_lum: Tensor, key: float = 0.18,
                            compensation: float = 0.0) -> Tensor:
    return key / torch.clamp(avg_lum, min=1e-4) * math.pow(2.0, compensation)


def tone_map(hdr: Tensor, exposure: Tensor, mode: str = "aces") -> Tensor:
    """HDR (H, W, 3) -> float sRGB in [0, 1] (quantize with `to_uint8`).
    The curve runs in float32 (a bf16 image is widened first, as the
    reference's type promotion against the f32 exposure does)."""
    curve = aces if mode == "aces" else uchimura
    return m3.linear_to_srgb(curve(hdr.float() * exposure))


def to_uint8(srgb: Tensor) -> Tensor:
    return (torch.clamp(srgb, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
