"""Volumetric clouds: a raymarched noise layer, and its shadow on the ground.

Port of `garden_tpu.render.clouds`. A flat cloud slab [base, top] (km) is
marched with a fixed step count; the density is a Perlin-Worley base eroded
by Worley detail (`ops/noise.py`), evaluated procedurally per step and
scrolled by the wind; lighting is Beer-Lambert toward the sun (two taps
along the light ray) with a powder term and an ambient floor. The result
is composited over the sky by alpha. `cloud_shadow` attenuates sunlight at
ground points by the density where their sun ray meets the cloud base.
"""

from __future__ import annotations

from typing import Tuple

import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.ops import noise

Tensor = torch.Tensor

BRIGHT = (1.0, 0.98, 0.95)     # sunlit cloud tint
DARK = (0.25, 0.28, 0.34)      # ambient cloud tint


def _density(p: Tensor, time: Tensor, coverage: float, seed: int = 0) -> Tensor:
    """Cloud density at world positions (..., 3), wind-scrolled."""
    x = p[..., 0] * 0.004 + time * 0.01
    y = p[..., 1] * 0.01
    z = p[..., 2] * 0.004
    base = noise.perlin_worley3(x, z, y, seed=seed)
    base = 0.7 * base + 0.3 * noise.perlin_worley3(x * 2.0, z * 2.0, y * 2.0,
                                                   seed=seed + 3)
    shaped = torch.clamp((base - (1.0 - coverage * 1.6)) / 0.4, 0.0, 1.0)
    # detail erosion: high-frequency Worley carves the edges
    detail = 1.0 - noise.worley3(x * 6.0, z * 6.0, y * 6.0, seed=seed + 5)
    return torch.clamp(shaped - (1.0 - shaped) * detail * 0.3, 0.0, 1.0)


def render_clouds(view_dir: Tensor, sun_dir_to_light: Tensor, camera_height: float = 0.2,
                  time: Tensor = None, base_km: float = 1.2, top_km: float = 2.4,
                  coverage: float = 0.45, steps: int = 10, seed: int = 0
                  ) -> Tuple[Tensor, Tensor]:
    """(cloud rgb (..., 3), alpha (...,)) for sky-ray directions (..., 3);
    `time` is a float32 scalar tensor (None: 0)."""
    dev = view_dir.device
    v = m3.normalize(view_dir)
    l = m3.normalize(sun_dir_to_light)
    time = m3.constant(0.0, dev) if time is None else time.float()

    mu = v[..., 1]
    up = mu > 0.02                      # only above the horizon
    mu_safe = torch.where(up, torch.clamp(mu, min=0.02), 1.0)
    # a Python number over a tensor divides truly here, as in the reference
    # (`number / tensor` would multiply by the reciprocal)
    t0 = torch.div(m3.constant(base_km - camera_height, dev), mu_safe)
    t1 = torch.div(m3.constant(top_km - camera_height, dev), mu_safe)
    seg = torch.clamp(t1 - t0, min=0.0)
    dt = seg / steps

    # phase: silver lining toward the sun (x ** 8 by squaring, as XLA's
    # integer power)
    c = torch.clamp(m3.dot(v, l), 0.0, 1.0)
    c = c * c
    c = c * c
    phase = 0.6 + 0.4 * (c * c) * 4.0

    sun_light = torch.clamp(l[1], 0.0, 1.0)
    bright = (0.9 + 0.4 * phase)[..., None] * m3.constant(BRIGHT, dev) * sun_light
    dark = m3.constant(DARK, dev) * (0.3 + 0.7 * sun_light)

    trans = torch.ones_like(mu)
    light_acc = torch.zeros_like(mu)
    for i in range(steps):
        t = t0 + (i + 0.5) * dt
        p = v * t[..., None] * 1000.0   # km -> world units for the noise scale
        h01 = ((camera_height + t * mu) - base_km) / (top_km - base_km)
        height_falloff = torch.clamp(4.0 * h01 * (1.0 - h01), 0.0, 1.0)
        dens = _density(p, time, coverage, seed) * height_falloff
        dens = torch.where(up, dens, 0.0)
        # Beer-Lambert toward the sun, two taps along the light ray
        occ = (_density(p + l * 200.0, time, coverage, seed) * 0.5
               + _density(p + l * 600.0, time, coverage, seed) * 0.3)
        shade = torch.exp(-occ * 2.0)
        # powder term: dark cores brighten toward the edges
        powder = 1.0 - torch.exp(-dens * 4.0)
        absorb = dens * dt * 3.0
        contrib = trans * (1.0 - torch.exp(-absorb))
        light_acc = light_acc + contrib * shade * (0.4 + 0.6 * powder)
        trans = trans * torch.exp(-absorb)

    alpha = torch.where(up, 1.0 - trans, 0.0)
    lit = light_acc[..., None] * bright + alpha[..., None] * 0.25 * dark
    rgb = lit / torch.clamp(alpha, min=1e-5)[..., None]
    # distance fade at the horizon
    fade = torch.clamp((mu - 0.02) / 0.08, 0.0, 1.0)
    return rgb, alpha * fade


def composite_clouds(sky: Tensor, rgb: Tensor, alpha: Tensor) -> Tensor:
    return sky * (1.0 - alpha[..., None]) + rgb * alpha[..., None]


def cloud_shadow(positions: Tensor, sun_dir_to_light: Tensor, time: Tensor = None,
                 base_km: float = 1.2, coverage: float = 0.45, seed: int = 0) -> Tensor:
    """Sun transmittance through the cloud layer at ground points (..., 3)
    -> (...,): each point's sun ray is followed to the cloud base and
    attenuated by the density there."""
    dev = positions.device
    l = m3.normalize(sun_dir_to_light)
    time = m3.constant(0.0, dev) if time is None else time.float()
    mu = torch.clamp(l[1], min=0.05)
    # distance along the sun ray to the cloud base (km -> world units)
    t = (base_km * 1000.0 - positions[..., 1]) / mu
    p = positions + l * t[..., None]
    dens = _density(p, time, coverage, seed)
    dens = 0.7 * dens + 0.3 * _density(p + l * 400.0, time, coverage, seed)
    return torch.exp(-dens * 2.5)
