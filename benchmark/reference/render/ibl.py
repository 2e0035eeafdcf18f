"""Image-based lighting: the environment BRDF and prefiltered lat-long maps.

Port of `garden_tpu.render.ibl`: Lazarov's analytic fit of the split-sum
DFG term and its application to F0; a roughness-prefiltered mip chain of a
lat-long environment map (a linear 2x downsample and a box blur that
widens per mip, wrapping in longitude), its nearest-texel sample with a
roughness-selected pair of mips, its order-2 SH projection, and the chain
of the procedural sky.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from benchmark.reference.core import math3d as m3

Tensor = torch.Tensor


def dfg_approx(nov: Tensor, roughness: Tensor) -> Tuple[Tensor, Tensor]:
    """Analytic environment-BRDF (scale, bias) for F0 (Lazarov 2013)."""
    r0 = roughness * -1.0 + 1.0
    r1 = roughness * -0.0275 + 0.0425
    r2 = roughness * -0.572 + 1.04
    r3 = roughness * 0.022 - 0.04
    a004 = torch.minimum(r0 * r0, torch.exp2(-9.28 * nov)) * r0 + r1
    scale = -1.04 * a004 + r2
    bias = 1.04 * a004 + r3
    return scale, bias


def specular_env_brdf(f0: Tensor, nov: Tensor, roughness: Tensor) -> Tensor:
    """Split-sum weight of the environment sample: f0 * scale + bias."""
    scale, bias = dfg_approx(nov, roughness)
    return f0 * scale[..., None] + bias[..., None]


def _blur2d(img: Tensor, radius: int) -> Tensor:
    """Separable box blur of an (H, W, C) map: wrapping in longitude (x),
    clamped in latitude (y)."""
    if radius <= 0:
        return img
    n = 2 * radius + 1
    acc = torch.zeros_like(img)
    for d in range(-radius, radius + 1):
        acc = acc + torch.roll(img, d, dims=1)
    img = acc / n
    acc = torch.zeros_like(img)
    h = img.shape[0]
    for d in range(-radius, radius + 1):
        idx = torch.clamp(torch.arange(h, device=img.device) + d, 0, h - 1)
        acc = acc + img[idx]
    return acc / n


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of `jax.image.resize`'s "linear"
    method along one axis, with its antialiasing: the triangle kernel
    widened by the downscale, each column normalized, columns whose sample
    lies outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(n_out) / f32(n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_linear(img: Tensor, h: int, w: int) -> Tensor:
    """(H, W, C) -> (h, w, C) as `jax.image.resize(img, (h, w, C),
    "linear")`: a weighted sum along each axis that changes size."""
    if img.shape[0] != h:
        wy = torch.from_numpy(_linear_weights(img.shape[0], h)).to(img.device)
        img = torch.einsum("ic,iwk->cwk", wy, img)
    if img.shape[1] != w:
        wx = torch.from_numpy(_linear_weights(img.shape[1], w)).to(img.device)
        img = torch.einsum("jd,hjk->hdk", wx, img)
    return img


def prefilter_latlong(env: Tensor, mip_count: int = 5) -> List[Tensor]:
    """Roughness-prefiltered lat-long mip chain of env (H, W, 3), W = 2H:
    mip k (for roughness k / (mip_count - 1)) halves the previous one (at
    least 4 x 8) and box-blurs it with radius 1 + k."""
    mips = [env]
    cur = env
    for k in range(1, mip_count):
        cur = resize_linear(cur, max(cur.shape[0] // 2, 4), max(cur.shape[1] // 2, 8))
        cur = _blur2d(cur, radius=1 + k)
        mips.append(cur)
    return mips


def _latlong_uv(dirs: Tensor) -> Tuple[Tensor, Tensor]:
    """Direction -> lat-long (u in [0, 1) longitude, v in [0, 1] latitude)."""
    d = m3.normalize(dirs)
    u = torch.remainder(torch.atan2(d[..., 2], d[..., 0]) / (2.0 * math.pi), 1.0)
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def sample_prefiltered(mips: List[Tensor], dirs: Tensor, roughness: Tensor) -> Tensor:
    """The chain's radiance (..., 3) in the directions dirs (..., 3): the
    nearest texel of the two mips around roughness * (len(mips) - 1),
    blended linearly."""
    n = len(mips)
    level = torch.clamp(roughness, 0.0, 1.0) * (n - 1)
    lo = torch.floor(level).int()
    frac = level - lo
    u, v = _latlong_uv(dirs)
    out = torch.zeros(dirs.shape[:-1] + (3,), dtype=torch.float32, device=dirs.device)
    for k, mip in enumerate(mips):
        h, w = mip.shape[0], mip.shape[1]
        x = torch.clamp((u * w).int(), 0, w - 1)
        y = torch.clamp((v * h).int(), 0, h - 1)
        val = mip.reshape(-1, 3)[(y * w + x).long()]
        w_k = torch.where(lo == k, 1.0 - frac, torch.where(lo == k - 1, frac, 0.0))
        out = out + val * w_k[..., None]
    return out


def _latlong_dirs(h: int, w: int, device) -> Tuple[Tensor, Tensor]:
    """(directions (h, w, 3), polar angle (h, w)) of a lat-long map's texel
    centres."""
    theta = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h * math.pi
    phi = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w * 2.0 * math.pi
    th, ph = torch.meshgrid(theta, phi, indexing="ij")
    dirs = torch.stack([torch.sin(th) * torch.cos(ph), torch.cos(th),
                        torch.sin(th) * torch.sin(ph)], dim=-1)
    return dirs, th


def latlong_sh(env: Tensor) -> Tensor:
    """Order-2 SH projection of a lat-long map (H, W, 3) -> (9, 3)
    radiance coefficients, each texel weighted by its solid angle."""
    from benchmark.reference.render.atmosphere import _sh_basis
    h, w = env.shape[0], env.shape[1]
    dirs, th = _latlong_dirs(h, w, env.device)
    d_omega = (math.pi / h) * (2.0 * math.pi / w) * torch.sin(th)
    return torch.einsum("hwb,hwc->bc", _sh_basis(dirs) * d_omega[..., None], env)


def sky_prefiltered(sun_dir_to_light: Tensor, height: int = 32,
                    mip_count: int = 5) -> List[Tensor]:
    """The procedural sky rendered into a height x 2 height lat-long map (8
    march steps) and prefiltered (`prefilter_latlong`)."""
    from benchmark.reference.render.atmosphere import sky_radiance
    dirs, _ = _latlong_dirs(height, height * 2, sun_dir_to_light.device)
    return prefilter_latlong(sky_radiance(dirs, sun_dir_to_light, steps=8), mip_count)
