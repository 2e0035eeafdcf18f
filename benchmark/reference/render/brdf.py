"""PBR BRDF: GGX / height-correlated Smith / Schlick, Lambert diffuse.

Port of `garden_tpu.render.brdf` (the Filament-style model of the
reference's lighting resolve).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.core import math3d as m3

Tensor = torch.Tensor


def d_ggx(noh: Tensor, roughness: Tensor) -> Tensor:
    a = roughness * roughness
    a2 = a * a
    f = noh * noh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * f * f, min=1e-9)


def v_smith_ggx_correlated(nov: Tensor, nol: Tensor, roughness: Tensor) -> Tensor:
    a = roughness * roughness
    a2 = a * a
    lv = nol * torch.sqrt(torch.clamp(nov * nov * (1.0 - a2) + a2, min=1e-9))
    ll = nov * torch.sqrt(torch.clamp(nol * nol * (1.0 - a2) + a2, min=1e-9))
    return 0.5 / torch.clamp(lv + ll, min=1e-9)


def f_schlick(voh: Tensor, f0: Tensor) -> Tensor:
    """Schlick Fresnel with f90 = 1; f0 is (..., 3), voh (...)."""
    p = torch.pow(torch.clamp(1.0 - voh, 0.0, 1.0), 5.0)[..., None]
    return f0 + (1.0 - f0) * p


def f0_from_material(base_color: Tensor, metallic: Tensor,
                     reflectance: Tensor) -> Tensor:
    """Dielectric F0 from reflectance; metals take the base color."""
    dielectric = (0.16 * reflectance * reflectance)[..., None]
    return m3.lerp(dielectric.expand(base_color.shape), base_color,
                   metallic[..., None])


def evaluate(normal: Tensor, view: Tensor, light: Tensor, base_color: Tensor,
             metallic: Tensor, roughness: Tensor, reflectance: Tensor) -> Tensor:
    """Direct BRDF * NoL for one directional light."""
    n, v, l = normal, view, light
    h = m3.normalize(v + l)
    nov = torch.clamp(m3.dot(n, v), min=1e-4)
    nol = torch.clamp(m3.dot(n, l), 0.0, 1.0)
    noh = torch.clamp(m3.dot(n, h), 0.0, 1.0)
    voh = torch.clamp(m3.dot(v, h), 0.0, 1.0)
    rough = torch.clamp(roughness, 0.045, 1.0)
    f0 = f0_from_material(base_color, metallic, reflectance)
    d = d_ggx(noh, rough)
    vis = v_smith_ggx_correlated(nov, nol, rough)
    specular = (d * vis)[..., None] * f_schlick(voh, f0)
    diffuse = base_color * (1.0 - metallic[..., None]) / math.pi
    return (diffuse + specular) * nol[..., None]


def ambient(normal: Tensor, base_color: Tensor, metallic: Tensor,
            sky_color: Tensor, ground_color: Tensor) -> Tensor:
    """Hemisphere ambient."""
    up = torch.clamp(normal[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    irradiance = m3.lerp(ground_color, sky_color, up)
    return base_color * (1.0 - metallic[..., None]) * irradiance
