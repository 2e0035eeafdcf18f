"""PBR lighting resolve for one directional light.

Port of `garden_tpu.render.lighting`: direct GGX lighting scaled by the
shadow factor, diffuse ambient from the sky's SH irradiance (or a
hemisphere ambient without atmosphere) plus the SSGI bounce, the split-sum
specular ambient with the SSR reflections mixed in by their confidence,
AO on the ambient, emissive, and the sky where no geometry was drawn.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference.core import math3d as m3
from benchmark.reference.render import atmosphere, brdf, ibl

Tensor = torch.Tensor


def sky_color(view_dir: Tensor, light_dir: Tensor) -> Tensor:
    """Cheap analytic sky; view_dir (..., 3) points from the camera."""
    dev = view_dir.device
    vec = lambda *c: torch.tensor(c, dtype=torch.float32, device=dev)
    up = torch.clamp(view_dir[..., 1], -1.0, 1.0)
    horizon = torch.exp(-torch.abs(up) * 3.0)
    zenith = torch.clamp(up, 0.0, 1.0)
    base = (vec(0.20, 0.35, 0.65) * (1.0 - horizon)[..., None]
            + vec(0.65, 0.75, 0.85) * horizon[..., None])
    base = base * (0.3 + 0.7 * torch.clamp(light_dir[1], 0.0, 1.0))
    cos_sun = m3.dot(view_dir, light_dir)
    glow = torch.pow(torch.clamp(cos_sun, 0.0, 1.0), 64.0) * 0.5
    disk = torch.where(cos_sun > 0.9997, 40.0, 0.0)
    sun = (glow + disk)[..., None] * vec(1.0, 0.95, 0.85)
    ground = vec(0.08, 0.07, 0.06) * torch.ones_like(base)
    sky = base + sun
    return torch.where((up < 0.0)[..., None], ground, sky) * (0.5 + zenith[..., None])


def view_rays(g: Dict[str, Tensor], constants: Dict[str, Tensor]) -> Tensor:
    """Per-pixel world-space ray directions from the inverse projection."""
    h, w = g["depth"].shape
    dev = g["depth"].device
    x = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0)[None, :]
    y = (1.0 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2.0)[:, None]
    m = constants["inv_view_proj"]
    comps = [m[i, 0] * x + m[i, 1] * y + (m[i, 2] * 0.5 + m[i, 3]) for i in range(4)]
    inv_w4 = 1.0 / torch.clamp(comps[3], min=1e-9)
    world = torch.stack([comps[0] * inv_w4, comps[1] * inv_w4, comps[2] * inv_w4],
                        dim=-1)
    return m3.normalize(world - constants["camera_pos"])


SUN_INTENSITY = 4.0
AMBIENT_INTENSITY = 0.35
SKY_UP = (0.45, 0.55, 0.70)       # the hemisphere ambient's sky and ground
GROUND_DN = (0.12, 0.10, 0.08)


def resolve(g: Dict[str, Tensor], constants: Dict[str, Tensor],
            sun_intensity: float = SUN_INTENSITY,
            shadow: Optional[Tensor] = None, ao: Optional[Tensor] = None,
            ambient_intensity: float = AMBIENT_INTENSITY,
            ambient_sh: Optional[Tensor] = None, sky: Optional[Tensor] = None,
            specular_ambient: Optional[Tensor] = None,
            reflection: Optional[Tensor] = None,
            reflection_conf: Optional[Tensor] = None,
            gi: Optional[Tensor] = None) -> Tensor:
    """G-buffer + constants -> HDR radiance (H, W, 3).

    shadow (H, W[, 1 or 3]) scales the direct light and ao (H, W) the
    ambient. With `ambient_sh` (9, 3) the diffuse ambient is the SH
    irradiance, otherwise a hemisphere ambient; `gi` (H, W, 3), the SSGI
    irradiance, adds to either. `specular_ambient` is the environment's
    radiance for the split-sum specular; `reflection` (H, W, 3), the SSR
    radiance, replaces it by `reflection_conf` (H, W; 1 without it). `sky`
    (H, W, 3) fills the pixels with no geometry, otherwise the analytic
    `sky_color` does."""
    dev = g["normal"].device
    l = -constants["light_dir"]
    v = m3.normalize(constants["camera_pos"] - g["position"])
    direct = brdf.evaluate(g["normal"], v, l.expand(g["normal"].shape),
                           g["base_color"], g["metallic"], g["roughness"],
                           g["reflectance"]) * sun_intensity
    if shadow is not None:
        direct = direct * (shadow[..., None] if shadow.ndim == 2 else shadow)
    if ambient_sh is not None:
        irradiance = atmosphere.sh_irradiance(g["normal"], ambient_sh)
        if gi is not None:
            irradiance = irradiance + gi
        amb = g["base_color"] * (1.0 - g["metallic"][..., None]) * irradiance
    else:
        sky_up = m3.constant(SKY_UP, dev) * ambient_intensity
        ground_dn = m3.constant(GROUND_DN, dev) * ambient_intensity
        amb = brdf.ambient(g["normal"], g["base_color"], g["metallic"], sky_up,
                           ground_dn)
        if gi is not None:
            amb = amb + g["base_color"] * (1.0 - g["metallic"][..., None]) * gi
    if specular_ambient is not None or reflection is not None:
        nov = torch.clamp(m3.dot(g["normal"], v), min=1e-4)
        f0 = brdf.f0_from_material(g["base_color"], g["metallic"], g["reflectance"])
        env = specular_ambient
        if reflection is not None:
            conf = reflection_conf[..., None] if reflection_conf is not None else 1.0
            env = (reflection * conf if env is None
                   else env * (1.0 - conf) + reflection * conf)
        amb = amb + env * ibl.specular_env_brdf(f0, nov, g["roughness"])
    if ao is not None:
        amb = amb * ao[..., None]
    radiance = direct + amb + g["emissive"]
    if sky is None:
        sky = sky_color(view_rays(g, constants), l)
    return torch.where(g["visible"][..., None], radiance, sky)
