"""Physically-based sky and aerial perspective, frame path only.

Port of the frame-path functions of `garden_tpu.render.atmosphere`: sun
transmittance from a Chapman-function airmass (no LUT lookups), the
single-scattering sky raymarch with a multi-scatter floor, ground albedo
and sun disk, aerial perspective on geometry, and the order-2
spherical-harmonics projection of the sky with its irradiance; and the
reference's offline LUTs (`transmittance_lut`, `multi_scatter_lut`),
which the frame path does not read.

`sky_radiance` and `aerial_perspective` launch the hand-written kernels of
`csrc/atmosphere.cu` (one thread a ray, the march in registers, the sun
read on the card) on CUDA tensors and take their plain versions,
`sky_radiance_plain` and `aerial_perspective_plain`, on CPU tensors; the
kernels give the plain versions' bits on the card. While a profiler
records, each call charges the open span with `atmosphere_calls` 1 and
`atmosphere_kernel_calls` 1 when the kernel ran (0 on the CPU).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.cuda_build import check, check_rays, f32, launch, on_device, ptr, recip

Tensor = torch.Tensor

# Earth-like atmosphere (Hillaire 2020)
R_GROUND = 6360.0      # km
R_TOP = 6460.0         # km
H_RAYLEIGH = 8.0       # km scale height
H_MIE = 1.2
BETA_RAYLEIGH = (5.802e-3, 13.558e-3, 33.1e-3)   # 1/km
BETA_MIE_SCAT = 3.996e-3
BETA_MIE_ABS = 4.4e-3
BETA_OZONE = (0.650e-3, 1.881e-3, 0.085e-3)
MIE_G = 0.8
SUN_INTENSITY = 16.0


def _vec(values, like: Tensor) -> Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def _chapman(x: Tensor, cos_chi: Tensor) -> Tensor:
    """Chapman grazing-incidence airmass approximation (Schueler 2012)."""
    c = torch.sqrt(x * (2.0 * math.pi))
    upper = c / (c * cos_chi + 1.0)
    sin_chi = torch.sqrt(torch.clamp(1.0 - cos_chi * cos_chi, min=0.0))
    x_horizon = x * sin_chi
    ch0 = torch.sqrt(x_horizon * (2.0 * math.pi)) * 0.5 + 1.0
    lower = 2.0 * torch.exp(x - x_horizon) * ch0 - c / (c * (-cos_chi) + 1.0)
    return torch.where(cos_chi >= 0.0, upper, lower)


def _optical_depth_to_space(height_km: Tensor, cos_zenith: Tensor,
                            scale_height: float) -> Tensor:
    """Airmass integral from `height_km` to space, clamped at 1e4 (the
    Chapman lower branch overflows for deeply downward rays)."""
    x = (R_GROUND + height_km) / scale_height
    od = scale_height * torch.exp(-height_km / scale_height) * _chapman(x, cos_zenith)
    return torch.clamp(od, max=1e4)


def sun_transmittance(height_km: Tensor, cos_zenith: Tensor) -> Tensor:
    """Transmittance toward the sun (..., 3); 0 below the horizon."""
    od_r = _optical_depth_to_space(height_km, cos_zenith, H_RAYLEIGH)
    od_m = _optical_depth_to_space(height_km, cos_zenith, H_MIE)
    tau = (od_r[..., None] * _vec(BETA_RAYLEIGH, od_r)
           + od_m[..., None] * (BETA_MIE_SCAT + BETA_MIE_ABS)
           + od_r[..., None] * _vec(BETA_OZONE, od_r) * 0.1)
    sin_h = R_GROUND / (R_GROUND + torch.clamp(height_km, min=0.0))
    horizon_mu = -torch.sqrt(torch.clamp(1.0 - sin_h * sin_h, min=0.0))
    blocked = cos_zenith < horizon_mu
    return torch.where(blocked[..., None], 0.0, torch.exp(-tau))


def transmittance_lut(size: Tuple[int, int] = (64, 256), device="cuda") -> Tensor:
    """The 256x64 transmittance LUT (size[0], size[1], 3): rows altitude in
    [0, R_TOP - R_GROUND] km, columns sun zenith cosine in [-0.2, 1]."""
    hgrid = torch.linspace(0.0, R_TOP - R_GROUND, size[0], device=device)
    mugrid = torch.linspace(-0.2, 1.0, size[1], device=device)
    h, mu = torch.meshgrid(hgrid, mugrid, indexing="ij")
    return sun_transmittance(h, mu)


def multi_scatter_lut(size: int = 32, dirs: int = 64, device="cuda") -> Tensor:
    """The 32x32 multiple-scattering LUT (size, size, 3): rows altitude in
    [0, R_TOP - R_GROUND] km, columns sun zenith cosine in [-1, 1]; the
    isotropic multi-scatter transfer Psi = L2 / (1 - f_ms) from a
    second-order estimate over `dirs` directions (an 8-step march of 40 km
    each). Non-finite cells (grazing overflow below the horizon) are 0."""
    h_grid = torch.linspace(0.0, R_TOP - R_GROUND, size, device=device)
    mu_grid = torch.linspace(-1.0, 1.0, size, device=device)
    h, mu = torch.meshgrid(h_grid, mu_grid, indexing="ij")
    sph = torch.from_numpy(_fibonacci_sphere(dirs)).to(device)
    sun = torch.stack([torch.sqrt(torch.clamp(1 - mu ** 2, 0, 1)), mu,
                       torch.zeros_like(mu)], dim=-1)
    beta_r = torch.tensor(BETA_RAYLEIGH, dtype=torch.float32, device=device)
    beta_r_mean = beta_r.mean()
    l2 = torch.zeros(h.shape + (3,), device=device)
    fms = torch.zeros(h.shape, device=device)
    dt = 40.0 / 8
    for d in range(dirs):
        v = sph[d]
        cos_sun = torch.sum(sun * v, dim=-1)
        ph_r = _phase_rayleigh(cos_sun)[..., None]
        ph_m = _phase_mie(cos_sun)[..., None]
        tau = torch.zeros(h.shape + (3,), device=device)
        for i in range(8):
            y = torch.clamp(h + v[1] * (i + 0.5) * dt, min=0.0)
            dens_r = torch.exp(-y / H_RAYLEIGH)
            dens_m = torch.exp(-y / H_MIE)
            t_sun = sun_transmittance(y, mu)
            scat = beta_r * dens_r[..., None] * ph_r + BETA_MIE_SCAT * dens_m[..., None] * ph_m
            l2 = l2 + scat * t_sun * torch.exp(-tau) * dt / dirs
            fms = fms + (beta_r_mean * dens_r + BETA_MIE_SCAT * dens_m) \
                * torch.exp(-tau.mean(-1)) * dt / dirs
            tau = tau + (beta_r * dens_r[..., None]
                         + (BETA_MIE_SCAT + BETA_MIE_ABS) * dens_m[..., None]) * dt
    psi = l2 / torch.clamp(1.0 - torch.clamp(fms, 0.0, 0.99), min=1e-3)[..., None]
    return torch.nan_to_num(psi, nan=0.0, posinf=0.0)


def _phase_rayleigh(cos_t: Tensor) -> Tensor:
    return 3.0 / (16.0 * math.pi) * (1.0 + cos_t * cos_t)


def _phase_mie(cos_t: Tensor, g: float = MIE_G) -> Tensor:
    gg = g * g
    return (3.0 / (8.0 * math.pi)) * ((1.0 - gg) * (1.0 + cos_t * cos_t)) / (
        (2.0 + gg) * torch.pow(torch.clamp(1.0 + gg - 2.0 * g * cos_t, min=1e-6), 1.5))


def sky_radiance(view_dir: Tensor, sun_dir_to_light: Tensor,
                 camera_height_km: float = 0.2, steps: int = 12) -> Tensor:
    """Single-scattered sky radiance along view rays (..., 3): a `steps`
    sample raymarch with analytic sun transmittance, a multi-scatter floor,
    ground albedo for rays that hit the earth and the sun disk. CUDA
    tensors launch the sky kernel (`sky_radiance_cuda`), CPU tensors take
    `sky_radiance_plain`."""
    fn = on_device("sky_radiance", view_dir, sky_radiance_cuda, sky_radiance_plain,
                   counter="atmosphere")
    return fn(view_dir, sun_dir_to_light, camera_height_km, steps)


def sky_radiance_plain(view_dir: Tensor, sun_dir_to_light: Tensor,
                       camera_height_km: float = 0.2, steps: int = 12) -> Tensor:
    """`sky_radiance` in PyTorch ops, on any device."""
    v = m3.normalize(view_dir)
    l = m3.normalize(sun_dir_to_light)
    mu_v = v[..., 1]
    h0 = camera_height_km
    r0 = R_GROUND + h0
    b = r0 * mu_v
    disc_top = b * b + (R_TOP * R_TOP - r0 * r0)
    t_top = -b + torch.sqrt(torch.clamp(disc_top, min=0.0))
    disc_g = b * b + (R_GROUND * R_GROUND - r0 * r0)
    hits_ground = (mu_v < 0.0) & (disc_g > 0.0)
    t_ground = -b - torch.sqrt(torch.clamp(disc_g, min=0.0))
    t_max = torch.where(hits_ground, torch.clamp(t_ground, min=0.0), t_top)
    t_max = torch.clamp(t_max, 0.0, 400.0)

    cos_sun = m3.dot(v, l)
    ph_r = _phase_rayleigh(cos_sun)[..., None]
    ph_m = _phase_mie(cos_sun)[..., None]
    mu_sun = l[..., 1]
    beta_r = _vec(BETA_RAYLEIGH, v)
    lum = torch.zeros(v.shape[:-1] + (3,), device=v.device)
    tau_acc = torch.zeros(v.shape[:-1] + (3,), device=v.device)
    dt = t_max / steps
    for i in range(steps):
        t = (i + 0.5) * dt
        y = torch.sqrt(r0 * r0 + t * t + 2.0 * r0 * t * mu_v) - R_GROUND
        y = torch.clamp(y, min=0.0)
        dens_r = torch.exp(-y / H_RAYLEIGH)[..., None]
        dens_m = torch.exp(-y / H_MIE)[..., None]
        step_tau = (beta_r * dens_r + (BETA_MIE_SCAT + BETA_MIE_ABS) * dens_m) \
            * dt[..., None]
        t_view = torch.exp(-(tau_acc + 0.5 * step_tau))
        t_sun = sun_transmittance(y, mu_sun.expand(y.shape))
        scat = beta_r * dens_r * ph_r + BETA_MIE_SCAT * dens_m * ph_m
        lum = lum + SUN_INTENSITY * scat * t_sun * t_view * dt[..., None]
        tau_acc = tau_acc + step_tau

    ms = 0.075 * _vec((0.35, 0.45, 0.7), v) * torch.clamp(mu_sun, 0.0, 1.0)
    lum = lum + ms * (1.0 - torch.exp(-tau_acc))
    ground_col = _vec((0.3, 0.25, 0.2), v) * (SUN_INTENSITY / math.pi) \
        * torch.clamp(mu_sun, 0.0, 1.0) * sun_transmittance(
            torch.zeros_like(mu_v), mu_sun.expand(mu_v.shape))
    lum = torch.where(hits_ground[..., None], ground_col * torch.exp(-tau_acc) + lum,
                      lum)
    sun_vis = ~hits_ground & (cos_sun > 0.99955)
    sun_t = sun_transmittance(torch.full_like(mu_v, h0), mu_sun.expand(mu_v.shape))
    return torch.where(sun_vis[..., None], SUN_INTENSITY * 80.0 * sun_t + lum, lum)


def aerial_perspective(view_depth_km: Tensor, view_dir: Tensor,
                       sun_dir_to_light: Tensor, camera_height_km: float = 0.2
                       ) -> Tuple[Tensor, Tensor]:
    """(transmittance (..., 3), in-scatter (..., 3)) along the view ray up
    to the surface: 4-step analytic single scattering. CUDA tensors launch
    the aerial-perspective kernel (`aerial_perspective_cuda`), CPU tensors
    take `aerial_perspective_plain`."""
    fn = on_device("aerial_perspective", view_dir, aerial_perspective_cuda,
                   aerial_perspective_plain, counter="atmosphere")
    return fn(view_depth_km, view_dir, sun_dir_to_light, camera_height_km)


def aerial_perspective_plain(view_depth_km: Tensor, view_dir: Tensor,
                             sun_dir_to_light: Tensor, camera_height_km: float = 0.2
                             ) -> Tuple[Tensor, Tensor]:
    """`aerial_perspective` in PyTorch ops, on any device."""
    v = m3.normalize(view_dir)
    l = m3.normalize(sun_dir_to_light)
    mu_v = v[..., 1]
    mu_sun = l[..., 1]
    cos_sun = m3.dot(v, l)
    ph_r = _phase_rayleigh(cos_sun)[..., None]
    ph_m = _phase_mie(cos_sun)[..., None]
    beta_r = _vec(BETA_RAYLEIGH, v)
    steps = 4
    dt = view_depth_km / steps
    lum = torch.zeros(v.shape[:-1] + (3,), device=v.device)
    tau = torch.zeros(v.shape[:-1] + (3,), device=v.device)
    for i in range(steps):
        t = (i + 0.5) * dt
        y = torch.clamp(camera_height_km + t * mu_v, min=0.0)
        dens_r = torch.exp(-y / H_RAYLEIGH)[..., None]
        dens_m = torch.exp(-y / H_MIE)[..., None]
        step_tau = (beta_r * dens_r + (BETA_MIE_SCAT + BETA_MIE_ABS) * dens_m) \
            * dt[..., None]
        t_view = torch.exp(-(tau + 0.5 * step_tau))
        t_sun = sun_transmittance(y, mu_sun.expand(y.shape))
        scat = beta_r * dens_r * ph_r + BETA_MIE_SCAT * dens_m * ph_m
        lum = lum + SUN_INTENSITY * scat * t_sun * t_view * dt[..., None]
        tau = tau + step_tau
    return torch.exp(-tau), lum


# -- the kernels (csrc/atmosphere.cu) -------------------------------------------

def sky_radiance_cuda(view_dir: Tensor, sun_dir_to_light: Tensor,
                      camera_height_km: float = 0.2, steps: int = 12) -> Tensor:
    """Launch the sky (csrc/atmosphere.cu: sky_radiance_launch); the inputs
    and output of `sky_radiance_plain`, in its bits. The rays are a
    contiguous (..., 3) float32 tensor on a card, the sun (3,) beside them."""
    shape, n = check_rays(view_dir, "view_dir", "sky_radiance")
    dev = view_dir.device
    check("sun_dir_to_light", sun_dir_to_light, torch.float32, (3,), dev, "sky_radiance")
    out = torch.empty((*shape, 3), device=dev)
    r0 = R_GROUND + camera_height_km
    launch("sky_radiance", dev, ptr(view_dir), ptr(sun_dir_to_light), n,
           f32(camera_height_km), f32(r0), f32(r0 * r0), f32(2.0 * r0),
           f32(R_TOP * R_TOP - r0 * r0), f32(R_GROUND * R_GROUND - r0 * r0), recip(steps),
           steps, ptr(out))
    return out


def aerial_perspective_cuda(view_depth_km: Tensor, view_dir: Tensor,
                            sun_dir_to_light: Tensor, camera_height_km: float = 0.2
                            ) -> Tuple[Tensor, Tensor]:
    """Launch the aerial perspective (csrc/atmosphere.cu:
    aerial_perspective_launch); the inputs and outputs of
    `aerial_perspective_plain`, in its bits. The rays are a contiguous
    (..., 3) float32 tensor on a card, the depths (...) and the sun (3,)
    beside them."""
    shape, n = check_rays(view_dir, "view_dir", "aerial_perspective")
    dev = view_dir.device
    check("view_depth_km", view_depth_km, torch.float32, shape, dev, "aerial_perspective")
    check("sun_dir_to_light", sun_dir_to_light, torch.float32, (3,), dev,
          "aerial_perspective")
    trans = torch.empty((*shape, 3), device=dev)
    inscatter = torch.empty((*shape, 3), device=dev)
    steps = 4
    launch("aerial_perspective", dev, ptr(view_depth_km), ptr(view_dir),
           ptr(sun_dir_to_light), n, f32(camera_height_km), recip(steps), steps, ptr(trans),
           ptr(inscatter))
    return trans, inscatter


# -- spherical-harmonics ambient ---------------------------------------------


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta), np.cos(phi),
                     np.sin(phi) * np.sin(theta)], axis=-1).astype(np.float32)


_SH_DIRS = tuple(map(tuple, _fibonacci_sphere(128).tolist()))   # exact float32 values


def _sh_terms(d: Tensor) -> Tuple[Tensor, ...]:
    """The nine order-2 real SH basis functions of directions d (..., 3)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return (
        torch.full_like(x, 0.282095),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
    )


def _sh_basis(d: Tensor) -> Tensor:
    """Order-2 real SH basis (..., 9)."""
    return torch.stack(_sh_terms(d), dim=-1)


def sky_sh(sun_dir_to_light: Tensor, camera_height_km: float = 0.2) -> Tensor:
    """The sky projected into order-2 SH -> (9, 3) radiance coefficients."""
    dirs = m3.constant(_SH_DIRS, sun_dir_to_light.device)
    rad = sky_radiance(dirs, sun_dir_to_light, camera_height_km, steps=8)
    basis = _sh_basis(dirs)
    return torch.einsum("sb,sc->bc", basis, rad) * (4.0 * math.pi / dirs.shape[0])


def sh_irradiance(normal: Tensor, sh: Tensor) -> Tensor:
    """Diffuse irradiance (..., 3) from SH coefficients: the clamped-cosine
    convolution, as an unrolled 9-term sum (no (..., 9) basis stack)."""
    a = (3.141593, 2.094395, 2.094395, 2.094395,
         0.785398, 0.785398, 0.785398, 0.785398, 0.785398)
    terms = _sh_terms(normal)
    out = torch.zeros(normal.shape[:-1] + (3,), dtype=normal.dtype,
                      device=normal.device)
    for i in range(9):
        out = out + (terms[i] * a[i])[..., None] * sh[i]
    return torch.clamp(out / math.pi, min=0.0)
