"""Procedural noise: hash-based gradient, value and cellular noise, and the
fractal combinators over them.

Port of `garden_tpu.ops.noise`. The integer avalanche hash computes each
lattice point's gradient on the fly (no permutation table). The reference
hashes in uint32; PyTorch's uint32 tensors lack shifts and remainders, so
here a hash value is an int64 holding the same 32 bits: lattice products
are exact in int64 (|coordinate| x prime < 2^63) and their low 32 bits
are the uint32 products, XOR keeps low bits, and one mask brings the sum
back to [0, 2^32). The multiply by 0x85EBCA77 (> 2^31) is split in 16-bit
halves so that no int64 product overflows. Every function returns the
reference's bits for the same inputs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor

_PRIME_X = 501125321
_PRIME_Y = 1136930381
_PRIME_Z = 1720413743
_M32 = 0xFFFFFFFF


def _seed_word(seed: int) -> int:
    return (seed * 0x9E3779B9 + 0x85EBCA6B) & _M32


def _lattice(i: Tensor, prime: int) -> Tensor:
    """i * prime in int64: its low 32 bits are uint32(i) * prime's."""
    return i.long() * prime


def _avalanche(h: Tensor) -> Tensor:
    """The hash's mixing rounds on h (any int64 whose low 32 bits are the
    word) -> the uint32 result in [0, 2^32)."""
    h = ((h & _M32) * 0x27D4EB2F) & _M32
    h = h ^ (h >> 15)
    h = (h * 0xCA77 + (((h * 0x85EB) & 0xFFFF) << 16)) & _M32   # h * 0x85EBCA77
    return h ^ (h >> 13)


def _hash(ix: Tensor, iy: Tensor, iz: Optional[Tensor] = None, seed: int = 0) -> Tensor:
    """Integer avalanche hash of int32 (or int64) lattice coordinates ->
    int64 in [0, 2^32), the reference's uint32 value."""
    h = _seed_word(seed) ^ _lattice(ix, _PRIME_X) ^ _lattice(iy, _PRIME_Y)
    if iz is not None:
        h = h ^ _lattice(iz, _PRIME_Z)
    return _avalanche(h)


def _grad2(h: Tensor, fx: Tensor, fy: Tensor) -> Tensor:
    """Gradient dot product from 8 fixed 2D directions."""
    g = (h >> 3) & 7
    even = (g & 1) == 0
    gx = torch.where(g < 4, torch.where(even, 1.0, -1.0),
                     torch.where(even, 0.70710678, -0.70710678))
    gy = torch.where(g < 4, torch.where(g < 2, 1.0, -1.0),
                     torch.where(g < 6, 0.70710678, -0.70710678))
    return gx * fx + gy * fy


def _grad3(h: Tensor, fx: Tensor, fy: Tensor, fz: Tensor) -> Tensor:
    """Gradient dot product from the 12 edge directions of a cube. The
    (g == 12) | (g == 14) branch cannot be taken (g < 12); it is the
    reference's."""
    g = (h >> 3) % 12
    u = torch.where(g < 8, fx, fy)
    v = torch.where(g < 4, fy, torch.where((g == 12) | (g == 14), fx, fz))
    su = torch.where((g & 1) == 0, u, -u)
    sv = torch.where((g & 2) == 0, v, -v)
    return su + sv


def _fade(t: Tensor) -> Tensor:
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin2(x: Tensor, y: Tensor, seed: int = 0) -> Tensor:
    """2D gradient noise in ~[-1, 1]."""
    ix = torch.floor(x).int()
    iy = torch.floor(y).int()
    fx = x - ix
    fy = y - iy
    u = _fade(fx)
    v = _fade(fy)
    hx = [_seed_word(seed) ^ _lattice(ix + o, _PRIME_X) for o in (0, 1)]
    hy = [_lattice(iy + o, _PRIME_Y) for o in (0, 1)]

    def corner(ox, oy):
        return _grad2(_avalanche(hx[ox] ^ hy[oy]), fx - ox, fy - oy)

    n00 = corner(0, 0)
    n10 = corner(1, 0)
    n01 = corner(0, 1)
    n11 = corner(1, 1)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return (nx0 + v * (nx1 - nx0)) * 1.4142135


def perlin3(x: Tensor, y: Tensor, z: Tensor, seed: int = 0) -> Tensor:
    """3D gradient noise in ~[-1, 1]."""
    ix = torch.floor(x).int()
    iy = torch.floor(y).int()
    iz = torch.floor(z).int()
    fx = x - ix
    fy = y - iy
    fz = z - iz
    u, v, w = _fade(fx), _fade(fy), _fade(fz)
    hx = [_seed_word(seed) ^ _lattice(ix + o, _PRIME_X) for o in (0, 1)]
    hy = [_lattice(iy + o, _PRIME_Y) for o in (0, 1)]
    hz = [_lattice(iz + o, _PRIME_Z) for o in (0, 1)]

    def corner(ox, oy, oz):
        h = _avalanche(hx[ox] ^ hy[oy] ^ hz[oz])
        return _grad3(h, fx - ox, fy - oy, fz - oz)

    n000 = corner(0, 0, 0)
    n100 = corner(1, 0, 0)
    n010 = corner(0, 1, 0)
    n110 = corner(1, 1, 0)
    n001 = corner(0, 0, 1)
    n101 = corner(1, 0, 1)
    n011 = corner(0, 1, 1)
    n111 = corner(1, 1, 1)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return (nxy0 + w * (nxy1 - nxy0)) * 1.1547


def value2(x: Tensor, y: Tensor, seed: int = 0) -> Tensor:
    """2D value noise in [-1, 1]."""
    ix = torch.floor(x).int()
    iy = torch.floor(y).int()
    fx = _fade(x - ix)
    fy = _fade(y - iy)

    def corner(ox, oy):
        # the unsigned hash as float32, as the reference's uint32 cast
        return _hash(ix + ox, iy + oy, seed=seed).float() / 2147483648.0 - 1.0

    n00, n10 = corner(0, 0), corner(1, 0)
    n01, n11 = corner(0, 1), corner(1, 1)
    nx0 = n00 + fx * (n10 - n00)
    nx1 = n01 + fx * (n11 - n01)
    return nx0 + fy * (nx1 - nx0)


def worley3(x: Tensor, y: Tensor, z: Tensor, seed: int = 0) -> Tensor:
    """3D Worley (cellular) noise: the distance to the nearest jittered
    feature point over the 27 neighbouring cells, in [0, 1]."""
    ix = torch.floor(x)
    iy = torch.floor(y)
    iz = torch.floor(z)
    fx = x - ix
    fy = y - iy
    fz = z - iz
    hx = {o: _seed_word(seed) ^ _lattice((ix + o).int(), _PRIME_X) for o in (-1, 0, 1)}
    hy = {o: _lattice((iy + o).int(), _PRIME_Y) for o in (-1, 0, 1)}
    hz = {o: _lattice((iz + o).int(), _PRIME_Z) for o in (-1, 0, 1)}
    best = torch.full(x.shape, 8.0, device=x.device)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                h = _avalanche(hx[ox] ^ hy[oy] ^ hz[oz])
                jx = (h & 0x3FF).float() / 1023.0
                jy = ((h >> 10) & 0x3FF).float() / 1023.0
                jz = ((h >> 20) & 0x3FF).float() / 1023.0
                dx = ox + jx - fx
                dy = oy + jy - fy
                dz = oz + jz - fz
                best = torch.minimum(best, dx * dx + dy * dy + dz * dz)
    return torch.clamp(torch.sqrt(best), max=1.0)


def perlin_worley3(x: Tensor, y: Tensor, z: Tensor, seed: int = 0) -> Tensor:
    """The cloud-base noise: Perlin remapped by inverted Worley."""
    p = perlin3(x, y, z, seed=seed) * 0.5 + 0.5
    w = 1.0 - worley3(x, y, z, seed=seed + 31)
    return torch.clamp((p - (1.0 - w)) / torch.clamp(w, min=1e-3), 0.0, 1.0)


def fbm(noise_fn: Callable, *coords: Tensor, octaves: int = 5,
        lacunarity: float = 2.0, gain: float = 0.5, seed: int = 0) -> Tensor:
    """Fractal Brownian motion over any base noise."""
    amp = 1.0
    freq = 1.0
    total = torch.zeros_like(coords[0])
    norm = 0.0
    for o in range(octaves):
        total = total + amp * noise_fn(*[c * freq for c in coords], seed=seed + o)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm


def ridged(noise_fn: Callable, *coords: Tensor, octaves: int = 5,
           lacunarity: float = 2.0, gain: float = 0.5, seed: int = 0) -> Tensor:
    """Ridged multifractal."""
    amp = 1.0
    freq = 1.0
    total = torch.zeros_like(coords[0])
    norm = 0.0
    for o in range(octaves):
        n = 1.0 - torch.abs(noise_fn(*[c * freq for c in coords], seed=seed + o))
        total = total + amp * (n * 2.0 - 1.0)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm


def turbulence(noise_fn: Callable, *coords: Tensor, octaves: int = 4,
               seed: int = 0) -> Tensor:
    """Sum of |noise| octaves in [0, 1]."""
    amp = 1.0
    freq = 1.0
    total = torch.zeros_like(coords[0])
    norm = 0.0
    for o in range(octaves):
        total = total + amp * torch.abs(noise_fn(*[c * freq for c in coords],
                                                 seed=seed + o))
        norm += amp
        amp *= 0.5
        freq *= 2.0
    return total / norm


def domain_warp2(x: Tensor, y: Tensor, strength: float = 1.0, seed: int = 0) -> tuple:
    """Domain warping: both coordinates displaced by Perlin noise."""
    wx = perlin2(x, y, seed=seed + 101) * strength
    wy = perlin2(x, y, seed=seed + 313) * strength
    return x + wx, y + wy


def terrain_heightmap(size: int, world_scale: float = 0.02, height_scale: float = 8.0,
                      seed: int = 0, *, device) -> Tensor:
    """Procedural terrain heights (size, size) on `device`: warped fBm
    blended with a ridged multifractal."""
    xs = torch.arange(size, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    x, y = domain_warp2(gx * world_scale, gy * world_scale, 0.6, seed)
    base = fbm(perlin2, x, y, octaves=6, seed=seed)
    ridge = ridged(perlin2, x * 0.5, y * 0.5, octaves=4, seed=seed + 7)
    return (base * 0.7 + ridge * 0.3) * height_scale
