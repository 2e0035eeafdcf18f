"""The port's noise and cloud modules (`ops/noise.py`, `render/clouds.py`)
against `garden_tpu.ops.noise` and `garden_tpu.render.clouds`, run eagerly
on both sides (a jitted reference would contract multiply-adds into FMAs,
and jitting the cloud march takes minutes to compile).

Tolerances. The hash equals the reference's uint32 in every bit on random
and edge int32 coordinates (0, +-1, +-2^24, INT32_MIN, INT32_MAX). Every
noise value is a discrete lattice decision (a floor) followed by float
math; XLA's and PyTorch's sqrt, exp and division by a constant round some
results another way by an ulp, and an ulp near a lattice edge flips the
floor. So each function is held to 1e-5 on >= 99.9% of its samples
(measured: perlin2, perlin3, value2, fbm and ridged over Perlin,
turbulence, the domain warp and the terrain equal in every bit; worley3
max |d| 6.0e-8, perlin_worley3 1.0e-7, fbm over worley3 6.0e-8, every
sample within the bar); the clouds, whose march sums density evaluations
through exp, to 1e-4 on >= 99.5% of rays (measured: every ray; max |d|
alpha 1.1e-5, rgb 2.8e-5, the composite 1.5e-5); the density within 1e-5
(measured 6.0e-8) and the cloud shadow within 1e-5 (measured 3.8e-6), on
>= 99.9% of samples.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.ops import noise as jn
from garden_tpu.render import clouds as jc
from garden_tpu_torch.ops import noise as tn
from garden_tpu_torch.render import clouds as tc

RNG = np.random.default_rng(7)
EDGES = np.array([0, 1, -1, 2, -2, 2 ** 24, -2 ** 24, 2 ** 31 - 1, -2 ** 31,
                  2 ** 31 - 2, -2 ** 31 + 1, 12345, -98765], np.int64).astype(np.int32)


def _share_close(j, t, tol, share):
    """>= `share` of the samples within `tol`; the shares and the largest
    difference are in the assertion message."""
    j = np.asarray(j, np.float32)
    t = t.numpy()
    assert j.shape == t.shape and np.isfinite(t).all()
    d = np.abs(j - t)
    ok = (d <= tol).mean()
    assert ok >= share, f"{ok:.5f} of samples within {tol}; max |d| {d.max():.3g}"
    return d.max()


@pytest.mark.parametrize("seed", [0, 3, 123457])
def test_hash_matches_in_every_bit(seed):
    n = 20000
    rand = RNG.integers(-2 ** 31, 2 ** 31, (3, n), dtype=np.int64).astype(np.int32)
    edge = np.stack(np.meshgrid(EDGES, EDGES, EDGES, indexing="ij")).reshape(3, -1)
    for ix, iy, iz in (rand, edge):
        for three in (False, True):
            zj = jnp.asarray(iz) if three else None
            zt = torch.tensor(iz) if three else None
            j = np.asarray(jn._hash(jnp.asarray(ix), jnp.asarray(iy), zj, seed))
            t = tn._hash(torch.tensor(ix), torch.tensor(iy), zt, seed)
            assert t.dtype == torch.int64 and int(t.min()) >= 0 and int(t.max()) < 2 ** 32
            np.testing.assert_array_equal(j.astype(np.int64), t.numpy())


def _coords(n=3, shape=(48, 40), scale=40.0):
    """Coordinates over negative and positive lattice cells, plus exact
    lattice points."""
    c = RNG.uniform(-scale, scale, (n,) + shape).astype(np.float32)
    c[:, :4] = np.round(c[:, :4])
    return c


BASES = {"perlin2": 2, "perlin3": 3, "value2": 2, "worley3": 3, "perlin_worley3": 3}


@pytest.mark.parametrize("name", sorted(BASES))
def test_base_noise_matches(name):
    c = _coords()[:BASES[name]]
    j = getattr(jn, name)(*map(jnp.asarray, c), seed=11)
    t = getattr(tn, name)(*map(torch.tensor, c), seed=11)
    _share_close(j, t, 1e-5, 0.999)


@pytest.mark.parametrize("combinator,base,kw", [
    ("fbm", "perlin2", dict(octaves=5)),
    ("fbm", "worley3", dict(octaves=2, lacunarity=3.0, gain=0.4)),
    ("ridged", "perlin3", dict(octaves=4)),
    ("turbulence", "value2", dict(octaves=4)),
])
def test_fractals_match(combinator, base, kw):
    c = _coords(shape=(24, 20), scale=8.0)[:BASES[base]]
    j = getattr(jn, combinator)(getattr(jn, base), *map(jnp.asarray, c), seed=5, **kw)
    t = getattr(tn, combinator)(getattr(tn, base), *map(torch.tensor, c), seed=5, **kw)
    _share_close(j, t, 1e-5, 0.999)


def test_domain_warp_and_terrain_match():
    c = _coords(2, (32, 32), 6.0)
    jx, jy = jn.domain_warp2(*map(jnp.asarray, c), strength=0.8, seed=2)
    tx, ty = tn.domain_warp2(*map(torch.tensor, c), strength=0.8, seed=2)
    _share_close(jx, tx, 1e-5, 0.999)
    _share_close(jy, ty, 1e-5, 0.999)
    j = jn.terrain_heightmap(24, seed=4)
    t = tn.terrain_heightmap(24, seed=4, device="cpu")
    assert t.shape == (24, 24) and float(t.std()) > 0.0
    _share_close(j, t, 1e-4, 0.999)       # heights are scaled by 8


def _sky_rays(n):
    """Directions over the whole sphere, most above the horizon."""
    d = RNG.normal(size=(n, n, 3)).astype(np.float32)
    d[..., 1] = np.abs(d[..., 1]) * 1.5 - 0.2
    return d


SUN = np.array([0.4, 0.7, 0.5], np.float32)


def test_cloud_density_matches():
    p = RNG.uniform(-3000, 3000, (40, 40, 3)).astype(np.float32)
    p[..., 1] = RNG.uniform(1200, 2400, (40, 40))
    time = np.float32(3.5)
    for cov in (0.45, 0.8):
        j = jc._density(jnp.asarray(p), jnp.asarray(time), cov, 2)
        t = tc._density(torch.tensor(p), torch.tensor(time), cov, 2)
        _share_close(j, t, 1e-5, 0.999)
        assert 0.0 < float(t.max()) <= 1.0


def test_render_clouds_matches():
    """Four march steps (the loop body is the same at every step; the
    default ten take ~10 s in the eager reference) and the composite."""
    rays = _sky_rays(16)
    time = np.float32(2.0)
    jrgb, ja = jc.render_clouds(jnp.asarray(rays), jnp.asarray(SUN),
                                time=jnp.asarray(time), steps=4, coverage=0.6)
    trgb, ta = tc.render_clouds(torch.tensor(rays), torch.tensor(SUN),
                                time=torch.tensor(time), steps=4, coverage=0.6)
    _share_close(ja, ta, 1e-4, 0.995)
    _share_close(jrgb, trgb, 1e-4, 0.995)
    assert float(ta.max()) > 0.05 and float(ta.min()) == 0.0
    sky = RNG.uniform(0, 2, (16, 16, 3)).astype(np.float32)
    _share_close(jc.composite_clouds(jnp.asarray(sky), jrgb, ja),
                 tc.composite_clouds(torch.tensor(sky), trgb, ta), 1e-4, 0.995)


def test_cloud_shadow_matches():
    pos = RNG.uniform(-40, 40, (24, 24, 3)).astype(np.float32)
    pos[..., 1] = RNG.uniform(0, 5, (24, 24))
    j = jc.cloud_shadow(jnp.asarray(pos), jnp.asarray(SUN), time=jnp.asarray(1.0),
                        coverage=0.7)
    t = tc.cloud_shadow(torch.tensor(pos), torch.tensor(SUN),
                        time=torch.tensor(1.0), coverage=0.7)
    _share_close(j, t, 1e-5, 0.999)
    assert float(t.min()) < 1.0
