"""Parity of the port's screen-space and shading passes with the JAX
package: HBAO (full and half res), the atmosphere's frame path (sky
radiance, aerial perspective, SH projection and irradiance), the
environment BRDF, the full lighting resolve, bloom, FXAA, and the
G-buffer's world positions at 256x128.

Tolerances: HBAO within 1e-5; the atmosphere, the environment BRDF and the
lighting resolve to rtol 1e-5 (the transcendental functions of the two
libraries may differ by an ulp); bloom and FXAA within 1e-5 in float32
(the frame runs bloom in bf16, where the two libraries round at other
steps, so the module is compared in f32); positions to rtol 1e-5.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import math3d as jm3
from garden_tpu.render import atmosphere as jatm
from garden_tpu.render import bloom as jbloom
from garden_tpu.render import fxaa as jfxaa
from garden_tpu.render import gbuffer as jgb
from garden_tpu.render import hbao as jhbao
from garden_tpu.render import ibl as jibl
from garden_tpu.render import lighting as jlt
from garden_tpu.systems import camera as jcam
from garden_tpu_torch.convert import from_jax
from garden_tpu_torch.render import atmosphere as tatm
from garden_tpu_torch.render import bloom as tbloom
from garden_tpu_torch.render import fxaa as tfxaa
from garden_tpu_torch.render import gbuffer as tgb
from garden_tpu_torch.render import hbao as thbao
from garden_tpu_torch.render import ibl as tibl
from garden_tpu_torch.render import lighting as tlt

RNG = np.random.default_rng(17)

# the reference runs jitted, as in the frame (one compile per function
# instead of one per op); XLA may then contract products into FMAs, which
# the bars absorb
_j_hbao = jax.jit(jhbao.compute_hbao, static_argnames=("half_res",))
_j_sky = jax.jit(jatm.sky_radiance, static_argnames=("steps",))
_j_bloom = jax.jit(jbloom.apply_bloom, static_argnums=(1,))
_j_resolve = jax.jit(jlt.resolve)
_j_sh = jax.jit(jatm.sky_sh)
_j_aerial = jax.jit(jatm.aerial_perspective)


def _close(j, t, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(j), t.detach().float().numpy(),
                               rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _heightfield(h=50, w=66):
    """World positions and normals of a bumpy ground seen from above, with
    a hole of empty pixels; the camera sits above it."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    x, z = u * 0.05, v * 0.05
    y = 0.25 * np.sin(x * 3.0) * np.cos(z * 2.0) + 0.4 * (np.abs(x - 1.6) < 0.2)
    pos = np.stack([x, y, z], -1).astype(np.float32)
    gy, gx = np.gradient(y, 0.05)
    nrm = np.stack([-gx, np.ones_like(y), -gy], -1)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    vis = np.ones((h, w), bool)
    vis[5:12, 40:52] = False
    pos[~vis] = 0.0
    return pos, nrm, vis, np.array([1.5, 3.0, -1.0], np.float32)


@pytest.mark.parametrize("half", [False, True], ids=["full", "half"])
def test_hbao_matches(half):
    pos, nrm, vis, cam = _heightfield()
    j = _j_hbao(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(vis),
                           jnp.asarray(cam), half_res=half)
    t = thbao.compute_hbao(_t(pos), _t(nrm), _t(vis), _t(cam), half_res=half)
    _close(j, t, rtol=0)
    assert (t < 0.95).float().mean() > 0.02 and bool((t[~_t(vis)] == 1).all())


def _dirs(n):
    d = RNG.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d


SUN = np.array([0.4, 0.7, 0.5], np.float32)


@pytest.mark.parametrize("steps", [12, 4])
def test_sky_radiance_matches(steps):
    """Up, down (ground hits) and grazing rays, and the sun disk. rtol 2e-4:
    the sample altitude sqrt(r0^2 + t^2 + 2 r0 t mu) - R_GROUND cancels in
    float32 (ulp(6360 km) = 5e-4 km), and exp(-y / 1.2 km) turns an ulp of
    difference upstream into up to 1e-4 relative (measured 6e-5 on upward
    rays, 1.3e-4 on a 2e-4 radiance with the sun below the horizon)."""
    d = np.concatenate([_dirs(400), SUN[None] / np.linalg.norm(SUN),
                        np.array([[1.0, -1e-3, 0.0]], np.float32)])
    for sun in (SUN, np.array([0.3, -0.1, 0.9], np.float32)):
        _close(_j_sky(jnp.asarray(d), jnp.asarray(sun), steps=steps),
               tatm.sky_radiance(_t(d), _t(sun), steps=steps), rtol=2e-4, atol=1e-6)


def test_aerial_perspective_matches():
    d = _dirs(300)
    km = RNG.uniform(0.0, 3.0, 300).astype(np.float32)
    jt, ji = _j_aerial(jnp.asarray(km), jnp.asarray(d), jnp.asarray(SUN))
    tt, ti = tatm.aerial_perspective(_t(km), _t(d), _t(SUN))
    _close(jt, tt)
    _close(ji, ti)


def test_sky_sh_and_irradiance_match():
    jsh = _j_sh(jnp.asarray(SUN))
    tsh = tatm.sky_sh(_t(SUN))
    _close(jsh, tsh)
    n = _dirs(500)
    _close(jatm.sh_irradiance(jnp.asarray(n), jsh), tatm.sh_irradiance(_t(n), tsh))


def test_specular_env_brdf_matches():
    f0 = RNG.uniform(0.02, 1.0, (40, 3)).astype(np.float32)
    nov = RNG.uniform(1e-4, 1.0, 40).astype(np.float32)
    rough = RNG.uniform(0.0, 1.0, 40).astype(np.float32)
    _close(jibl.specular_env_brdf(jnp.asarray(f0), jnp.asarray(nov), jnp.asarray(rough)),
           tibl.specular_env_brdf(_t(f0), _t(nov), _t(rough)))


def _constants(w, h):
    eye = jnp.array([0.0, 6.0, 10.0])
    view = jm3.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    proj = jm3.perspective_reverse_z(1.0, w / h, 0.1)
    j = jcam.common_constants(eye, view, proj, jnp.array([0.4, -0.7, -0.5]),
                              (w, h), 0.0, 1.0 / 60.0)
    return j, from_jax({k: np.asarray(v) for k, v in j.items()}, "cpu")


def _gbuffers(h, w):
    g = RNG.uniform(-1, 1, (18, h, w)).astype(np.float32)
    tri = RNG.integers(-1, 5, (h, w)).astype(np.int32)
    depth = RNG.uniform(0.01, 1.0, (h, w)).astype(np.float32)
    g[:, tri < 0] = 0.0
    g[0:3] /= np.linalg.norm(g[0:3], axis=0, keepdims=True) + 1e-12
    g[5:14] = np.abs(g[5:14])
    jc, tc = _constants(w, h)
    vis = {"tri_id": tri, "depth": depth}
    jg = jgb.shade_gbuffer({k: jnp.asarray(v) for k, v in vis.items()}, None, {},
                           None, None, constants=jc, gplanes=jnp.asarray(g))
    tg = tgb.shade_gbuffer({k: _t(v) for k, v in vis.items()}, None, None, None, None,
                           constants=tc, gplanes=_t(g))
    return jg, tg, jc, tc


def test_gbuffer_positions_match_at_256x128():
    jg, tg, _, _ = _gbuffers(128, 256)
    _close(jg["position"], tg["position"], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jg["visible"]), tg["visible"].numpy())


def test_lighting_resolve_with_all_inputs_matches():
    h, w = 32, 48
    jg, tg, jc, tc = _gbuffers(h, w)
    shadow = RNG.uniform(0, 1, (h, w, 1)).astype(np.float32)
    ao = RNG.uniform(0.5, 1, (h, w)).astype(np.float32)
    sky = RNG.uniform(0, 2, (h, w, 3)).astype(np.float32)
    spec = RNG.uniform(0, 2, (h, w, 3)).astype(np.float32)
    jsh = _j_sh(jnp.asarray(SUN))
    j = _j_resolve(jg, jc, shadow=jnp.asarray(shadow), ao=jnp.asarray(ao),
                    ambient_sh=jsh, sky=jnp.asarray(sky),
                    specular_ambient=jnp.asarray(spec))
    t = tlt.resolve(tg, tc, shadow=_t(shadow), ao=_t(ao),
                    ambient_sh=_t(np.asarray(jsh)), sky=_t(sky),
                    specular_ambient=_t(spec))
    _close(j, t, atol=1e-4)     # GGX's 1/f^2 amplifies n.h rounding (as test_brdf)
    j2 = _j_resolve(jg, jc, shadow=jnp.asarray(shadow[..., 0]))
    t2 = tlt.resolve(tg, tc, shadow=_t(shadow[..., 0]))
    _close(j2, t2, atol=1e-4)
    # the SSR and SSGI inputs (their other combinations are in
    # tests/test_torch_screen_space.py)
    refl = RNG.uniform(0, 2, (h, w, 3)).astype(np.float32)
    conf = RNG.uniform(0, 1, (h, w)).astype(np.float32)
    j3 = _j_resolve(jg, jc, shadow=jnp.asarray(shadow), ao=jnp.asarray(ao),
                    ambient_sh=jsh, sky=jnp.asarray(sky), specular_ambient=jnp.asarray(spec),
                    reflection=jnp.asarray(refl), reflection_conf=jnp.asarray(conf),
                    gi=jnp.asarray(spec))
    t3 = tlt.resolve(tg, tc, shadow=_t(shadow), ao=_t(ao), ambient_sh=_t(np.asarray(jsh)),
                     sky=_t(sky), specular_ambient=_t(spec), reflection=_t(refl),
                     reflection_conf=_t(conf), gi=_t(spec))
    _close(j3, t3, atol=1e-4)


@pytest.mark.parametrize("shape", [(67, 90, 3), (64, 96, 3)], ids=["odd", "even"])
def test_bloom_matches_in_f32(shape):
    hdr = np.exp(RNG.normal(-1.0, 1.5, shape)).astype(np.float32)
    _close(_j_bloom(jnp.asarray(hdr), 5), tbloom.apply_bloom(_t(hdr), 5))


def test_bloom_runs_in_bf16():
    hdr = np.exp(RNG.normal(-1.0, 1.5, (40, 52, 3))).astype(np.float32)
    out = tbloom.apply_bloom(_t(hdr).to(torch.bfloat16), 5)
    assert out.dtype == torch.bfloat16
    ref = _j_bloom(jnp.asarray(hdr), 5)
    _close(ref, out, rtol=2e-2, atol=2e-2)     # bf16 keeps 8 bits


def _staircase(h=64, w=64):
    yy, xx = np.mgrid[0:h, 0:w]
    img = ((yy + 0.5) > (xx + 0.5) / 8.0 + 16.0).astype(np.float32)
    return np.repeat(img[..., None], 3, axis=-1)


@pytest.mark.parametrize("kind", ["random", "staircase"])
def test_fxaa_matches(kind):
    """On random colours and on the shallow staircase of
    test_fxaa311_beats_lowpass_on_shallow_staircase."""
    img = (RNG.uniform(0, 1, (48, 64, 3)).astype(np.float32) if kind == "random"
           else _staircase())
    j = jfxaa.apply_fxaa(jnp.asarray(img))   # eager: jitted, FMAs flip edges
    t = tfxaa.apply_fxaa(_t(img))
    _close(j, t, rtol=0)
    assert (t - _t(img)).abs().max() > 0.05
