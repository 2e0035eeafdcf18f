"""The port's screen-space and temporal passes against the JAX package: SSR
(`ssr.trace`) at trace_step 1, 2 and 4, SSGI (`ssgi.compute_ssgi`) at half
and full resolution, the lighting resolve's SSR and SSGI inputs with and
without SH, the Hi-Z pyramid at odd sizes and the occlusion cull, SMAA on
the reference's staircases, velocity and disocclusion through
`DeferredRenderer.render(prev_inst_matrices=)` at an odd frame height, the
nearest and linear resizes of the disocclusion mask and of render_scale,
and the five quality presets rendering on the port.

The SSR and SSGI inputs are one frame of a glossy floor with boxes,
rendered by the port; both sides run on the same G-buffer. The reference
functions run jitted (one compile each instead of one per op and shape),
so XLA may contract products into FMAs, which the bars absorb; all but
SSGI, whose reprojection floors the FMAs move on 1% of the half-res
pixels (max |d| 0.078), so it runs eagerly.

Tolerances. SSR decides each ray's first hit and SSGI each reprojected
texel by a comparison or a floor of float math whose products another
library may round by an ulp (einsum order, division); so both are held to
1e-4 on >= 99.5% of pixels (measured: every pixel; SSR max |d| 1.2e-6,
1.1e-6 and 8.3e-7 at trace_step 1, 2 and 4; SSGI 2.1e-7 half, 1.2e-7
full). The resolve to rtol 1e-5 and atol 1e-4, as the flagship's resolve
test (measured 4.1e-5 with SH, 6.6e-7 without), on random materials of
roughness >= 0.2 (nearer 0 the GGX term's 1/f^2 amplifies the libraries'
rsqrt ulps past that: 1.8e-4 relative at 0.05, in the direct light, which
SSR and SSGI do not touch). The pyramid is a min, equal in every bit; the
cull's verdicts equal on the reference's occluder scene and on >= 99% of
random boxes (measured 100%). SMAA within 1e-5 (measured: the staircases
and the flat image equal in every bit, random colours 1.2e-7). The
velocity within 1e-3 px where both rasters pick the same triangle
(measured 7.3e-5), the disocclusion mask equal on >= 99.5% of pixels
(measured 99.6%: its samples compare a reprojected depth with a 10%
threshold and floor the velocity-moved position, both discrete). The resizes equal jax.image.resize: nearest in every
index, linear within 1e-6 (measured 1.2e-7).
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import math3d as jm3
from garden_tpu.core.config import RenderConfig as JRenderConfig
from garden_tpu.core.config import SSRConfig as JSSRConfig
from garden_tpu.render import deferred as jdef
from garden_tpu.render import hiz as jhiz
from garden_tpu.render import lighting as jlt
from garden_tpu.render import mesh as jmesh
from garden_tpu.render import smaa as jsmaa
from garden_tpu.render import ssgi as jssgi
from garden_tpu.render import ssr as jssr
from garden_tpu.systems import camera as jcam
from garden_tpu_torch.convert import from_jax
from garden_tpu_torch.core.config import (QUALITY_PRESETS, RenderConfig, SLICE_OVERRIDES,
                                          SSRConfig, render_quality)
from garden_tpu_torch.ops import blur as tblur
from garden_tpu_torch.render import deferred as tdef
from garden_tpu_torch.render import hiz as thiz
from garden_tpu_torch.render import lighting as tlt
from garden_tpu_torch.render import mesh as tmesh
from garden_tpu_torch.render import smaa as tsmaa
from garden_tpu_torch.render import ssgi as tssgi
from garden_tpu_torch.render import ssr as tssr

RNG = np.random.default_rng(23)
W, H = 128, 96
_j_ssr = jax.jit(jssr.trace, static_argnums=(5,))
_j_cull = jax.jit(jhiz.occlusion_cull, static_argnums=(4, 5))
_j_smaa = jax.jit(jsmaa.apply_smaa)


def _share(j, t, tol, share):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert j.shape == t.shape and np.isfinite(t).all()
    d = np.abs(j - t)
    if d.ndim == 3:
        d = d.max(-1)
    ok = (d <= tol).mean()
    assert ok >= share, f"{ok:.5f} within {tol}, max |d| {d.max():.3g}"


def _camera(w, h, eye=(0.0, 3.0, 8.0)):
    e = jnp.array(eye)
    view = jm3.look_at(e, jnp.array([0.0, 0.5, 0.0]), jnp.array([0.0, 1.0, 0.0]))
    proj = jm3.perspective_reverse_z(1.0, w / h, 0.1)
    j = jcam.common_constants(e, view, proj, jnp.array([0.4, -0.7, -0.5]), (w, h),
                              0.0, 1.0 / 60.0)
    return j, from_jax({k: np.asarray(v) for k, v in j.items()}, "cpu")


def _scene(mod, n_boxes=5):
    s = mod.SceneBuffers(2000, 2000, 8)
    floor = s.add_material(mod.Material(base_color=(0.6, 0.6, 0.6), roughness=0.05))
    box = s.add_material(mod.Material(base_color=(0.9, 0.2, 0.1), roughness=0.3,
                                      emissive=(0.5, 0.1, 0.0)))
    s.add_instance(mod.plane_grid(20.0, 4), material=floor)
    for _ in range(n_boxes):
        s.add_instance(mod.cube(0.5), material=box)
    return s


def _box_mats(xz, y=0.5, n=8):
    """(n, 4, 4) instance matrices: the floor, then a box at each (x, z)."""
    m = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i, (x, z) in enumerate(xz, start=1):
        m[i, :3, 3] = (x, y, z)
    return m


BOXES = [(-2.0, 0.0), (0.0, -1.0), (2.0, 0.5), (-0.8, 1.5), (1.2, -2.5)]


@pytest.fixture(scope="module")
def frame():
    """One port frame of the floor and boxes (the slice's pass set) at
    128x96: its G-buffer and depth, a previous HDR and the camera, as
    numpy and as the reference's inputs."""
    jc, tc = _camera(W, H)
    cfg = RenderConfig(width=W, height=H, max_triangles=2000, max_vertices=2000,
                       max_instances=8, **SLICE_OVERRIDES)
    ren = tdef.DeferredRenderer(cfg, _scene(tmesh), "cpu")
    out = ren.render(ren.device_scene(), torch.tensor(_box_mats(BOXES)), tc,
                     ren.initial_frame_state())
    g = out["gbuffer"]
    assert g["visible"].float().mean() > 0.5
    prev_hdr = RNG.uniform(0, 3, (H, W, 3)).astype(np.float32)
    return dict(tg=g, jg={k: jnp.asarray(v.numpy()) for k, v in g.items()},
                depth=out["depth"], prev=prev_hdr, jc=jc, tc=tc)


@pytest.mark.parametrize("trace_step", [1, 2, 4])
def test_ssr_matches_reference(frame, trace_step):
    cfg = dict(trace_step=trace_step, steps=16)
    j_rgb, j_conf = _j_ssr(frame["jg"], jnp.asarray(frame["depth"].numpy()),
                               jnp.asarray(frame["prev"]), frame["jc"]["view_proj"],
                               frame["jc"], JSSRConfig(**cfg))
    t_rgb, t_conf = tssr.trace(frame["tg"], frame["depth"], torch.tensor(frame["prev"]),
                               frame["tc"]["view_proj"], frame["tc"], SSRConfig(**cfg))
    assert t_rgb.shape == (H, W, 3) and t_conf.shape == (H, W)
    _share(j_conf, t_conf, 1e-4, 0.995)
    _share(j_rgb, t_rgb, 1e-4, 0.995)
    assert float(t_conf.max()) > 0.5           # the floor reflects the boxes
    assert (t_conf > 0).float().mean() > 0.01


@pytest.mark.parametrize("half_res", [True, False], ids=["half", "full"])
def test_ssgi_matches_reference(frame, half_res):
    g, jg = frame["tg"], frame["jg"]
    j = jssgi.compute_ssgi(jg["position"], jg["normal"], jg["visible"],
                           jnp.asarray(frame["depth"].numpy()), jnp.asarray(frame["prev"]),
                           frame["jc"]["view_proj"], intensity=1.3, half_res=half_res)
    t = tssgi.compute_ssgi(g["position"], g["normal"], g["visible"], frame["depth"],
                           torch.tensor(frame["prev"]), frame["tc"]["view_proj"],
                           intensity=1.3, half_res=half_res)
    assert t.shape == (H, W, 3)
    _share(j, t, 1e-4, 0.995)
    assert float(t.max()) > 0.01


def _random_gbuffer(h, w):
    """A G-buffer of random materials over random visibility, both sides."""
    n = RNG.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    g = {"visible": RNG.uniform(size=(h, w)) > 0.2,
         "depth": RNG.uniform(0.01, 1, (h, w)).astype(np.float32),
         "position": RNG.uniform(-5, 5, (h, w, 3)).astype(np.float32),
         "normal": n,
         "base_color": RNG.uniform(0, 1, (h, w, 3)).astype(np.float32),
         "metallic": RNG.uniform(0, 1, (h, w)).astype(np.float32),
         "roughness": RNG.uniform(0.2, 1, (h, w)).astype(np.float32),
         "reflectance": RNG.uniform(0, 1, (h, w)).astype(np.float32),
         "emissive": RNG.uniform(0, 0.2, (h, w, 3)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in g.items()},
            {k: torch.from_numpy(v) for k, v in g.items()})


@pytest.mark.parametrize("sh,inputs", [(True, "reflection_gi"), (False, "reflection_gi"),
                                       (True, "reflection_only"), (False, "gi_only")],
                         ids=["sh", "hemisphere", "sh_reflection_only", "hemisphere_gi_only"])
def test_resolve_with_reflection_and_gi_matches(sh, inputs):
    h, w = 24, 40
    jg, tg = _random_gbuffer(h, w)
    jc, tc = _camera(w, h)
    arr = lambda *s: RNG.uniform(0, 2, s).astype(np.float32)
    kw = {}
    if inputs != "gi_only":
        kw["reflection"] = arr(h, w, 3)
        kw["reflection_conf"] = RNG.uniform(0, 1, (h, w)).astype(np.float32)
    if inputs != "reflection_only":
        kw["gi"] = arr(h, w, 3)
    if sh:
        kw.update(ambient_sh=arr(9, 3), sky=arr(h, w, 3), specular_ambient=arr(h, w, 3))
    shadow = arr(h, w, 1) / 2
    j = jlt.resolve(jg, jc, shadow=jnp.asarray(shadow),
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    t = tlt.resolve(tg, tc, shadow=torch.tensor(shadow),
                    **{k: torch.tensor(v) for k, v in kw.items()})
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(64, 128), (33, 50), (17, 9), (1, 7)])
def test_hiz_pyramid_matches_in_every_bit(shape):
    d = RNG.uniform(0, 1, shape).astype(np.float32)
    d[RNG.uniform(size=shape) < 0.3] = 0.0
    j = jhiz.build_pyramid(jnp.asarray(d))
    t = thiz.build_pyramid(torch.tensor(d))
    assert len(j) == len(t) == thiz.full_levels(*shape) and t[-1].shape == (1, 1)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    shallow = thiz.build_pyramid(torch.tensor(d), levels=2)
    assert len(shallow) == 2 and torch.equal(shallow[1], t[1])


def test_occlusion_cull_matches_reference():
    """The reference's occluder scene (tests/test_hiz_forward.py): a wall at
    depth 0.05 over the left half of a 128x64 frame; a box behind it is
    culled, not with a pyramid too shallow for its rect, and a box in front
    is kept. Then 400 random boxes against a random depth."""
    jc, tc = _camera(128, 64, eye=(0.0, 0.5, 3.0))
    jc["view_proj"] = jcam.common_constants(
        jnp.array([0.0, 0.5, 3.0]),
        jm3.look_at(jnp.array([0.0, 0.5, 3.0]), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0])),
        jm3.perspective_reverse_z(1.0, 2.0, 0.1), jnp.array([0.3, -0.8, -0.4]),
        (128, 64), 0.0, 1 / 60)["view_proj"]
    vp_t = torch.tensor(np.asarray(jc["view_proj"]))
    depth = np.zeros((64, 128), np.float32)
    depth[:, :64] = 0.05
    boxes = [([-2.0, -0.5, -8.0], [-0.5, 0.5, -7.0]), ([-1.0, -0.2, 1.5], [-0.2, 0.2, 2.0])]
    lo = np.array([b[0] for b in boxes], np.float32)
    hi = np.array([b[1] for b in boxes], np.float32)
    for levels, want in ((None, [True, False]), (4, [False, False])):
        jp = jhiz.build_pyramid(jnp.asarray(depth), levels)
        tp = thiz.build_pyramid(torch.tensor(depth), levels)
        j = np.asarray(_j_cull(jnp.asarray(lo), jnp.asarray(hi), jc["view_proj"], jp,
                               128, 64))
        t = thiz.occlusion_cull(torch.tensor(lo), torch.tensor(hi), vp_t, tp, 128, 64)
        assert j.tolist() == t.tolist() == want
    c = RNG.uniform(-6, 6, (400, 3)).astype(np.float32)
    c[:, 2] = RNG.uniform(-20, 2, 400)
    half = RNG.uniform(0.05, 2, (400, 3)).astype(np.float32)
    rnd = np.where(RNG.uniform(size=(64, 128)) < 0.8, 0.08, 0.01).astype(np.float32)
    j = np.asarray(_j_cull(jnp.asarray(c - half), jnp.asarray(c + half), jc["view_proj"],
                           jhiz.build_pyramid(jnp.asarray(rnd)), 128, 64))
    t = thiz.occlusion_cull(torch.tensor(c - half), torch.tensor(c + half), vp_t,
                            thiz.build_pyramid(torch.tensor(rnd)), 128, 64).numpy()
    assert (j == t).mean() >= 0.99 and t.any() and not t.all()


def _staircases():
    """The reference's staircase (tests/test_render.py, the SMAA smoothing
    test), its 45-degree staircase (the diagonal-pattern test), a flat
    image and random colours."""
    stair = np.zeros((32, 32, 3), np.float32)
    for y in range(32):
        stair[y, : min(2 + y // 2, 32)] = 1.0
    diag = np.zeros((48, 48, 3), np.float32)
    for y in range(48):
        diag[y, : y + 1] = 1.0
    return {"staircase": stair, "diagonal": diag,
            "flat": np.full((16, 16, 3), 0.5, np.float32),
            "random": RNG.uniform(0, 1, (40, 56, 3)).astype(np.float32)}


@pytest.mark.parametrize("name", ["staircase", "diagonal", "flat", "random"])
def test_smaa_matches_reference(name):
    img = _staircases()[name]
    j = _j_smaa(jnp.asarray(img))
    t = tsmaa.apply_smaa(torch.tensor(img))
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jax.jit(jsmaa.detect_edges)(jnp.asarray(img))),
                                  tsmaa.detect_edges(torch.tensor(img)).numpy())
    if name in ("staircase", "diagonal"):
        assert ((t > 0.05) & (t < 0.95)).sum() > 20      # the edge gains coverage


def test_velocity_and_disocclusion_match_reference():
    """Two frames at 128x75 (an odd height): one box moves between them,
    the renderer gets the previous instance matrices; the second frame's
    velocity and disocclusion against the jitted reference's."""
    w, h = 128, 75
    jc, tc = _camera(w, h)
    over = dict(SLICE_OVERRIDES, use_velocity=True, use_occlusion_culling=True)
    kw = dict(width=w, height=h, max_triangles=2000, max_vertices=2000, max_instances=8)
    jr = jdef.DeferredRenderer(JRenderConfig(**kw, **over), _scene(jmesh))
    tr = tdef.DeferredRenderer(RenderConfig(**kw, **over), _scene(tmesh), "cpu")
    m0 = _box_mats(BOXES)
    m1 = m0.copy()
    m1[2, :3, 3] += (1.5, 0.0, 0.8)                 # box 2 moves right and nearer
    jrender = jax.jit(jr.render)
    jdev, tdev = jr.device_scene(), tr.device_scene()
    js, ts = jr.initial_frame_state(), tr.initial_frame_state()
    for prev, cur in ((m0, m0), (m0, m1)):
        jo = jrender(jdev, jnp.asarray(cur), jc, js, prev_inst_matrices=jnp.asarray(prev))
        to = tr.render(tdev, torch.tensor(cur), tc, ts, prev_inst_matrices=torch.tensor(prev))
        js, ts = jo["frame_state"], to["frame_state"]
    assert set(js) == set(ts) == {"avg_luminance", "prev_depth", "prev_view_proj"}
    same = np.asarray(jo["tri_id"]) == to["tri_id"].numpy()
    assert same.mean() >= 0.999
    vel = to["velocity"].numpy()
    np.testing.assert_allclose(np.asarray(jo["velocity"])[same], vel[same], rtol=0,
                               atol=1e-3)
    moved = to["gbuffer"]["instance"].numpy() == 2
    assert moved.any() and np.abs(vel[moved]).max() > 1.0
    assert np.abs(vel[~moved & same]).max() < 1e-3   # everything else stands still
    dis = to["disocclusion"].numpy()
    assert dis.shape == (h, w)
    assert (np.asarray(jo["disocclusion"]) == dis).mean() >= 0.995
    assert 0.0 < dis.mean() < 0.5


@pytest.mark.parametrize("n_in,n_out", [(38, 75), (42, 83), (540, 1080), (5, 9),
                                        (768, 1080)])
def test_nearest_rows_match_jax_resize(n_in, n_out):
    """The disocclusion mask's resize from ceil(n / 2) to n (at 83 the
    exact quotient is an integer that XLA's folded constant misses) and
    one other ratio."""
    x = np.arange(n_in, dtype=np.float32)[:, None]
    j = np.asarray(jax.image.resize(jnp.asarray(x), (n_out, 1), "nearest"))[:, 0]
    np.testing.assert_array_equal(j, tdef.nearest_rows(n_in, n_out, "cpu").numpy())


@pytest.mark.parametrize("src,dst", [((48, 72), (64, 96)), ((64, 64), (128, 192)),
                                     ((96, 176), (135, 240))],
                         ids=["0.75", "0.5x0.33", "low_full_size_ratio"])
def test_upsample_linear_matches_jax_resize(src, dst):
    """render_scale's upscale: `blur.upsample_linear` against
    `jax.image.resize(..., "linear")`; the last ratio is the low preset's
    at full size (768x1408 -> 1080x1920) divided by 8."""
    x = RNG.uniform(0, 1, src + (3,)).astype(np.float32)
    j = jax.image.resize(jnp.asarray(x), dst + (3,), "linear")
    t = tblur.upsample_linear(torch.tensor(x), *dst)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("preset", sorted(QUALITY_PRESETS))
def test_quality_presets_render(preset):
    """render_quality(p) renders on the port at 128x64, cascades cut to
    128 texels; the image is finite and shows the boxes."""
    base = render_quality(preset)
    cfg = render_quality(preset, width=128, height=64, max_triangles=2000,
                         max_vertices=2000, max_instances=8,
                         shadow=dataclasses.replace(base.shadow, map_size=128))
    jc, tc = _camera(128, 64)
    ren = tdef.DeferredRenderer(cfg, _scene(tmesh), "cpu")
    state = ren.initial_frame_state()
    for _ in range(2):
        out = ren.render(ren.device_scene(), torch.tensor(_box_mats(BOXES)), tc, state)
        state = out["frame_state"]
    img = out["image"]
    assert img.shape == (64, 128, 3) and img.dtype == torch.uint8
    assert float(out["hdr"].float().abs().max()) < 1e4 and img.float().std() > 1.0
    assert (out["tri_id"] >= 0).float().mean() > 0.3
