"""Parity of the port's render modules (mesh, culling, G-buffer, BRDF,
lighting, tone mapping) with `garden_tpu.render`.

Tolerances: host-built arrays compare exactly; float32 shading math to
1e-5 (another summation order in einsums and sums), the bare BRDF to 1e-4
(the GGX term's 1/f^2 magnifies n.h rounding near the roughness floor);
tone-mapped sRGB to 1e-4 and the uint8 image to 1 level; the bf16 histogram
bins to within 1% of the samples (bf16 rounding of luminance may move a
sample across a bin edge when the two frameworks round at other steps).
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core.config import RenderConfig as JRenderConfig
from garden_tpu.render import brdf as jbrdf
from garden_tpu.render import deferred as jdef
from garden_tpu.render import gbuffer as jgb
from garden_tpu.render import lighting as jlt
from garden_tpu.render import mesh as jmesh
from garden_tpu.render import tonemap as jtm
from garden_tpu.core import math3d as jm3
from garden_tpu.systems import camera as jcam
from garden_tpu_torch.convert import from_jax
from garden_tpu_torch.core.config import RenderConfig, SLICE_OVERRIDES
from garden_tpu_torch.render import brdf as tbrdf
from garden_tpu_torch.render import deferred as tdef
from garden_tpu_torch.render import gbuffer as tgb
from garden_tpu_torch.render import lighting as tlt
from garden_tpu_torch.render import mesh as tmesh
from garden_tpu_torch.render import tonemap as ttm

H, W = 32, 48
RNG = np.random.default_rng(1)


def _close(j, t, tol=1e-5, **kw):
    np.testing.assert_allclose(np.asarray(j), t.detach().float().numpy(),
                               rtol=tol, atol=tol, **kw)


def _scene(mod, n_inst=6):
    s = mod.SceneBuffers(2000, 2000, 16)
    m0 = s.add_material(mod.Material(base_color=(0.8, 0.3, 0.2), metallic=0.3))
    m1 = s.add_material(mod.Material(base_color=(0.5, 0.5, 0.5), roughness=0.7))
    s.add_instance(mod.plane_grid(20.0, 4), material=m1)
    for _ in range(n_inst):
        s.add_instance(mod.cube(0.45), material=m0)
    return s


def _inst_mats(n):
    pos = RNG.uniform(-3, 3, (n, 3)).astype(np.float32)
    q = RNG.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.array(jm3.compose_trs(jnp.asarray(pos), jnp.asarray(q),
                                    jnp.ones((n, 3))))


def _constants():
    eye = jnp.array([0.0, 6.0, 10.0])
    view = jm3.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    proj = jm3.perspective_reverse_z(1.0, W / H, 0.1)
    j = jcam.common_constants(eye, view, proj, jnp.array([0.4, -0.7, -0.5]),
                              (W, H), 0.0, 1.0 / 60.0)
    return j, from_jax({k: np.asarray(v) for k, v in j.items()}, "cpu")


def test_meshes_and_scene_match():
    for jmk, tmk in ((jmesh.cube(0.45), tmesh.cube(0.45)),
                     (jmesh.plane_grid(20.0, 4), tmesh.plane_grid(20.0, 4))):
        for f in ("positions", "normals", "uvs", "indices"):
            np.testing.assert_array_equal(getattr(jmk, f), getattr(tmk, f))
    j = _scene(jmesh).device_arrays()
    t = _scene(tmesh).device_arrays("cpu")
    for k, v in t.items():
        np.testing.assert_array_equal(np.asarray(j[k]), v.numpy(), err_msg=k)


def test_transform_and_cull_match():
    js, ts = _scene(jmesh), _scene(tmesh)
    jd, td = js.device_arrays(), ts.device_arrays("cpu")
    mats = _inst_mats(16)
    mats[0] = np.eye(4)
    jp, jn = jmesh.transform_triangle_planes(jd, jnp.asarray(mats),
                                             tri_instance_np=js.tri_instance)
    tp, tn = tmesh.transform_triangle_planes(td, torch.as_tensor(mats))
    for a, b in zip(jp + jn, tp + tn):
        _close(a, b)
    jc, tc = _constants()
    cfg = dict(width=W, height=H, max_triangles=2000, max_vertices=2000,
               max_instances=16, **SLICE_OVERRIDES)
    jr = jdef.DeferredRenderer(JRenderConfig(**cfg), js)
    tr = tdef.DeferredRenderer(RenderConfig(**cfg), ts, "cpu")
    jv = jr.cull_instances(jd, jnp.asarray(mats), jc)
    tv = tr.cull_instances(td, torch.as_tensor(mats), tc)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert 0 < tv.sum() < tv.shape[0]        # some instances culled, some not


def test_pack_triangle_records_matches():
    js, ts = _scene(jmesh), _scene(tmesh)
    jd, td = js.device_arrays(), ts.device_arrays("cpu")
    t = jd["indices"].shape[0]
    nrm = RNG.normal(size=(t, 3, 3)).astype(np.float32)
    inv_w = RNG.uniform(0.1, 2.0, (3, t)).astype(np.float32)
    j = jgb.pack_triangle_records(jd, tri_normals=jnp.asarray(nrm),
                                  inv_w=jnp.asarray(inv_w),
                                  tri_instance_np=js.tri_instance)
    tt = tgb.pack_triangle_records(td, torch.as_tensor(nrm), torch.as_tensor(inv_w))
    np.testing.assert_array_equal(np.asarray(j), tt.numpy())


def _gplanes():
    g = RNG.uniform(-1, 1, (18, H, W)).astype(np.float32)
    tri = RNG.integers(-1, 5, (H, W)).astype(np.int32)
    depth = RNG.uniform(0.01, 1.0, (H, W)).astype(np.float32)
    g[:, tri < 0] = 0.0
    g[15] = RNG.integers(0, 9, (H, W))
    return g, tri, depth


def test_shade_gbuffer_matches():
    g, tri, depth = _gplanes()
    jc, tc = _constants()
    vis = {"tri_id": tri, "depth": depth}
    j = jgb.shade_gbuffer({k: jnp.asarray(v) for k, v in vis.items()}, None, {},
                          None, None, constants=jc, gplanes=jnp.asarray(g))
    t = tgb.shade_gbuffer({k: torch.as_tensor(v) for k, v in vis.items()}, None, None,
                          None, None, constants=tc, gplanes=torch.as_tensor(g))
    assert set(j) == set(t)
    for k in j:
        if t[k].dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(np.asarray(j[k]), t[k].numpy(), err_msg=k)
        else:
            _close(j[k], t[k], err_msg=k)


def _gbuffer_dict():
    g, tri, depth = _gplanes()
    jc, tc = _constants()
    vis = {"tri_id": tri, "depth": depth}
    g[0:3] /= np.linalg.norm(g[0:3], axis=0, keepdims=True) + 1e-12
    g[5:14] = np.abs(g[5:14])
    jg = jgb.shade_gbuffer({k: jnp.asarray(v) for k, v in vis.items()}, None, {},
                           None, None, constants=jc, gplanes=jnp.asarray(g))
    tg = tgb.shade_gbuffer({k: torch.as_tensor(v) for k, v in vis.items()}, None, None,
                           None, None, constants=tc, gplanes=torch.as_tensor(g))
    return jg, tg, jc, tc


def test_brdf_matches():
    jg, tg, jc, tc = _gbuffer_dict()
    v = RNG.normal(size=(H, W, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    l = np.broadcast_to(np.array([0.3, 0.8, 0.52], np.float32), v.shape)
    args = ("normal", "base_color", "metallic", "roughness", "reflectance")
    j = jbrdf.evaluate(jg["normal"], jnp.asarray(v), jnp.asarray(l),
                       *[jg[a] for a in args[1:]])
    t = tbrdf.evaluate(tg["normal"], torch.as_tensor(v), torch.as_tensor(l.copy()),
                       *[tg[a] for a in args[1:]])
    _close(j, t, 1e-4)    # GGX's 1/f^2 amplifies n.h rounding at low roughness
    sky, grd = np.array([0.45, 0.55, 0.7], np.float32), np.array([0.1, 0.1, 0.08],
                                                                   np.float32)
    j = jbrdf.ambient(jg["normal"], jg["base_color"], jg["metallic"],
                      jnp.asarray(sky), jnp.asarray(grd))
    t = tbrdf.ambient(tg["normal"], tg["base_color"], tg["metallic"],
                      torch.as_tensor(sky), torch.as_tensor(grd))
    _close(j, t)


def test_lighting_matches():
    jg, tg, jc, tc = _gbuffer_dict()
    _close(jlt.view_rays(jg, jc), tlt.view_rays(tg, tc))
    dirs = np.asarray(jlt.view_rays(jg, jc))
    l = np.array([0.3, 0.7, 0.648], np.float32)
    _close(jlt.sky_color(jnp.asarray(dirs), jnp.asarray(l)),
           tlt.sky_color(torch.as_tensor(dirs), torch.as_tensor(l)))
    _close(jlt.resolve(jg, jc), tlt.resolve(tg, tc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tonemap_matches(dtype):
    hdr = np.exp(RNG.normal(-1.0, 1.5, (64, 96, 3))).astype(np.float32)
    jh = jnp.asarray(hdr).astype(dtype)
    th = torch.as_tensor(hdr).to(getattr(torch, dtype))
    jhist = np.asarray(jtm.luminance_histogram(jh, 256))
    thist = ttm.luminance_histogram(th, 256).numpy()
    assert jhist.sum() == thist.sum() == (64 // 8) * (96 // 8)
    moved = np.abs(np.cumsum(jhist) - np.cumsum(thist)).max()
    assert moved <= 0.01 * jhist.sum() + (1 if dtype == "bfloat16" else 0)
    if dtype == "float32":
        np.testing.assert_array_equal(jhist, thist)
    avg_j = jtm.average_luminance_from_histogram(jnp.asarray(jhist))
    avg_t = ttm.average_luminance_from_histogram(torch.as_tensor(jhist))
    _close(avg_j, avg_t)
    prev, dt = np.float32(0.18), np.float32(1.0 / 60.0)
    lum_j = jtm.adapt_exposure(jnp.asarray(prev), avg_j, jnp.asarray(dt))
    lum_t = ttm.adapt_exposure(torch.tensor(prev), avg_t, torch.tensor(dt))
    _close(lum_j, lum_t)
    exp_j = jtm.exposure_from_luminance(lum_j)
    exp_t = ttm.exposure_from_luminance(lum_t)
    _close(exp_j, exp_t)
    for mode in ("aces", "uchimura"):
        ldr_j = jtm.tone_map(jh, exp_j, mode=mode)
        ldr_t = ttm.tone_map(th, exp_t, mode=mode)
        _close(ldr_j, ldr_t, 1e-4)
        d = np.abs(np.asarray(jtm.to_uint8(ldr_j)).astype(int)
                   - ttm.to_uint8(ldr_t).numpy().astype(int))
        assert d.max() <= 1


@pytest.mark.parametrize("flag", ["use_ssr", "use_ssgi", "use_clouds", "use_velocity",
                                  "use_occlusion_culling", "render_scale", "smaa",
                                  "slot_binning"])
def test_unported_pass_raises(flag):
    """Every render flag builds on the port, the slot-binned cascade atlas
    (a y-footprint other than 2 atlas tiles) among them: nothing raises."""
    from garden_tpu_torch.core.config import ShadowConfig
    cfg = dict(width=W, height=H, max_triangles=2000, max_vertices=2000,
               max_instances=16)
    scene = _scene(tmesh)
    tdef.DeferredRenderer(RenderConfig(**cfg), scene, "cpu")      # the flagship set
    if flag == "render_scale":
        cfg["render_scale"] = 0.5
    elif flag == "smaa":
        cfg["aa_mode"] = "smaa"
    elif flag == "slot_binning":
        cfg["shadow"] = ShadowConfig(atlas_tile_h=32, atlas_foot_y=4)
    else:
        cfg[flag] = True
    ren = tdef.DeferredRenderer(RenderConfig(**cfg), scene, "cpu")
    if flag == "slot_binning":
        from garden_tpu_torch.render import csm as tcsm
        assert tcsm.atlas_tiling(ren.config.shadow)[2] == 4
