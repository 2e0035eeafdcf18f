"""Parity of the port's non-opaque passes' parts with the JAX package: the
refraction pass's blur chain and linear upsample, the G-buffer from
shading records (`shade_gbuffer(records=)`), the translucent shadow map of
`render_cascades` and its tint in `resolve_shadow`; behavioural mirrors of
the reference's sorted, refraction/trans-depth and translucent-caster
tests on the port; and the two small repairs that came with them.

Tolerances: the gaussian blur, the mean-pool downsample and the blur
chain agree to 1e-6 (the same taps summed in the same order; the chain
compounds the reference's ops), the linear upsample to 2e-6 (jax.image.
resize sums two weighted taps where the port lerps, so each output may
round differently by an ulp). The G-buffer from records agrees to 1e-5
(normalization and reconstruction in the same op order; measured 1.2e-7).
The atlases follow tests/test_torch_csm.py: depth to 1e-5 where both sides
cover, coverage on >= 99.9% of texels; the translucent tint, which blends
in bin order over the opaque z-test, within 1e-5 on >= 99.5% of texels
(measured: every texel); the resolved (H, W, 3) factor within 1e-4 on >=
99.5% of pixels (measured: every pixel).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import math3d as jm3
from garden_tpu.core.config import ShadowConfig as JShadowConfig
from garden_tpu.ops import blur as jblur
from garden_tpu.render import csm as jcsm
from garden_tpu.render import gbuffer as jgb
from garden_tpu.render import mesh as jmesh
from garden_tpu.systems import camera as jcam
from garden_tpu_torch.core import math3d as tm3
from garden_tpu_torch.core.config import RenderConfig, ShadowConfig
from garden_tpu_torch.ops import blur as tblur
from garden_tpu_torch.render import csm as tcsm
from garden_tpu_torch.render import gbuffer as tgb
from garden_tpu_torch.render import mesh as tmesh
from garden_tpu_torch.render.deferred import DeferredRenderer
from garden_tpu_torch.systems.camera import common_constants

RNG = np.random.default_rng(17)


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("shape,radius", [((13, 17, 3), 1), ((13, 17, 3), 2),
                                          ((9, 11), 2)])
def test_gaussian_blur_matches(shape, radius):
    img = RNG.random(shape).astype(np.float32)
    _close(jblur.gaussian_blur(jnp.asarray(img), radius=radius),
           tblur.gaussian_blur(torch.from_numpy(img), radius=radius), 1e-6)


@pytest.mark.parametrize("shape", [(12, 16, 3), (13, 17, 3), (9, 11)])
def test_downsample2x_matches(shape):
    """A mean pool, odd last rows and columns dropped."""
    img = RNG.random(shape).astype(np.float32)
    j = jblur.downsample2x(jnp.asarray(img))
    t = tblur.downsample2x(torch.from_numpy(img))
    assert tuple(t.shape) == j.shape
    _close(j, t, 1e-6)


def test_ggx_blur_chain_matches():
    img = (RNG.random((67, 90, 3)) * 4.0).astype(np.float32)
    jc = jblur.ggx_blur_chain(jnp.asarray(img), levels=3)
    tc = tblur.ggx_blur_chain(torch.from_numpy(img), levels=3)
    assert [tuple(t.shape) for t in tc] == [j.shape for j in jc] == [
        (67, 90, 3), (33, 45, 3), (16, 22, 3), (8, 11, 3)]
    for j, t in zip(jc, tc):
        _close(j, t, 4e-6)


@pytest.mark.parametrize("lo,factor", [((27, 48), 2), ((13, 24), 4), ((7, 12), 8)])
def test_upsample_linear_matches_jax_resize(lo, factor):
    """The refraction chain's integer upscales: F.interpolate's bilinear
    with half-pixel centres samples where jax.image.resize 'linear' does,
    with the same edge clamp."""
    x = (RNG.random(lo + (3,)) * 2.0).astype(np.float32)
    th, tw = lo[0] * factor, lo[1] * factor
    j = jax.image.resize(jnp.asarray(x), (th, tw, 3), "linear")
    _close(j, tblur.upsample_linear(torch.from_numpy(x), th, tw), 2e-6)


def _constants(w, h, torch_side):
    eye, target, up = [0.0, 9.0, 14.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]
    if torch_side:
        v = lambda c: torch.tensor(c, dtype=torch.float32)
        view = tm3.look_at(v(eye), v(target), v(up))
        proj = tm3.perspective_reverse_z(1.0, w / h, 0.1, device="cpu")
        return common_constants(v(eye), view, proj, v([0.4, -0.7, -0.5]), (w, h),
                                0.0, 1.0 / 60.0)
    view = jm3.look_at(jnp.array(eye), jnp.array(target), jnp.array(up))
    proj = jm3.perspective_reverse_z(1.0, w / h, 0.1)
    return jcam.common_constants(jnp.array(eye), view, proj,
                                 jnp.array([0.4, -0.7, -0.5]), (w, h), 0.0, 1.0 / 60.0)


def test_gbuffer_from_records_matches():
    """shade_gbuffer(records=): one gather of the winner's record, the
    perspective-correct weights through its inv_w, normal, uv, material,
    instance and position from depth, against the reference's records
    path; empty pixels report instance -1 and position 0. Without
    constants, positions interpolate the winner's corners from the vertex
    pool, as the reference's."""
    h, w, t = 24, 40, 30
    rec = RNG.uniform(0, 1, (t, 36)).astype(np.float32)
    rec[:, 0:9] = RNG.normal(size=(t, 9))
    rec[:, 25] = RNG.integers(0, 7, t)
    rec[:, 32:35] += 0.4
    b0 = RNG.uniform(0, 1, (h, w)).astype(np.float32)
    b1 = (RNG.uniform(0, 1, (h, w)) * (1 - b0)).astype(np.float32)
    vis = {"tri_id": RNG.integers(-1, t, (h, w)).astype(np.int32),
           "depth": RNG.uniform(0.01, 0.9, (h, w)).astype(np.float32), "b0": b0, "b1": b1}
    jg = jgb.shade_gbuffer({k: jnp.asarray(v) for k, v in vis.items()}, None, {},
                           None, None, constants=_constants(w, h, False),
                           records=jnp.asarray(rec))
    tvis = {k: torch.from_numpy(v) for k, v in vis.items()}
    tg = tgb.shade_gbuffer(tvis, None, None, None, None, constants=_constants(w, h, True),
                           records=torch.from_numpy(rec))
    assert set(tg) <= set(jg)
    for k in tg:
        if k in ("visible", "instance"):
            np.testing.assert_array_equal(np.asarray(jg[k]), tg[k].numpy(), err_msg=k)
        else:
            _close(jg[k], tg[k], 1e-5)
    empty = vis["tri_id"] < 0
    assert empty.any() and (tg["instance"].numpy()[empty] == -1).all()
    assert (tg["position"].numpy()[empty] == 0).all()
    idx = RNG.integers(0, 50, (t, 3)).astype(np.int32)
    wpos = RNG.uniform(-5, 5, (50, 3)).astype(np.float32)
    jp = jgb.shade_gbuffer({k: jnp.asarray(v) for k, v in vis.items()}, None,
                           {"indices": jnp.asarray(idx)}, jnp.asarray(wpos), None,
                           records=jnp.asarray(rec))["position"]
    tp = tgb.shade_gbuffer(tvis, None, {"indices": torch.from_numpy(idx)},
                           torch.from_numpy(wpos), None,
                           records=torch.from_numpy(rec))["position"]
    _close(jp, tp, 1e-5)
    assert (tp.numpy()[empty] != 0).any()      # empty pixels: triangle 0's corners


def _atlas_close(j, t):
    cov_j, cov_t = j > 0, t > 0
    assert (cov_j == cov_t).mean() >= 0.999
    both = cov_j & cov_t
    assert np.abs(j[both] - t[both]).max(initial=0.0) <= 1e-5


@pytest.fixture(scope="module")
def trans_maps():
    """Both packages' opaque depth atlas and translucent map of the same
    world triangles (a third of them translucent, tinted), at the flagship's
    split ShadowConfig with cascades cut to 256/128/128. The casters wind
    front-facing as the light sees them."""
    cj, ct = _constants(256, 128, False), _constants(256, 128, True)
    cfg = dict(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
               atlas_foot_y=2, max_active_tiles=24, distance=40.0)
    jcfg, tcfg = JShadowConfig(**cfg), ShadowConfig(**cfg)
    splits = jcsm.cascade_splits(jcfg, 0.1)
    ivp, ld = np.array(cj["inv_view_proj"]), np.array(cj["light_dir"])
    jl = jcsm.fit_cascades(jnp.asarray(ivp), jnp.asarray(ld), 0.1, splits, 0.1)
    tl = tcsm.fit_cascades(torch.from_numpy(ivp), torch.from_numpy(ld), 0.1, splits, 0.1)
    rng = np.random.default_rng(43)
    t = 600
    base = rng.uniform(-12, 12, (1, t, 3)) * [1, 0.3, 1] + [0, 1.5, 0]
    corners = (base + rng.normal(0, 0.7, (3, t, 3))).astype(np.float32)
    nrm = np.cross(corners[1] - corners[0], corners[2] - corners[0])
    away = (nrm @ ld) > 0                               # faces away from the light
    corners[1, away], corners[2, away] = corners[2, away].copy(), corners[1, away].copy()
    planes = [np.ascontiguousarray(corners[..., k]) for k in range(3)]
    valid = np.ones(t, bool)
    trans = np.arange(t) % 3 == 0
    tint = np.concatenate([rng.uniform(0.2, 1.0, (t, 3)), rng.uniform(0.3, 0.8, (t, 1))],
                          -1).astype(np.float32)
    jd, jt = jcsm.render_cascades(None, None, jnp.asarray(valid), jl, jcfg,
                                  pos_planes=tuple(jnp.asarray(p) for p in planes),
                                  tri_translucent=jnp.asarray(trans),
                                  tri_tint=jnp.asarray(tint))
    casters = (tuple(torch.from_numpy(p) for p in planes), torch.from_numpy(valid),
               torch.from_numpy(trans), torch.from_numpy(tint))
    td, tt = tcsm.render_cascades(casters[0], casters[1], tl, tcfg,
                                  tri_translucent=casters[2], tri_tint=casters[3])
    return ((cj, ct, jcfg, tcfg, splits, jl, tl), (np.asarray(jd), np.asarray(jt)),
            (td, tt), casters)


def test_translucent_map_matches_reference(trans_maps):
    """The opaque atlas leaves the translucent casters out; the translucent
    map's tint (K6 over white, z-tested against the opaque atlas) and its
    nearest depth (K4 with the atlas guard) match the reference."""
    _, (jd, jt), (td, tt), _ = trans_maps
    assert tt.shape == (128 * 2, 256 + 128, 4) and td.shape == tt.shape[:2]
    _atlas_close(jd, td.numpy())
    _atlas_close(jt[..., 3], tt[..., 3].numpy())
    d = np.abs(jt[..., :3] - tt[..., :3].numpy()).max(-1)
    assert (d <= 1e-5).mean() >= 0.995
    tinted = (tt[..., :3] < 1.0).any(-1)
    assert (td > 0).float().mean() > 0.02 and (tt[..., 3] > 0).float().mean() > 0.01
    assert tinted.float().mean() > 0.005
    # casters behind opaque ones tint nothing: the tint needs z >= opaque
    assert bool(((tt[..., 3] > 0) & ~tinted).any())


def test_caster_inputs_split_the_casters(trans_maps):
    """caster_inputs is the one split of the casters: the opaque set
    leaves the translucent casters out, the translucent set holds only
    them, and draw_cascades of the two sets is render_cascades."""
    (_, _, _, tcfg, _, _, tl), _, (td, tt), (planes, valid, trans, tint) = trans_maps
    okw, tkw = tcsm.caster_inputs(planes, valid, tl, tcfg, tri_translucent=trans)
    n_casc = len(tcfg.cascade_sizes)
    for kw, mask in ((okw, valid & ~trans), (tkw, valid & trans)):
        set_up = kw["setup"]["valid"].reshape(n_casc, -1).any(0)
        assert bool(set_up.any()) and not bool((set_up & ~mask).any())
    d, t = tcsm.draw_cascades(okw, tkw, tint)
    assert torch.equal(d, td) and torch.equal(t, tt)
    assert tcsm.caster_inputs(planes, valid, tl, tcfg)[1] is None


@pytest.mark.parametrize("step", [1, 2])
def test_resolve_shadow_with_tint_matches(trans_maps, step):
    """resolve_shadow with the translucent map: (H, W, 3), the tint looked
    up at quarter density (tsub = 4 // step) and repeated."""
    (cj, _, jcfg, tcfg, splits, jl, tl), (jd, jt), (td, tt), _ = trans_maps
    jcfg = dataclasses.replace(jcfg, resolve_step=step)
    tcfg = dataclasses.replace(tcfg, resolve_step=step)
    rng = np.random.default_rng(47)
    h, w = 64, 96
    pos = np.stack([rng.uniform(-12, 12, (h, w)), rng.uniform(-0.5, 1.0, (h, w)),
                    rng.uniform(-12, 12, (h, w))], -1).astype(np.float32)
    nrm = np.broadcast_to(np.float32([0, 1, 0]), (h, w, 3)).copy()
    vd = np.linalg.norm(pos - np.asarray(cj["camera_pos"]), axis=-1).astype(np.float32)
    js = np.asarray(jcsm.resolve_shadow(jnp.asarray(pos), jnp.asarray(nrm),
                                        jnp.asarray(vd), jnp.asarray(jd), jnp.asarray(jt),
                                        jl, jcfg, splits, jnp.asarray(cj["light_dir"])))
    ts = tcsm.resolve_shadow(torch.from_numpy(pos), torch.from_numpy(nrm),
                             torch.from_numpy(vd), td, tl, tcfg, splits, tt).numpy()
    assert js.shape == ts.shape == (h, w, 3)
    assert (np.abs(js - ts).max(-1) <= 1e-4).mean() >= 0.995
    # some pixels take a colour tint (channels differ), some are plain lit
    assert (np.ptp(ts, axis=-1) > 0.05).mean() > 0.01 and (ts == 1.0).all(-1).any()


# -- behavioural mirrors of the reference's tests (tests/test_render.py) ------

def _small_config(**kw):
    return RenderConfig(width=160, height=96, tile_size=32, max_triangles=2048,
                        max_vertices=2048, max_tris_per_tile=128, max_instances=8,
                        use_fxaa=False, use_bloom=False, use_shadows=False,
                        use_hbao=False, use_atmosphere=False, use_oit=False,
                        use_auto_exposure=False, **kw)


def _camera(cfg, eye=(0.0, 1.5, 4.0), target=(0.0, 0.5, 0.0), light=(0.3, -0.8, -0.4)):
    v = lambda c: torch.tensor(c, dtype=torch.float32)
    view = tm3.look_at(v(eye), v(target), v([0.0, 1.0, 0.0]))
    proj = tm3.perspective_reverse_z(1.0, cfg.width / cfg.height, 0.1, device="cpu")
    return common_constants(v(eye), view, proj, v(light), (cfg.width, cfg.height),
                            0.0, 1.0 / 60.0)


def test_sorted_translucent_pass_on_port():
    """Mirror of test_sorted_translucent_pass: two stacked translucent cubes
    in front of a bright wall blend in depth order."""
    cfg = _small_config()
    scene = tmesh.SceneBuffers(2048, 2048, 8)
    wall = scene.add_material(tmesh.Material(base_color=(0.1, 0.1, 0.1),
                                             emissive=(1.0, 1.0, 1.0)))
    red = scene.add_material(tmesh.Material(base_color=(1.0, 0.0, 0.0), alpha=0.5,
                                            blend_mode="sorted"))
    blue = scene.add_material(tmesh.Material(base_color=(0.0, 0.0, 1.0), alpha=0.5,
                                             blend_mode="sorted"))
    scene.add_instance(tmesh.cube(1.0), material=wall)
    scene.add_instance(tmesh.cube(0.4), material=red)
    scene.add_instance(tmesh.cube(0.4), material=blue)
    ren = DeferredRenderer(cfg, scene, "cpu")
    assert ren.any_sorted and not ren.any_translucent
    mats = torch.eye(4).repeat(8, 1, 1)
    mats[0, :3, 3] = torch.tensor([0.0, 0.5, -2.0])      # wall behind
    mats[1, :3, 3] = torch.tensor([0.0, 0.6, 0.0])       # red mid
    mats[2, :3, 3] = torch.tensor([0.0, 0.6, 1.2])       # blue nearest
    out = ren.render(ren.device_scene(), mats, _camera(cfg), ren.initial_frame_state())
    hdr = out["hdr"].float().numpy()
    c = hdr[cfg.height // 2 - 8, cfg.width // 2]
    assert c[2] > 0.1, c          # the blue layer, drawn last
    assert c[0] > 0.05, c         # red shows through the blue's 0.5 alpha
    assert np.isfinite(hdr).all()


def test_refraction_and_trans_depth_on_port():
    """Mirror of test_refraction_and_trans_depth: the refractive cube is not
    in the opaque G-buffer, the refraction pass covers it, and trans-depth
    reports it nearer than the opaque background."""
    cfg = _small_config(use_trans_depth=True)
    scene = tmesh.SceneBuffers(2048, 2048, 8)
    grey = scene.add_material(tmesh.Material(base_color=(0.5, 0.5, 0.5)))
    glass = scene.add_material(tmesh.Material(base_color=(0.9, 1.0, 0.9), roughness=0.1,
                                              blend_mode="refract"))
    scene.add_instance(tmesh.plane_grid(20.0, 8), material=grey)
    scene.add_instance(tmesh.cube(0.5), material=glass)
    ren = DeferredRenderer(cfg, scene, "cpu")
    assert ren.any_refract
    mats = torch.eye(4).repeat(8, 1, 1)
    mats[1, 1, 3] = 0.5
    out = ren.render(ren.device_scene(), mats, _camera(cfg), ren.initial_frame_state())
    assert (out["gbuffer"]["instance"] == 1).sum() == 0
    assert torch.isfinite(out["hdr"]).all()
    covered_r = out["translucent"]["refract_tri_id"] >= 0
    assert covered_r.sum() > 50
    td, od = out["trans_depth"].numpy(), out["depth"].numpy()
    covered = td > 0
    assert covered.sum() > 50
    assert (td[covered] >= od[covered] - 1e-6).mean() > 0.9


def test_translucent_casters_tint_shadows_on_port():
    """Mirror of test_translucent_casters_tint_shadows: a translucent red
    cube casts a red-tinted shadow on the ground."""
    rcfg = RenderConfig(width=128, height=128, tile_size=128, max_vertices=512,
                        max_triangles=512, max_instances=8, use_oit=True,
                        shadow=ShadowConfig(map_size=128, cascade_count=2,
                                            distance=40.0))
    sc = tmesh.SceneBuffers(512, 512, 8)
    gm = sc.add_material(tmesh.Material(base_color=(0.6, 0.6, 0.6)))
    rm = sc.add_material(tmesh.Material(base_color=(1.0, 0.1, 0.1), alpha=0.6))
    sc.add_instance(tmesh.plane_grid(20.0, 2), material=gm)
    sc.add_instance(tmesh.cube(1.5), material=rm)
    ren = DeferredRenderer(rcfg, sc, "cpu")
    assert ren.any_translucent
    inst = torch.eye(4).repeat(8, 1, 1)
    inst[1, 1, 3] = 3.0
    out = ren.render(ren.device_scene(), inst,
                     _camera(rcfg, eye=(0.0, 6.0, 10.0), target=(0.0, 0.0, 0.0),
                             light=(0.0, -1.0, 0.01)), ren.initial_frame_state())
    sh = out["shadow"].numpy()
    assert sh.shape == (128, 128, 3)
    tinted = (sh[..., 0] > sh[..., 1] + 0.05).sum()
    assert tinted > 50, f"no red-tinted shadow pixels ({tinted})"
    assert (out["translucent"]["reveal"] < 1).any()
    assert out["image"].dtype == torch.uint8


# -- the small repairs ---------------------------------------------------------

def test_orthographic_needs_a_device_for_number_bounds():
    """With every bound a number the device must be named; it was silently
    the CPU."""
    with pytest.raises(ValueError):
        tm3.orthographic(-1.0, 1.0, -1.0, 1.0, 0.1, 10.0)
    m = tm3.orthographic(-1.0, 1.0, -1.0, 1.0, 0.1, 10.0, device="cpu")
    t = tm3.orthographic(torch.tensor(-1.0), 1.0, -1.0, 1.0, 0.1, 10.0)
    assert torch.equal(m, t)


def test_device_arrays_carry_the_nonopaque_masks():
    """The scene's device arrays hold tri_translucent, tri_sorted and
    tri_refract under the reference's keys, equal to the reference's."""
    js = jmesh.SceneBuffers(256, 256, 6)
    ts = tmesh.SceneBuffers(256, 256, 6)
    for sc, m in ((js, jmesh), (ts, tmesh)):
        mats = [sc.add_material(m.Material(**kw)) for kw in (
            {}, dict(alpha=0.5), dict(blend_mode="oit", alpha=0.3),
            dict(blend_mode="sorted", alpha=0.5), dict(blend_mode="refract"))]
        for k in mats:
            sc.add_instance(m.cube(0.5), material=k)
    jd, td = js.device_arrays(), ts.device_arrays("cpu")
    for k in ("tri_translucent", "tri_sorted", "tri_refract"):
        np.testing.assert_array_equal(np.asarray(jd[k]), td[k].numpy(), err_msg=k)
        assert td[k].dtype == torch.bool and td[k].any()
