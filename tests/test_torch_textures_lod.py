"""Parity of the port's mesh builders, texture array, LOD chains, vertex
transform and G-buffer paths with `garden_tpu.render`: `uv_sphere`,
`heightfield`, `add_mesh`, `add_texture` (with a PIL resize),
`add_instance_lods` and their device arrays; `transform_vertices`;
`shade_gbuffer` from records packed from the vertex pool's normals, with
and without constants (positions from depth, or interpolated from the
vertex pool), textured, and from the fused raster's planes, textured;
the deferred cull's LOD selection.

Tolerances: host-built arrays are equal; the vertex transform within
1e-5; the G-buffer planes to rtol 1e-5 (float32 sums in another order);
the culled triangle masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import math3d as jm3
from garden_tpu.core.config import RenderConfig as JRenderConfig
from garden_tpu.render import deferred as jdef
from garden_tpu.render import gbuffer as jgb
from garden_tpu.render import mesh as jmesh
from garden_tpu.systems import camera as jcam
from garden_tpu_torch.convert import from_jax
from garden_tpu_torch.core.config import RenderConfig
from garden_tpu_torch.render import deferred as tdef
from garden_tpu_torch.render import gbuffer as tgb
from garden_tpu_torch.render import mesh as tmesh

W, H = 48, 32
RNG = np.random.default_rng(5)
TEX = [RNG.uniform(0, 1, (16, 16, 4)).astype(np.float32),
       RNG.uniform(0, 1, (16, 16, 3)).astype(np.float32),
       RNG.uniform(0, 1, (8, 8)).astype(np.float32)]          # resized to 16 (PIL)
HF = RNG.uniform(-0.5, 0.5, (5, 7)).astype(np.float32)


def _eq(a, b, name=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("builder", ["uv_sphere", "uv_sphere_lod1", "heightfield",
                                     "cube", "plane_grid"])
def test_mesh_builders_match(builder):
    make = {"uv_sphere": lambda m: m.uv_sphere(0.45, 6, 12),
            "uv_sphere_lod1": lambda m: m.uv_sphere(0.45, 3, 6),
            "heightfield": lambda m: m.heightfield(HF, 0.7),
            "cube": lambda m: m.cube(0.45),
            "plane_grid": lambda m: m.plane_grid(20.0, 4)}[builder]
    jm, tm = make(jmesh), make(tmesh)
    for f in ("positions", "normals", "uvs", "indices"):
        _eq(getattr(jm, f), getattr(tm, f), f)
        assert getattr(jm, f).dtype == getattr(tm, f).dtype, f
    if builder == "uv_sphere":
        assert tm.triangle_count == 144
    if builder == "uv_sphere_lod1":
        assert tm.triangle_count == 36


def _scene(mod):
    """Textures, a mesh range, plain instances and two LOD chains."""
    s = mod.SceneBuffers(3000, 3000, 12, texture_size=16, max_textures=3)
    ids = [s.add_texture(t) for t in TEX]
    assert ids == [0, 1, 2]
    assert not s.any_textured and not s.any_lods
    mid = s.add_mesh(mod.cube(0.3))
    assert mid == 0 and s._mesh_store(mid) == (0, 24, 0, 12)
    m0 = s.add_material(mod.Material(base_color=(0.8, 0.3, 0.2), base_texture=1))
    m1 = s.add_material(mod.Material(base_color=(0.5, 0.5, 0.5), roughness=0.7))
    s.add_instance(mod.plane_grid(20.0, 4), material=m1, entity=7)
    for k in range(4):
        s.add_instance(mod.cube(0.45), material=m0 if k % 2 else m1)
    lods = [mod.uv_sphere(0.45, 6, 12), mod.uv_sphere(0.45, 3, 6)]
    s.add_instance_lods(lods, [9.0], material=m0)
    s.add_instance_lods(lods + [mod.cube(0.2)], [6.0, 12.0], material=m1)
    return s


def test_textures_and_lods_match():
    js, ts = _scene(jmesh), _scene(tmesh)
    assert ts.any_textured and js.any_textured
    assert ts.any_lods and js.any_lods
    jd, td = js.device_arrays(), ts.device_arrays("cpu")
    for k in td:
        _eq(jd[k], td[k].numpy(), k)
        assert np.asarray(jd[k]).dtype == td[k].numpy().dtype, k
    assert set(jd) - set(td) == {"tri_pos_local", "tri_nrm_local"}
    assert td["textures"].shape == (3, 16, 16, 4)
    assert set(np.unique(td["tri_lod"].numpy())) == {0, 1, 2}
    with pytest.raises(RuntimeError):
        ts.add_texture(TEX[0])
    with pytest.raises(ValueError):
        ts.add_instance_lods([tmesh.cube(0.1)] * 2, [])


def test_transform_vertices_matches():
    js, ts = _scene(jmesh), _scene(tmesh)
    jd, td = js.device_arrays(), ts.device_arrays("cpu")
    n = 12
    pos = RNG.uniform(-3, 3, (n, 3)).astype(np.float32)
    q = RNG.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mats = np.array(jm3.compose_trs(jnp.asarray(pos), jnp.asarray(q), jnp.ones((n, 3))))
    jp, jn = jmesh.transform_vertices(jd, jnp.asarray(mats))
    tp, tn = tmesh.transform_vertices(td, torch.from_numpy(mats))
    np.testing.assert_allclose(np.asarray(jp), tp.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jn), tn.numpy(), rtol=0, atol=1e-5)


def _constants():
    eye = jnp.array([0.0, 6.0, 10.0])
    view = jm3.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    proj = jm3.perspective_reverse_z(1.0, W / H, 0.1)
    j = jcam.common_constants(eye, view, proj, jnp.array([0.4, -0.7, -0.5]),
                              (W, H), 0.0, 1.0 / 60.0)
    return j, from_jax({k: np.asarray(v) for k, v in j.items()}, "cpu")


@pytest.fixture(scope="module")
def records_inputs():
    """A textured scene, its vertex pool in world space, a random
    visibility buffer over its triangles and random 1/w."""
    js, ts = _scene(jmesh), _scene(tmesh)
    jd, td = js.device_arrays(), ts.device_arrays("cpu")
    t = td["indices"].shape[0]
    v = td["positions"].shape[0]
    wpos = RNG.uniform(-4, 4, (v, 3)).astype(np.float32)
    wnrm = RNG.normal(size=(v, 3)).astype(np.float32)
    b0 = RNG.uniform(0, 1, (H, W)).astype(np.float32)
    vis = {"tri_id": RNG.integers(-1, int(ts._t), (H, W)).astype(np.int32),
           "depth": RNG.uniform(0.01, 0.9, (H, W)).astype(np.float32), "b0": b0,
           "b1": (RNG.uniform(0, 1, (H, W)) * (1 - b0)).astype(np.float32)}
    inv_w = RNG.uniform(0.2, 2.0, (3, t)).astype(np.float32)
    return jd, td, wpos, wnrm, vis, inv_w


def _close_dicts(jg, tg, keys=None):
    for k in keys or tg:
        if tg[k].dtype in (torch.bool, torch.int32):
            _eq(jg[k], tg[k].numpy(), k)
        else:
            np.testing.assert_allclose(np.asarray(jg[k]), tg[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("constants", [True, False], ids=["constants", "vertex_pool"])
@pytest.mark.parametrize("textured", [True, False], ids=["textured", "flat"])
def test_gbuffer_records_path_matches(records_inputs, constants, textured):
    """shade_gbuffer(records=None): the records packed from the vertex
    pool's world normals and setup["inv_w"], one per-pixel gather, the
    perspective-correct weights; positions from depth or interpolated from
    the vertex pool; the texture sample where the record's index >= 0."""
    jd, td, wpos, wnrm, vis, inv_w = records_inputs
    jc, tc = _constants()
    jg = jax.jit(lambda v, iw, p, n: jgb.shade_gbuffer(
        v, {"inv_w": iw}, jd, p, n, constants=jc if constants else None,
        with_velocity=True, textures=jd["textures"] if textured else None))(
        {k: jnp.asarray(v) for k, v in vis.items()}, jnp.asarray(inv_w),
        jnp.asarray(wpos), jnp.asarray(wnrm))
    tg = tgb.shade_gbuffer({k: torch.from_numpy(v) for k, v in vis.items()},
                           {"inv_w": torch.from_numpy(inv_w)}, td, torch.from_numpy(wpos),
                           torch.from_numpy(wnrm), constants=tc if constants else None,
                           with_velocity=True,
                           textures=td["textures"] if textured else None)
    assert set(jg) == set(tg)
    _close_dicts(jg, tg)
    flat = tgb.shade_gbuffer({k: torch.from_numpy(v) for k, v in vis.items()},
                             {"inv_w": torch.from_numpy(inv_w)}, td,
                             torch.from_numpy(wpos), torch.from_numpy(wnrm),
                             constants=tc if constants else None)["base_color"]
    changed = (flat != tg["base_color"]).any(-1)
    assert changed.any() == textured               # textures change some pixels


def test_gbuffer_planes_textured_matches(records_inputs):
    """shade_gbuffer(gplanes=, textures=): the fused raster's planes with
    the texture sample on plane 14's index, wrapping uv."""
    jd, td, _, _, vis, _ = records_inputs
    jc, tc = _constants()
    g = RNG.uniform(-1.5, 2.5, (18, H, W)).astype(np.float32)
    g[14] = RNG.integers(-1, 3, (H, W))
    g[15] = RNG.integers(0, 9, (H, W))
    v = {k: vis[k] for k in ("tri_id", "depth")}
    jg = jax.jit(lambda v, g: jgb.shade_gbuffer(v, None, {}, None, None, constants=jc,
                                                gplanes=g, textures=jd["textures"]))(
        {k: jnp.asarray(x) for k, x in v.items()}, jnp.asarray(g))
    tg = tgb.shade_gbuffer({k: torch.from_numpy(x) for k, x in v.items()}, None, None, None,
                           None, constants=tc, gplanes=torch.from_numpy(g),
                           textures=td["textures"])
    assert set(jg) == set(tg)
    _close_dicts(jg, tg)
    assert not torch.equal(tg["base_color"], torch.from_numpy(g[5:8]).movedim(0, -1))


def test_lod_cull_matches():
    """The deferred cull keeps one LOD level's triangles per instance: the
    number of switch distances the instance's distance exceeds."""
    js, ts = _scene(jmesh), _scene(tmesh)
    cfg = dict(width=W, height=H, max_triangles=3000, max_vertices=3000, max_instances=12)
    jr_ = jdef.DeferredRenderer(JRenderConfig(**cfg), js)
    tr_ = tdef.DeferredRenderer(RenderConfig(**cfg), ts, "cpu")
    jc, tc = _constants()
    n = 12
    pos = np.zeros((n, 3), np.float32)
    pos[5], pos[6] = (0.0, 0.5, 4.0), (1.0, 0.5, 1.0)        # 8.1 and 10.6 from the eye
    mats = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    mats[:, :3, 3] = pos
    jd, td = js.device_arrays(), ts.device_arrays("cpu")
    jv = jax.jit(lambda m: jr_.cull_instances(jd, m, jc))(jnp.asarray(mats))
    tv = tr_.cull_instances(td, torch.from_numpy(mats), tc)
    _eq(jv, tv.numpy())
    lod = td["tri_lod"].numpy()
    inst = td["tri_instance"].numpy()
    kept = tv.numpy()
    # the chains' instances are within the frustum; each keeps one level
    assert set(np.unique(lod[kept & (inst == 5)])) == {0}
    assert set(np.unique(lod[kept & (inst == 6)])) == {1}
    assert (tr_.lod_levels(td, torch.from_numpy(mats), tc)[5:7] == torch.tensor([0, 1],
            dtype=torch.int32)).all()
