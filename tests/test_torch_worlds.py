"""Parity of the port's batched worlds (`parallel/worlds.py`), split-frame
bands (`parallel/frame_tiles.py`) and the public helpers added beside them
(math3d, the blurs, `mesh.transform_triangles`, three constants) with the
JAX package, on the CPU.

Tolerances: the helpers 1e-5 absolute and relative (the JAX side's
einsums and float order differ); the worlds 1e-5 in every leaf against
JAX's `WorldBatch` (the physics tests' bar), and in every bit against the
port's own unbatched step; the band projections 1e-6; `FrameTiles`
against the port's single renderer at the reference test's config and bars
(tests/test_parallel.py: off-seam p99 <= 2 levels, mean < 0.5). vmap's
"performance drop" warning, which marks an op that vmap runs as a loop
over the worlds, is an error here.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import math3d as jm
from garden_tpu.ops import blur as jblur
from garden_tpu.parallel import frame_tiles as jft
from garden_tpu.physics import world as jpw
from garden_tpu.render import csm as jcsm
from garden_tpu.render import mesh as jmesh
from garden_tpu.utils import checkpoint as jcheckpoint
from garden_tpu_torch.convert import from_jax
from garden_tpu_torch.core import math3d as tm
from garden_tpu_torch.core.config import RenderConfig
from garden_tpu_torch.ops import blur as tblur
from garden_tpu_torch.parallel import frame_tiles as tft
from garden_tpu_torch.parallel.worlds import WorldBatch
from garden_tpu_torch.physics import world as tpw
from garden_tpu_torch.render import csm as tcsm
from garden_tpu_torch.render import mesh as tmesh
from garden_tpu_torch.render.deferred import DeferredRenderer
from garden_tpu_torch.systems.camera import common_constants
from garden_tpu_torch.utils import checkpoint as tcheckpoint
from torch_world_cases import jax_batch, leaves as _leaves, lift as _lift, port_world

TOL = dict(rtol=1e-5, atol=1e-5)
N_WORLDS, STEPS = 8, 30
RNG = np.random.default_rng(11)


# -- math3d, blur, mesh helpers and constants ---------------------------------

EULER = RNG.uniform(-3.0, 3.0, (32, 3)).astype(np.float32)
LO = RNG.uniform(-1, 0, (32, 3)).astype(np.float32)
HI = LO + RNG.uniform(0.1, 2, (32, 3)).astype(np.float32)
LO2 = LO + RNG.uniform(-1.5, 1.5, (32, 3)).astype(np.float32)
HI2 = LO2 + RNG.uniform(0.1, 2, (32, 3)).astype(np.float32)
C01 = RNG.uniform(-0.2, 1.2, (32, 3)).astype(np.float32)

HELPERS = {   # case -> (function name, numpy arguments)
    "quat_from_euler_zero": ("quat_from_euler", (np.zeros(3, np.float32),)),
    "quat_from_euler": ("quat_from_euler", (EULER,)),
    "saturate": ("saturate", (C01,)),
    "aabb_overlap": ("aabb_overlap", (LO, HI, LO2, HI2)),
    "srgb_to_linear": ("srgb_to_linear", (np.clip(C01, 0.0, 1.0),)),
}


@pytest.mark.parametrize("case", list(HELPERS))
def test_math3d_helpers_match_jax(case):
    name, args = HELPERS[case]
    ref = np.asarray(getattr(jm, name)(*(jnp.asarray(a) for a in args)))
    out = getattr(tm, name)(*(torch.as_tensor(a) for a in args)).numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


def test_identities_and_constants_match_jax():
    np.testing.assert_array_equal(tm.QUAT_IDENTITY, jm.QUAT_IDENTITY)
    np.testing.assert_array_equal(tm.quat_identity((2, 3), device="cpu").numpy(),
                                  np.asarray(jm.quat_identity((2, 3))))
    np.testing.assert_array_equal(tm.mat4_identity((5,), device="cpu").numpy(),
                                  np.asarray(jm.mat4_identity((5,))))
    assert tpw.MAX_GLOBALS == jpw.MAX_GLOBALS
    assert tcsm.NEAR_EPS == jcsm.NEAR_EPS
    assert tcheckpoint.SEP == jcheckpoint.SEP


def _box_input():
    # tests/test_shifts.py's box-blur input
    return np.random.default_rng(6).random((11, 9), np.float32)


def _bilateral_input():
    # tests/test_ui.py's depth step, with a random image over it
    depth = np.ones((32, 32), np.float32)
    depth[:, 16:] = 5.0
    img = np.random.default_rng(7).random((32, 32, 3)).astype(np.float32)
    return img, depth


@pytest.mark.parametrize("radius", [1, 2])
def test_box_blur_matches_jax(radius):
    x = _box_input()
    ref = np.asarray(jblur.box_blur(jnp.asarray(x), radius=radius))
    np.testing.assert_allclose(tblur.box_blur(torch.as_tensor(x), radius).numpy(), ref, **TOL)
    rgb = np.random.default_rng(8).random((12, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(tblur.box_blur(torch.as_tensor(rgb), radius).numpy(),
                               np.asarray(jblur.box_blur(jnp.asarray(rgb), radius)), **TOL)


@pytest.mark.parametrize("channels", [False, True], ids=["plane", "rgb"])
def test_bilateral_blur_matches_jax(channels):
    img, depth = _bilateral_input()
    if not channels:
        img = img[..., 0]
    ref = np.asarray(jblur.bilateral_blur(jnp.asarray(img), jnp.asarray(depth), radius=2))
    out = tblur.bilateral_blur(torch.as_tensor(img), torch.as_tensor(depth), 2).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    # the depth edge holds: columns 14 and 18 do not mix across it
    step = np.zeros((32, 32), np.float32)
    step[:, 16:] = 1.0
    bb = tblur.bilateral_blur(torch.as_tensor(step), torch.as_tensor(depth), 2).numpy()
    assert bb[16, 14] < 0.1 and bb[16, 18] > 0.9


def test_transform_triangles_matches_jax():
    """Three instances of three meshes under random rigid-plus-scale
    matrices; the invalid tail takes instance 0's matrix on both sides."""
    scenes = []
    for m in (jmesh, tmesh):
        s = m.SceneBuffers(512, 512, 4)
        s.add_instance(m.cube(0.5))
        s.add_instance(m.uv_sphere(0.4, 6, 8))
        s.add_instance(m.plane_grid(4.0, 2))
        scenes.append(s)
    mats = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    for i in range(3):
        q = RNG.normal(size=4).astype(np.float32)
        mats[i, :3, :3] = np.asarray(jm.quat_to_mat3(jnp.asarray(q / np.linalg.norm(q)))) \
            * RNG.uniform(0.5, 2.0, 3).astype(np.float32)
        mats[i, :3, 3] = RNG.uniform(-3, 3, 3)
    jpos, jnrm = jmesh.transform_triangles(scenes[0].device_arrays(), jnp.asarray(mats))
    tpos, tnrm = tmesh.transform_triangles(scenes[1].device_arrays("cpu"),
                                           torch.as_tensor(mats))
    assert tuple(tpos.shape) == tuple(jpos.shape) == (512, 3, 3)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(tnrm.numpy(), np.asarray(jnrm), **TOL)


# -- WorldBatch ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_worlds():
    """JAX's WorldBatch over the 8 CPU devices, 30 steps (built once)."""
    return jax_batch(N_WORLDS, STEPS)


@pytest.fixture(scope="module")
def port_worlds():
    state, step = port_world()
    wb = WorldBatch(step, N_WORLDS, devices=["cpu"])
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        batched = wb.replicate(state, vary_fn=_lift)
        for _ in range(STEPS):
            batched = wb.step(batched)
    return wb, batched, state, step


def test_world_batch_matches_jax(jax_worlds, port_worlds):
    wb, (batched,), _, _ = port_worlds       # one device: a list of one shard
    ref = dict(_leaves(jax_worlds))
    got = dict(_leaves(batched))
    assert set(got) == set(ref)
    for key, leaf in got.items():
        r = np.asarray(ref[key])
        assert tuple(leaf.shape) == r.shape, key
        if r.dtype == np.bool_ or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(leaf.numpy(), r, err_msg=key)
        else:
            np.testing.assert_allclose(leaf.numpy(), r, rtol=0, atol=1e-5, err_msg=key)
    ys = batched["bodies"]["pos"][:, 1, 1]
    assert len(np.unique(ys.numpy().round(4))) > 4 and bool((ys < 3.8).all())


def test_world_batch_equals_the_unbatched_step(port_worlds):
    """Worlds 0, 3 and 7 stepped alone give the batch's bits."""
    wb, (batched,), state, step = port_worlds
    for i in (0, 3, 7):
        s = _lift(state, torch.tensor(i, dtype=torch.int32))
        for _ in range(STEPS):
            s = step(s)
        one = dict(_leaves(s))
        for key, leaf in _leaves(batched):
            assert torch.equal(leaf[i], one[key]), (i, key)


def test_world_batch_reduce_stack_and_world(port_worlds):
    wb, shards, state, _ = port_worlds
    y = shards[0]["bodies"]["pos"][:, 1, 1]
    fn = lambda s: s["bodies"]["pos"][1, 1]
    assert abs(float(wb.reduce(shards, fn)) - float(y.mean())) < 1e-5
    assert float(wb.reduce(shards, fn, "sum")) == pytest.approx(float(y.sum()), abs=1e-5)
    assert float(wb.reduce(shards, fn, "max")) == float(y.max())
    assert float(wb.reduce(shards, fn, "min")) == float(y.min())
    w0 = wb.world(shards, 0)
    assert isinstance(w0["bodies"]["pos"], np.ndarray) and w0["bodies"]["pos"].shape == (16, 3)
    np.testing.assert_array_equal(w0["bodies"]["pos"], shards[0]["bodies"]["pos"][0].numpy())
    (stacked,) = wb.stack([state] * N_WORLDS)
    for key, leaf in _leaves(stacked):
        assert tuple(leaf.shape) == (N_WORLDS,) + tuple(dict(_leaves(state))[key].shape)


# -- split-frame bands --------------------------------------------------------------


def _vp():
    view = jm.look_at(jnp.array([0.0, 1.5, 4.0]), jnp.array([0.0, 0.5, 0.0]),
                      jnp.array([0.0, 1.0, 0.0]))
    return np.asarray(jm.perspective_reverse_z(1.0, 2.0, 0.1) @ view)


@pytest.mark.parametrize("band", [0, 1, 3])
def test_band_constants_match_jax(band):
    vp = _vp()
    y0, y1 = -0.4, 0.7
    np.testing.assert_allclose(tft.crop_projection(torch.tensor(vp), y0, y1).numpy(),
                               np.asarray(jft.crop_projection(jnp.asarray(vp), y0, y1)),
                               rtol=1e-6, atol=1e-6)
    consts = {"view_proj": vp, "inv_view_proj": np.linalg.inv(vp).astype(np.float32),
              "time": np.float32(0.0)}
    ref = jft.band_constants({k: jnp.asarray(v) for k, v in consts.items()}, band, 4, 0.25)
    out = tft.band_constants(from_jax(consts, "cpu"), band, 4, 0.25)
    assert set(out) == set(ref)
    for k in ("view_proj", "inv_view_proj"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6)


def _parallel_test_frame(device):
    """tests/test_parallel.py's split-frame scene and camera on the port."""
    cfg = RenderConfig(width=128, height=64, tile_size=128, tile_h=8,
                       max_vertices=2048, max_triangles=2048,
                       max_instances=8, use_bloom=False, use_fxaa=False,
                       use_auto_exposure=False, use_hbao=False,
                       use_shadows=True, use_clouds=False)
    scene = tmesh.SceneBuffers(2048, 2048, 8)
    red = scene.add_material(tmesh.Material(base_color=(0.9, 0.1, 0.1)))
    grey = scene.add_material(tmesh.Material(base_color=(0.5, 0.5, 0.5), roughness=0.9))
    scene.add_instance(tmesh.cube(0.5), material=red)
    scene.add_instance(tmesh.plane_grid(20.0, 4), material=grey)
    v = lambda *c: torch.tensor(c, dtype=torch.float32, device=device)
    eye = v(0.0, 1.5, 4.0)
    view = tm.look_at(eye, v(0.0, 0.5, 0.0), v(0.0, 1.0, 0.0))
    proj = tm.perspective_reverse_z(1.0, cfg.width / cfg.height, 0.1, device=device)
    constants = common_constants(eye, view, proj, v(0.3, -0.8, -0.4),
                                 (cfg.width, cfg.height), 0.0, 1.0 / 60.0)
    mats = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    mats[0][1, 3] = 0.5
    return cfg, scene, constants, torch.as_tensor(mats, device=device)


def test_frame_tiles_match_the_single_renderer():
    """4 bands over ["cpu"] * 4 stitch into the single renderer's image off
    the seams, under the reference test's bars; the next state's exposure
    is one mean over the bands, and a second frame from it runs clean."""
    cfg, scene, constants, mats = _parallel_test_frame("cpu")
    single = DeferredRenderer(cfg, scene, "cpu")
    ref = single.render(single.device_scene(), mats, constants,
                        single.initial_frame_state())["image"].numpy()
    ft = tft.FrameTiles(cfg, scene, n_bands=4, overlap=8, devices=["cpu"] * 4)
    assert ft.overlap == 8 and ft.config.height == 16 + 16
    img, state = ft.render(ft.renderer.device_scene(), mats, constants, ft.initial_state())
    img = img.numpy()
    assert img.shape == ref.shape
    band_h = cfg.height // 4
    seam = {r for b in range(1, 4) for r in range(b * band_h - 2, b * band_h + 2)}
    rows = [r for r in range(cfg.height) if r not in seam]
    diff = np.abs(img[rows].astype(int) - ref[rows].astype(int))
    assert np.percentile(diff, 99) <= 2, float(np.percentile(diff, 99))
    assert diff.mean() < 0.5, diff.mean()
    lum = [float(s["avg_luminance"]) for s in state]
    assert len(lum) == 4 and len(set(lum)) == 1 and np.isfinite(lum[0])
    img2, _ = ft.render(ft.renderer.device_scene(), mats, constants, state)
    assert img2.shape == img.shape


def test_frame_tiles_checks_its_arguments():
    cfg, scene, _, _ = _parallel_test_frame("cpu")
    with pytest.raises(ValueError, match="bands"):
        tft.FrameTiles(cfg, scene, n_bands=4, overlap=8, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="divide"):
        tft.FrameTiles(cfg, scene, n_bands=3, overlap=8, devices=["cpu"] * 3)
    # guard rows round up to the raster tile height, as the reference's
    assert tft.FrameTiles(cfg, scene, n_bands=2, overlap=5, devices=["cpu"] * 2).overlap == 8
