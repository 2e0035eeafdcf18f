"""Parity of the port's forward path with `garden_tpu`: vertex-pool setup
(`raster.setup_triangles`), slot binning with `max_active`, `render_pass`
on square 128x128 tiles (the visibility raster, JAX's Pallas kernel in
interpret mode) and the whole `ForwardRenderer` frame, at 256x128. The
JAX side's transform, setup and raster run eagerly: jitted, XLA contracts
the setup into fused multiply-adds, which moves ~0.3% of the edge pixels
(measured). The binning (integer work) and the shading after the raster
run jitted, one compile each.

Tolerances: binning (lists, counts, the big list, act_ids with their tie
order) is exact; setup fields to 1e-5; `render_pass` tri_id on >= 99.9%
of pixels (measured: every pixel) and depth within 1e-5 where both agree; the frame's tri_id on
>= 99.9% of pixels and its uint8 image within 2 levels on >= 99.5% (measured:
every pixel).
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import math3d as jm3
from garden_tpu.core.config import RenderConfig as JRenderConfig
from garden_tpu.render import forward as jfwd
from garden_tpu.render import gbuffer as jgbuf
from garden_tpu.render import lighting as jlight
from garden_tpu.render import mesh as jmesh
from garden_tpu.render import raster as jr
from garden_tpu.systems import camera as jcam
from garden_tpu_torch.convert import from_jax
from garden_tpu_torch.core.config import RenderConfig
from garden_tpu_torch.render import forward as tfwd
from garden_tpu_torch.render import mesh as tmesh
from garden_tpu_torch.render import raster as tr

W, H = 256, 128


def _scene(mod):
    """A ground grid, 8 boxes and 8 spheres of two materials."""
    s = mod.SceneBuffers(4000, 6000, 20)
    m0 = s.add_material(mod.Material(base_color=(0.8, 0.3, 0.2), metallic=0.3))
    m1 = s.add_material(mod.Material(base_color=(0.5, 0.5, 0.5), roughness=0.7))
    s.add_instance(mod.plane_grid(20.0, 8), material=m1)
    for k in range(16):
        s.add_instance(mod.cube(0.6) if k % 2 else mod.uv_sphere(0.6, 8, 16),
                       material=m0)
    return s


def _mats(n, seed=3):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([np.zeros((1, 3)), np.stack(
        [rng.uniform(-5, 5, n - 1), rng.uniform(0.3, 2.5, n - 1),
         rng.uniform(-4, 3, n - 1)], -1)]).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[0] = (0, 0, 0, 1)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.array(jax.jit(jm3.compose_trs)(jnp.asarray(pos), jnp.asarray(q),
                                             jnp.ones((n, 3))))


@jax.jit
def _j_constants():
    eye = jnp.array([0.0, 6.0, 10.0])
    view = jm3.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    proj = jm3.perspective_reverse_z(1.0, W / H, 0.1)
    return jcam.common_constants(eye, view, proj, jnp.array([0.4, -0.7, -0.5]),
                                 (W, H), 0.0, 1.0 / 60.0)


def _constants():
    """The camera's constants, built once by JAX and given to both."""
    j = _j_constants()
    return j, from_jax({k: np.asarray(v) for k, v in j.items()}, "cpu")


@pytest.fixture(scope="module")
def clip():
    """Clip-space vertex pools of the scene in both packages, from the
    same instance matrices and camera."""
    js, ts = _scene(jmesh), _scene(tmesh)
    jd, td = js.device_arrays(), ts.device_arrays("cpu")
    mats = _mats(17)
    jc, tc = _constants()
    jp, _ = jmesh.transform_vertices(jd, jnp.asarray(mats))
    tp, _ = tmesh.transform_vertices(td, torch.from_numpy(mats))
    return (jd, td, jm3.apply_mat4_h(jc["view_proj"], jp),
            tmesh.m3.apply_mat4_h(tc["view_proj"], tp), mats, jc, tc)


def test_default_footprint_is_reference():
    assert tr.FOOT == jr.FOOT == 4


def test_setup_triangles_matches(clip):
    jd, td, jclip, tclip = clip[:4]
    valid = np.asarray(jd["tri_valid"]).copy()
    valid[::7] = False
    js = jr.setup_triangles(jclip, jd["indices"], jnp.asarray(valid), W, H)
    ts = tr.setup_triangles(tclip, td["indices"], torch.from_numpy(valid), W, H)
    for k in ("sx", "sy", "z", "inv_w", "inv_area", "xmin", "xmax", "ymin", "ymax"):
        np.testing.assert_allclose(np.asarray(js[k]), ts[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(np.asarray(js["valid"]), ts["valid"].numpy())
    assert 0 < int(ts["valid"].sum()) < valid.sum()
    # the (T, 3, 4) gathered form is the same setup
    tv = tr.setup_triangles_tv(tclip[td["indices"].long()], torch.from_numpy(valid), W, H)
    for k in ts:
        assert torch.equal(tv[k], ts[k]), k


_j_bin = jax.jit(jr.bin_triangles, static_argnums=(1, 2, 3, 4),
                 static_argnames=("max_big", "foot", "tile_h", "foot_y", "max_active"))


@pytest.mark.parametrize("tile,tile_h,max_active", [(128, 128, None), (128, 128, 3),
                                                    (64, 16, 9), (64, 16, 40)])
def test_bin_triangles_max_active_matches(clip, tile, tile_h, max_active):
    """Lists, counts, the big list and act_ids equal, the tie order among
    equal counts included (ties to the higher tile index)."""
    jd, td, jclip, tclip = clip[:4]
    js = jr.setup_triangles(jclip, jd["indices"], jd["tri_valid"], W, H)
    ts = tr.setup_triangles(tclip, td["indices"], td["tri_valid"], W, H)
    kw = dict(max_big=16, tile_h=tile_h, max_active=max_active)
    jb = _j_bin(js, W, H, tile, 24, **kw)
    tb = tr.bin_triangles(ts, W, H, tile, 24, **kw)
    assert len(jb) == len(tb) == (3 if max_active is None else 4)
    for j, t, name in zip(jb, tb, ("tile_tris", "counts", "big_list", "act_ids")):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    if max_active:
        counts = tb[1].numpy()
        ties = [c for c in set(counts.tolist()) if (counts == c).sum() > 1]
        assert ties or max_active <= 3                # equal counts ranked alike


_j_gbuf = jax.jit(jgbuf.shade_gbuffer, static_argnames=("with_velocity",))
_j_resolve = jax.jit(jlight.resolve)


@pytest.fixture(scope="module")
def frames(clip):
    """One forward frame of each package (exposure 1.3, with its HDR)."""
    jd, td, _, _, mats, jc, tc = clip
    cfg = dict(width=W, height=H, max_triangles=6000, max_vertices=4000,
               max_instances=20, max_tris_per_tile=512)
    jren = jfwd.ForwardRenderer(JRenderConfig(**cfg), _scene(jmesh), use_hdr=True)
    tren = tfwd.ForwardRenderer(RenderConfig(**cfg), _scene(tmesh), "cpu", use_hdr=True)
    # the binning jitted (integer work after one division per bound: one
    # compile instead of one per op, the same result), and the shading
    # after the raster (one compile each instead of one per op)
    mp = pytest.MonkeyPatch()
    mp.setattr(jr, "bin_triangles", _j_bin)
    mp.setattr(jgbuf, "shade_gbuffer", _j_gbuf)
    mp.setattr(jlight, "resolve", _j_resolve)
    try:
        jout = jax.device_get(jren.render(jd, jnp.asarray(mats), jc, exposure=1.3))
    finally:
        mp.undo()
    tout = tren.render(tren.device_scene(), torch.from_numpy(mats), tc, exposure=1.3)
    return jout, tout


def test_render_pass_matches_on_square_tiles(clip, frames):
    """K5's second user: slot binning into 128x128 tiles (512 slots and
    the 64-slot big list), then the visibility raster; the reference's
    render_pass is the one inside its forward frame."""
    td, tclip = clip[1], clip[3]
    jout = frames[0]
    launches = tr.rasterize_visibility.launches
    tvis, tset = tr.render_pass(tclip, td["indices"], td["tri_valid"], W, H, 128, 512)
    assert tr.rasterize_visibility.launches == launches       # CPU: the plain version
    jt, tt = jout["tri_id"], tvis["tri_id"].numpy()
    same = jt == tt
    assert same.mean() >= 0.999
    hit = same & (tt >= 0)
    assert hit.mean() > 0.2
    np.testing.assert_allclose(jout["depth"][hit], tvis["depth"].numpy()[hit],
                               rtol=0, atol=1e-5)
    assert tset["valid"].sum() > 0
    assert torch.equal(tvis["tri_id"], frames[1]["tri_id"])


def test_forward_renderer_matches_reference(frames):
    jout, tout = frames
    assert tout["image"].shape == (H, W, 3) and tout["image"].dtype == torch.uint8
    assert (jout["tri_id"] == tout["tri_id"].numpy()).mean() >= 0.999
    d = np.abs(jout["image"].astype(int) - tout["image"].numpy().astype(int)).max(-1)
    assert (d <= 2).mean() >= 0.995
    assert (tout["tri_id"] >= 0).float().mean() > 0.2
    assert set(tout) == set(jout) == {"image", "depth", "tri_id", "hdr"}
