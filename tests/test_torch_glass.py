"""The glass step: `entry.build(box_materials=GLASS_BOXES,
cfg_overrides=GLASS_OVERRIDES)`, the flagship frame whose boxes take, in
rotation, opaque, OIT, sorted and refractive materials, with trans-depth
on, against the same step built with the JAX package from a copy of
`__graft_entry__._build`'s recipe with the same material rotation, at 32
bodies and 256x128 with the flagship's split shadows cut to 256/128/128.
The JAX step runs jitted, its Pallas kernels in interpret mode.

Tolerances, as tests/test_torch_flagship.py: tri_id on >= 99.9% of pixels
(measured 100%); the uint8 image within 2 levels on >= 99.5% (measured
99.97%); the shadow factor, now (H, W, 3) with the translucent tint, within
1e-4 on >= 99.5% of pixels (measured: every pixel, max |d| 7.0e-6);
trans-depth with the same coverage on >= 99.9% of pixels and within 1e-5
where both cover (measured: identical coverage, max |d| 6.1e-9); bodies to
1e-5 (measured: equal).
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu_torch import entry
from garden_tpu_torch.core.config import ShadowConfig
from garden_tpu_torch.render import oit, raster

SIZE = dict(n_bodies=32, width=256, height=128, grid_dim=8)
SHADOW = dict(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
              atlas_foot_y=2, max_active_tiles=24)


def _jax_glass_build(n_bodies, width, height, grid_dim, shadow_kw):
    """`__graft_entry__._build`'s recipe, with dynamic box k taking the
    k % 8-th material of the glass rotation and trans-depth on."""
    from garden_tpu.core import math3d as m3
    from garden_tpu.core.config import PhysicsConfig, RenderConfig
    from garden_tpu.core.config import ShadowConfig as JShadowConfig
    from garden_tpu.physics import world as pw
    from garden_tpu.render import mesh as rmesh
    from garden_tpu.render.deferred import DeferredRenderer
    from garden_tpu.systems.camera import common_constants

    pcfg = PhysicsConfig(max_bodies=n_bodies, grid_dim=grid_dim, cell_size=2.0,
                         max_contacts_per_body=7, solver_iterations=8,
                         max_globals=1, max_active_contacts=16)
    w = pw.PhysicsWorld(pcfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=pw.STATIC)
    box = w.shapes.box((0.45, 0.45, 0.45))
    n_dyn = n_bodies - 1
    side = max(int(round(n_dyn ** (1.0 / 3.0))), 1)
    count = 0
    for iy in range(n_dyn // (side * side) + 2):
        for iz in range(side):
            for ix in range(side):
                if count >= n_dyn:
                    break
                w.add_body(box, position=(ix * 1.05 - side / 2, 0.5 + iy * 1.05,
                                          iz * 1.05 - side / 2), friction=0.5)
                count += 1
    cube_mesh = rmesh.cube(0.45)
    ground = rmesh.plane_grid(max(side * 2.0, 20.0), 4)
    rcfg = RenderConfig(
        width=width, height=height, tile_size=128,
        max_vertices=n_dyn * cube_mesh.vertex_count + ground.vertex_count,
        max_triangles=n_dyn * cube_mesh.triangle_count + ground.triangle_count,
        max_tris_per_tile=512, max_instances=n_dyn + 1,
        shadow=JShadowConfig(**shadow_kw), tile_h=32, foot_y=2,
        use_trans_depth=True)
    scene = rmesh.SceneBuffers(rcfg.max_vertices, rcfg.max_triangles,
                               rcfg.max_instances)
    opaque = rmesh.Material(base_color=(0.8, 0.3, 0.2))
    glass = (opaque,
             rmesh.Material(base_color=(0.6, 0.8, 1.0), roughness=0.1, alpha=0.35,
                            blend_mode="oit"),
             opaque,
             rmesh.Material(base_color=(0.2, 0.9, 0.3), alpha=0.5, blend_mode="sorted"),
             opaque,
             rmesh.Material(base_color=(0.9, 1.0, 0.9), roughness=0.1,
                            blend_mode="refract"),
             opaque, opaque)
    rows = {}
    for m in glass:
        if m not in rows:
            rows[m] = scene.add_material(m)
    gmat = scene.add_material(rmesh.Material(base_color=(0.5, 0.5, 0.5)))
    scene.add_instance(ground, material=gmat)
    for k in range(n_dyn):
        scene.add_instance(cube_mesh, material=rows[glass[k % 8]])
    renderer = DeferredRenderer(rcfg, scene)
    eye = jnp.array([0.0, side * 0.9 + 4.0, side * 1.6 + 8.0])
    view = m3.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    proj = m3.perspective_reverse_z(1.0, width / height, 0.1)
    constants = common_constants(eye, view, proj, jnp.array([0.4, -0.7, -0.5]),
                                 (width, height), 0.0, 1.0 / 60.0)
    state = {"physics": w.device_state(), "frame": renderer.initial_frame_state()}
    dev_scene = renderer.device_scene()
    types = w.shapes.present_types()

    def step(state):
        phys = pw.step(state["physics"], pcfg, 1.0 / 60.0, types)
        pos, quat = phys["bodies"]["pos"], phys["bodies"]["quat"]
        inst_mats = m3.compose_trs(pos[: n_dyn + 1], quat[: n_dyn + 1],
                                   jnp.ones((n_dyn + 1, 3)))
        inst_mats = inst_mats.at[0].set(jnp.eye(4))
        out = renderer.render(dev_scene, inst_mats, constants, state["frame"])
        return {"physics": phys, "frame": out["frame_state"]}, out["image"]

    return step, state, renderer


def _reference():
    jstep, jstate, renderer = _jax_glass_build(**SIZE, shadow_kw=SHADOW)
    seen = {}
    render = renderer.render

    def spy(*args, **kw):
        out = render(*args, **kw)
        seen.update(out)
        return out
    renderer.render = spy

    def step(state):
        nxt, img = jstep(state)
        return nxt, img, {k: seen[k] for k in ("shadow", "tri_id", "trans_depth")}
    return jax.device_get(jax.jit(step)(jstate))


@pytest.fixture(scope="module")
def both():
    jnext, jimg, jout = _reference()
    tstep, tstate = entry.build(**SIZE, box_materials=entry.GLASS_BOXES,
                                cfg_overrides=dict(entry.GLASS_OVERRIDES,
                                                   shadow=ShadowConfig(**SHADOW)),
                                device="cpu")
    seen = {}
    render = tstep.renderer.render

    def spy(*args, **k):
        out = render(*args, **k)
        seen.update(out)
        return out
    tstep.renderer.render = spy
    fns = (raster.rasterize_visibility_shaded, raster.rasterize_visibility,
           raster.rasterize_sorted_blend, oit.rasterize_oit, raster.depth_dense,
           raster.depth_super, raster.depth_grid)
    before = [f.launches for f in fns]
    tnext, timg = tstep(tstate)
    assert [f.launches for f in fns] == before          # CPU: plain versions
    return (jnext, jimg, jout), (tnext, timg, seen), tstep


def test_glass_step_matches_reference(both):
    (jnext, jimg, jout), (tnext, timg, tout), _ = both
    assert timg.shape == (128, 256, 3) and timg.dtype == torch.uint8
    for k in ("pos", "quat"):
        np.testing.assert_allclose(jnext["physics"]["bodies"][k],
                                   tnext["physics"]["bodies"][k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert (jout["tri_id"] == tout["tri_id"].numpy()).mean() >= 0.999
    d = np.abs(jimg.astype(int) - timg.numpy().astype(int)).max(-1)
    assert (d <= 2).mean() >= 0.995


def test_glass_shadow_and_trans_depth_match_reference(both):
    (_, _, jout), (_, _, tout), _ = both
    js, ts = jout["shadow"], tout["shadow"].numpy()
    assert js.shape == ts.shape == (128, 256, 3)
    assert (np.abs(js - ts).max(-1) <= 1e-4).mean() >= 0.995
    jt, tt = jout["trans_depth"], tout["trans_depth"].numpy()
    assert jt.shape == tt.shape == (128, 256)
    assert ((jt > 0) == (tt > 0)).mean() >= 0.999
    cov = (jt > 0) & (tt > 0)
    assert np.abs(jt[cov] - tt[cov]).max(initial=0.0) <= 1e-5


def test_glass_frame_runs_every_nonopaque_pass(both):
    """The frame really ran the chain: OIT reveal < 1 somewhere, the
    refraction pass covers pixels, trans-depth covers pixels, the
    translucent atlas tints texels, and the shadow takes a colour."""
    _, (_, _, tout), tstep = both
    tr_out = tout["translucent"]
    assert (tr_out["reveal"] < 1).any()
    assert (tr_out["refract_tri_id"] >= 0).sum() > 20
    assert (tout["trans_depth"] > 0).sum() > 50
    assert (tr_out["trans_atlas"][..., :3] < 1).any()
    ren = tstep.renderer
    assert ren.any_translucent and ren.any_sorted and ren.any_refract
    # the opaque raster leaves every non-opaque box out
    inst = tout["gbuffer"]["instance"]
    assert not torch.isin(inst[inst > 0] % 8, torch.tensor([2, 4, 6])).any()


def test_default_build_has_no_nonopaque_content():
    """Without box_materials the step is the flagship's: the box material
    in row 0, the ground's in row 1, every box on row 0, and no non-opaque
    pass."""
    step, _ = entry.build(8, 64, 32, grid_dim=4, device="cpu")
    host = step.renderer.scene_host
    assert host._m == 2 and (host.inst_material[1:8] == 0).all()
    np.testing.assert_array_equal(host.materials[0, 0:3], np.float32([0.8, 0.3, 0.2]))
    ren = step.renderer
    assert not (ren.any_translucent or ren.any_sorted or ren.any_refract)
