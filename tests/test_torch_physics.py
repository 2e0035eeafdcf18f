"""Parity of the port's physics (shapes, broadphase, narrowphase, solver,
the step) with `garden_tpu.physics`.

Tolerances: candidate sets compare exactly (integer work on quantized
boxes); contact manifolds to 1e-5 (float32 sums in another order); one
step of a settled pile to 1e-5 in position and orientation and 1e-4 in
velocity: eight Jacobi iterations amplify ulp-level differences in
velocity more than in the integrated pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core.config import PhysicsConfig as JPhysicsConfig
from garden_tpu.physics import broadphase as jbp
from garden_tpu.physics import narrowphase as jnp_
from garden_tpu.physics import world as jw
from garden_tpu_torch.convert import from_jax
from garden_tpu_torch.core.config import PhysicsConfig
from garden_tpu_torch.physics import broadphase as tbp
from garden_tpu_torch.physics import narrowphase as tnp
from garden_tpu_torch.physics import shapes as tsh
from garden_tpu_torch.physics import world as tw

CFG = dict(max_bodies=29, grid_dim=8, cell_size=2.0, max_contacts_per_body=7,
           solver_iterations=8, max_globals=1, max_active_contacts=16)


def _pile(mod, cfg, seed=0, n_boxes=28, jitter=0.02):
    """A plane plus a jittered 3x3-column pile of boxes (both packages get
    the same adds)."""
    rng = np.random.default_rng(seed)
    w = mod.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=mod.STATIC)
    box = w.shapes.box((0.45, 0.45, 0.45))
    for i in range(n_boxes):
        ix, iz, iy = i % 3, (i // 3) % 3, i // 9
        pos = (ix * 1.0 - 1.0 + rng.uniform(-jitter, jitter), 0.46 + iy * 0.93,
               iz * 1.0 - 1.0 + rng.uniform(-jitter, jitter))
        ang = rng.uniform(-0.05, 0.05)
        quat = (0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2))
        w.add_body(box, position=pos, rotation=quat, friction=0.5)
    return w


@pytest.fixture(scope="module")
def settled():
    """JAX state of the pile after 45 steps (contacts and warm impulses
    established) as numpy, and the jitted JAX step."""
    jcfg = JPhysicsConfig(**CFG)
    w = _pile(jw, jcfg)
    types = w.shapes.present_types()
    step = jax.jit(lambda s: jw.step(s, jcfg, 1.0 / 60.0, types))
    state = w.device_state()
    for _ in range(45):
        state = step(state)
    return jax.device_get(state), types, step


def test_world_builder_matches():
    jstate = jax.device_get(_pile(jw, JPhysicsConfig(**CFG)).device_state())
    tstate = _pile(tw, PhysicsConfig(**CFG)).device_state("cpu")
    for k, v in tstate["bodies"].items():
        np.testing.assert_array_equal(jstate["bodies"][k], v.numpy(), err_msg=k)
    for k in ("prev_pos", "prev_quat", "layer_table", "touching", "grounded"):
        np.testing.assert_array_equal(jstate[k], tstate[k].numpy(), err_msg=k)
    for k, v in tstate["warm"].items():
        np.testing.assert_array_equal(jstate["warm"][k], v.numpy(), err_msg=k)
    for k, v in tstate["shapes"].items():
        np.testing.assert_array_equal(jstate["shapes"][k], v.numpy(), err_msg=k)


def test_mass_properties_match():
    from garden_tpu.physics import shapes as jsh
    rng = np.random.default_rng(2)
    stype = np.array([1, 2, 6, 2, 1], np.int32)
    params = rng.uniform(0.1, 1.0, (5, 4)).astype(np.float32)
    dens = rng.uniform(500, 2000, 5).astype(np.float32)
    jm, ji = jsh.mass_properties(jnp.asarray(stype), jnp.asarray(params),
                                 jnp.asarray(dens))
    tm, ti = tsh.mass_properties(torch.as_tensor(stype), torch.as_tensor(params),
                                 torch.as_tensor(dens))
    np.testing.assert_allclose(jm, tm.numpy(), rtol=1e-6)
    np.testing.assert_allclose(ji, ti.numpy(), rtol=1e-6)
    jl = jsh.local_aabb(jnp.asarray(stype), jnp.asarray(params))
    tl = tsh.local_aabb(torch.as_tensor(stype), torch.as_tensor(params))
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _random_bodies(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(0.2, 3.0, n)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    stype = np.full(n, tsh.BOX, np.int32)
    stype[0] = tsh.PLANE
    params = np.tile(np.array([0.45, 0.45, 0.45, 0.05], np.float32), (n, 1))
    params[0] = (0.0, 1.0, 0.0, 0.0)
    pos[0] = 0.0
    q[0] = (0, 0, 0, 1)
    return pos, q, stype, params


@pytest.mark.parametrize("grid_dim", [8, 64], ids=["direct", "hashed"])
def test_broadphase_candidate_sets_match(grid_dim):
    n = 64
    pos, q, stype, params = _random_bodies(3, n)
    jmin, jmax = jbp.body_aabbs(jnp.asarray(pos), jnp.asarray(q),
                                jnp.asarray(stype), jnp.asarray(params),
                                margin=0.05)
    tmin, tmax = tbp.body_aabbs(torch.as_tensor(pos), torch.as_tensor(q),
                                torch.as_tensor(stype), torch.as_tensor(params),
                                margin=0.05)
    np.testing.assert_allclose(jmin, tmin.numpy(), atol=1e-6)
    np.testing.assert_allclose(jmax, tmax.numpy(), atol=1e-6)
    active = np.ones(n, bool)
    active[-3:] = False
    dynamic = np.ones(n, bool)
    dynamic[0] = False
    layer = np.where(dynamic, 1, 0).astype(np.int32)
    layer[5] = 2                                     # a sensor-layer body
    is_global = stype == tsh.PLANE
    kw = dict(cell_size=2.0, grid_dim=grid_dim, cand_per_cell=8,
              max_candidates=7, max_globals=1)
    table = jw.default_layer_table()
    find = jax.jit(jbp.find_candidates, static_argnames=tuple(kw))
    jidx, jval = find(
        jnp.asarray(pos), jmin, jmax, active=jnp.asarray(active),
        dynamic=jnp.asarray(dynamic), layer=jnp.asarray(layer),
        layer_table=jnp.asarray(table), is_global=jnp.asarray(is_global), **kw)
    t = lambda a: torch.as_tensor(np.asarray(a))
    tidx, tval = tbp.find_candidates(
        t(pos), t(jmin), t(jmax), active=t(active), dynamic=t(dynamic),
        layer=t(layer), layer_table=t(table), is_global=t(is_global), **kw)
    jidx, jval = np.asarray(jidx), np.asarray(jval)
    np.testing.assert_array_equal(jval, tval.numpy())
    np.testing.assert_array_equal(np.where(jval, jidx, -1),
                                  np.where(tval.numpy(), tidx.numpy(), -1))
    assert jval[:, 1:].sum() > n            # the pile is dense enough to test
    assert int(tidx.max()) < n              # every slot is a gatherable id


def test_narrowphase_manifolds_match():
    n = 40
    pos, q, stype, params = _random_bodies(5, n)
    pos[1:] *= 0.25                         # crowd the boxes: many overlaps
    pos[1:, 1] += 0.3
    rng = np.random.default_rng(6)
    pi = rng.integers(0, n, 300).astype(np.int32)
    pj = rng.integers(0, n, 300).astype(np.int32)
    pj[:20] = 0                             # box-plane pairs
    valid = pi != pj
    margin = rng.uniform(0.05, 0.15, n).astype(np.float32)
    types = frozenset((tsh.BOX, tsh.PLANE))
    gen = jax.jit(jnp_.generate_contacts, static_argnames=("present_types",))
    jm = gen(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(stype),
             jnp.asarray(params), jnp.asarray(pi), jnp.asarray(pj),
             jnp.asarray(valid), margin=jnp.asarray(margin), present_types=types)
    t = torch.as_tensor
    tm = tnp.generate_contacts(t(pos), t(q), t(stype), t(params), t(pi), t(pj),
                               t(valid), margin=t(margin), present_types=types)
    jv = np.asarray(jm["valid"])
    np.testing.assert_array_equal(jv, tm["valid"].numpy())
    assert jv.sum() > 100
    for k in ("point", "normal", "pen"):
        a, b = np.asarray(jm[k])[jv], tm[k].numpy()[jv]
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(np.asarray(jm["a"]), tm["a"].numpy())


def test_one_step_from_settled_pile_matches(settled):
    jstate, types, jstep = settled
    jnext = jax.device_get(jstep(jax.tree_util.tree_map(jnp.asarray, jstate)))
    tnext = tw.step(from_jax(jstate, "cpu"), PhysicsConfig(**CFG), 1.0 / 60.0,
                    types)
    jb, tb = jnext["bodies"], tnext["bodies"]
    assert np.abs(jstate["warm"]["n"]).max() > 0          # warm-started
    for k, atol in (("pos", 1e-5), ("quat", 1e-5), ("linvel", 1e-4),
                    ("angvel", 1e-4)):
        np.testing.assert_allclose(jb[k], tb[k].numpy(), rtol=0, atol=atol, err_msg=k)
    np.testing.assert_array_equal(jnext["warm"]["key"], tnext["warm"]["key"].numpy())
    np.testing.assert_array_equal(jnext["touching"], tnext["touching"].numpy())
    np.testing.assert_array_equal(jnext["grounded"], tnext["grounded"].numpy())
    np.testing.assert_allclose(jnext["warm"]["n"], tnext["warm"]["n"].numpy(),
                               rtol=0, atol=1e-3)
    assert float(tnext["time"]) == pytest.approx(float(jnext["time"]))


def test_unported_physics_raises():
    w = tw.PhysicsWorld(PhysicsConfig(**CFG))
    w.add_body(w.shapes.sphere(0.5))
    with pytest.raises(NotImplementedError):
        tw.step(w.device_state("cpu"), w.config, 1.0 / 60.0,
                w.shapes.present_types())
    small = dict(CFG, max_active_contacts=8)       # compacted collide branch
    w = _pile(tw, PhysicsConfig(**small), n_boxes=2)
    with pytest.raises(NotImplementedError):
        tw.step(w.device_state("cpu"), w.config, 1.0 / 60.0,
                w.shapes.present_types())
