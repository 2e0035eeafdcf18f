"""Parity of the port's physics (shapes, broadphase, narrowphase, solver,
the step, both collide branches, joints, sleep, the accumulator, the
queries) with `garden_tpu.physics`. The pair families of every shape type
are in test_torch_contacts.py, the golden scenes in test_torch_golden.py.

Tolerances: candidate sets compare exactly (integer work on quantized
boxes); contact manifolds to 1e-5 (float32 sums in another order); one
step of a settled pile to 1e-5 in position and orientation and 1e-4 in
velocity: eight Jacobi iterations amplify ulp-level differences in
velocity more than in the integrated pose. Each test states its own.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

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
from garden_tpu_torch.physics import scenes
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
    """What still raises: a dynamic mesh body, as in the reference (a mesh
    collider is static or kinematic)."""
    w = tw.PhysicsWorld(PhysicsConfig(**CFG))
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    mesh = w.shapes.mesh(v, np.array([[0, 1, 2]], np.int32))
    with pytest.raises(ValueError):
        w.add_body(mesh, motion=tw.DYNAMIC)
    w.add_body(mesh, motion=tw.STATIC)


# -- the compacted branch, joints, sleep, the accumulator, queries ------------


def _mixed_pile(mod, cfg, n=6, seed=4):
    """A plane and alternating boxes and spheres in a loose column."""
    rng = np.random.default_rng(seed)
    w = mod.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=mod.STATIC)
    box, sph = w.shapes.box((0.4, 0.4, 0.4)), w.shapes.sphere(0.4)
    for i in range(n):
        w.add_body(box if i % 2 == 0 else sph,
                   position=(0.3 * (i % 3) - 0.3 + rng.uniform(-0.02, 0.02),
                             0.45 + 0.85 * i, rng.uniform(-0.02, 0.02)),
                   friction=0.5, restitution=0.1)
    return w


COMPACT = dict(max_bodies=8, grid_dim=8, cell_size=2.0, max_contacts_per_body=6,
               max_globals=2, max_active_contacts=4)


def test_compacted_step_matches():
    """The compacted collide branch (2 kept pairs of 8 candidates per row):
    collide's rows and one step from a state with warm impulses equal JAX's
    (positions 1e-5, velocities 1e-4 as above; the compaction is exact)."""
    jcfg, tcfg = JPhysicsConfig(**COMPACT), PhysicsConfig(**COMPACT)
    w = _mixed_pile(jw, jcfg)
    types = w.shapes.present_types()
    step = jax.jit(lambda s: jw.step(s, jcfg, 1.0 / 60.0, types))
    state = w.device_state()
    for _ in range(40):
        state = step(state)
    jstate = jax.device_get(state)
    tstate = from_jax(jstate, "cpu")
    jc = jax.device_get(jax.jit(lambda s: jw.collide(s, jcfg, types))(state))
    tc = tw.collide(tstate, tcfg, types)
    assert tc["pair_partner"].shape == (8, 2)
    np.testing.assert_array_equal(jc["valid"], tc["valid"].numpy())
    np.testing.assert_array_equal(jc["pair_partner"], tc["pair_partner"].numpy())
    v = jc["valid"]
    assert v.sum() > 8
    for k in ("point", "normal", "pen"):
        np.testing.assert_allclose(jc[k][v], tc[k].numpy()[v], atol=1e-5, err_msg=k)
    jnext = jax.device_get(step(state))
    tnext = tw.step(tstate, tcfg, 1.0 / 60.0, types)
    assert np.abs(jstate["warm"]["n"]).max() > 0
    for k, atol in (("pos", 1e-5), ("quat", 1e-5), ("linvel", 1e-4), ("angvel", 1e-4)):
        np.testing.assert_allclose(jnext["bodies"][k], tnext["bodies"][k].numpy(),
                                   rtol=0, atol=atol, err_msg=k)
    np.testing.assert_array_equal(jnext["warm"]["key"], tnext["warm"]["key"].numpy())


def test_compaction_free_path_matches_compacted():
    """Twin of the reference's test: where the budget drops nothing, both
    branches give the same trajectory (120 steps, 1e-4)."""
    base = dict(max_bodies=8, grid_dim=8, cell_size=2.0, max_contacts_per_body=4,
                max_globals=1)

    def trajectory(active):
        cfg = PhysicsConfig(**base, max_active_contacts=active)
        w = tw.PhysicsWorld(cfg)
        w.add_body(w.shapes.plane((0.0, 1.0, 0.0), 0.0), motion=tw.STATIC)
        box, sphere = w.shapes.box((0.4, 0.4, 0.4)), w.shapes.sphere(0.4)
        for i in range(3):
            w.add_body(box if i % 2 == 0 else sphere, position=(0.05 * i, 0.45 + 0.95 * i, 0.0),
                       friction=0.5, restitution=0.1)
        state = w.device_state("cpu")
        for _ in range(120):
            state = tw.step(state, cfg, 1.0 / 60.0, w.shapes.present_types())
        return state["bodies"]["pos"].numpy()

    np.testing.assert_allclose(trajectory(10), trajectory(4), atol=1e-4)


def _joint_bodies(seed=7, n=6):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    inv_mass = rng.uniform(0.2, 2.0, n).astype(np.float32)
    inv_mass[0] = 0.0                                   # a static anchor
    inv_inertia = rng.uniform(0.5, 3.0, (n, 3)).astype(np.float32)
    inv_inertia[0] = 0.0
    return {"pos": rng.uniform(-1, 1, (n, 3)).astype(np.float32), "quat": q,
            "linvel": rng.normal(size=(n, 3)).astype(np.float32),
            "angvel": rng.normal(size=(n, 3)).astype(np.float32),
            "inv_mass": inv_mass, "inv_inertia": inv_inertia,
            "linear_factor": np.ones((n, 3), np.float32),
            "angular_factor": np.ones((n, 3), np.float32)}


def test_constraint_solve_and_projection_match():
    """Point and fixed joints, a body in three of them: the velocity solve
    and the positional projection equal JAX's within 1e-5 (impulse sums in
    another order: a dense product against segment sums)."""
    from garden_tpu.physics import constraints as jcon
    from garden_tpu_torch.physics import constraints as tcon
    bodies = _joint_bodies()
    tables = []
    for mod in (jcon, tcon):
        t = mod.ConstraintTable(8)
        t.point(0, 1, (0.2, 0.5, 0.0), bodies["pos"][0], bodies["quat"][0],
                bodies["pos"][1], bodies["quat"][1])
        t.point(1, 2, (0.0, 0.1, 0.3), bodies["pos"][1], bodies["quat"][1],
                bodies["pos"][2], bodies["quat"][2])
        t.add(mod.FIXED, 1, 3, anchor_a=(0.1, 0.0, 0.0), anchor_b=(-0.1, 0.2, 0.0),
              rel_quat=(0.0, 0.2, 0.0, 0.98))
        t.add(mod.FIXED, 4, 5, anchor_a=(0.0, 0.3, 0.0), anchor_b=(0.0, -0.3, 0.0))
        tables.append(t)
    for k in ("kind", "body_a", "body_b", "rel_quat", "active"):
        np.testing.assert_array_equal(getattr(tables[0], k), getattr(tables[1], k))
    for k in ("anchor_a", "anchor_b"):
        np.testing.assert_allclose(getattr(tables[0], k), getattr(tables[1], k), atol=1e-7)
    jcons = jax.device_get(tables[0].device_arrays())
    tcons = tables[1].device_arrays("cpu")
    tcons["anchor_a"], tcons["anchor_b"] = (torch.as_tensor(jcons["anchor_a"]),
                                            torch.as_tensor(jcons["anchor_b"]))
    jb = {k: jnp.asarray(v) for k, v in bodies.items()}
    tb = {k: torch.as_tensor(v) for k, v in bodies.items()}
    jl, ja = jax.jit(lambda b, c: jcon.solve_constraints(b, c, 1 / 60, iterations=6))(jb, jcons)
    tl, ta = tcon.solve_constraints(tb, tcons, 1 / 60, iterations=6)
    np.testing.assert_allclose(jl, tl.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ja, ta.numpy(), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(jl) - bodies["linvel"]).max() > 0.1      # it did work
    jp = jax.jit(lambda p, b, c: jcon.project_positions(p, b, c, iterations=2))(
        jb["pos"], jb, jcons)
    tp = tcon.project_positions(tb["pos"], tb, tcons, iterations=2)
    np.testing.assert_allclose(jp, tp.numpy(), rtol=0, atol=1e-5)


def _sleep_world(mod, cfg):
    w = mod.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=mod.STATIC)
    box = w.shapes.box((0.5, 0.5, 0.5))
    b0 = w.add_body(box, position=(0, 0.5, 0), friction=0.6)
    b1 = w.add_body(box, position=(0, 1.5, 0), friction=0.6)
    proj = w.add_body(w.shapes.sphere(0.4), position=(-30.0, 1.5, 0.0),
                      mass_override=200.0)
    return w, (b0, b1, proj)


def test_sleep_freezes_and_wakes_on_impact():
    """Twin of the reference's sleep tests on the port, each step against
    JAX: a settled stack falls asleep and holds its pose bit for bit; a
    projectile wakes it and knocks the top box off. Sleep flags equal
    JAX's at every step, positions within 1e-4."""
    kw = dict(max_bodies=8, grid_dim=16, cell_size=2.0, sleep_enabled=True)
    jcfg, tcfg = JPhysicsConfig(**kw), PhysicsConfig(**kw)
    jwld, (b0, b1, proj) = _sleep_world(jw, jcfg)
    twld, _ = _sleep_world(tw, tcfg)
    types = jwld.shapes.present_types()
    jstep = jax.jit(lambda s: jw.step(s, jcfg, 1.0 / 60.0, types))
    js, ts = jwld.device_state(), twld.device_state("cpu")

    def run(js, ts, n):
        for _ in range(n):
            js, ts = jstep(js), tw.step(ts, tcfg, 1.0 / 60.0, types)
            np.testing.assert_array_equal(np.asarray(js["bodies"]["sleeping"]),
                                          ts["bodies"]["sleeping"].numpy())
        np.testing.assert_allclose(np.asarray(js["bodies"]["pos"]),
                                   ts["bodies"]["pos"].numpy(), atol=1e-4)
        return js, ts
    js, ts = run(js, ts, 90)
    assert bool(ts["bodies"]["sleeping"][b1]), "the stack never slept"
    held = ts["bodies"]["pos"][b1].clone()
    js, ts = run(js, ts, 5)
    assert torch.equal(ts["bodies"]["pos"][b1], held)
    assert float(ts["bodies"]["linvel"][b1].abs().max()) == 0.0
    # fire the projectile at the top box
    jb = dict(js["bodies"], linvel=js["bodies"]["linvel"].at[proj].set(
        jnp.array([25.0, 0.0, 0.0])), pos=js["bodies"]["pos"].at[proj].set(
        jnp.array([-3.0, 1.5, 0.0])))
    js = dict(js, bodies=jb)
    ts = from_jax(jax.device_get(js), "cpu")
    js, ts = run(js, ts, 30)
    pos, vel = ts["bodies"]["pos"].numpy(), ts["bodies"]["linvel"].numpy()
    assert pos[b1, 0] > 0.3 or abs(vel[b1, 0]) > 0.5, (pos[b1], vel[b1])


def test_simulate_accumulator_and_interpolation():
    """Twin of the reference's test on the port, and each tick against
    JAX's simulate (state within 1e-6; nothing is read back mid-tick)."""
    kw = dict(max_bodies=64, grid_dim=16, cell_size=2.0)
    jcfg, tcfg = JPhysicsConfig(**kw), PhysicsConfig(**kw)
    ws = []
    for mod in (jw, tw):
        w = mod.PhysicsWorld(jcfg if mod is jw else tcfg)
        w.add_body(w.shapes.sphere(0.5), position=(0, 10, 0))
        ws.append(w)
    types = ws[0].shapes.present_types()
    jsim = jax.jit(lambda s, dt: jw.simulate(s, jcfg, dt, present_types=types))
    js, ts = ws[0].device_state(), ws[1].device_state("cpu")
    h = 1 / 60
    ys = []
    for dt in (1 / 120, 1 / 120, 1 / 120, 0.2, 0.9, 1 / 60):
        js = jsim(js, jnp.float32(dt))
        ts = tw.simulate(ts, tcfg, torch.tensor(dt, dtype=torch.float32),
                         present_types=types)
        for k in ("pos", "linvel"):
            np.testing.assert_allclose(np.asarray(js["bodies"][k]), ts["bodies"][k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
        for k in ("accum", "lag_time", "prev_pos", "time"):
            np.testing.assert_allclose(np.asarray(js[k]), ts[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
        jp, jq = jw.interpolated_pose(js, jcfg)
        tp, tq = tw.interpolated_pose(ts, tcfg)
        np.testing.assert_allclose(np.asarray(jp), tp.numpy(), atol=1e-6)
        np.testing.assert_allclose(np.asarray(jq), tq.numpy(), atol=1e-6)
        ys.append((float(ts["bodies"]["pos"][0, 1]), float(tp[0, 1])))
    # half a step: nothing integrates; the second half: exactly one step
    assert ys[0][0] == 10.0
    np.testing.assert_allclose(ys[1][0], 10.0 - 9.81 * h * h, rtol=1e-5)
    # interpolation halfway between the pre-step pose (10.0) and the current
    np.testing.assert_allclose(ys[2][1], 0.5 * (10.0 + ys[2][0]), rtol=1e-6)


def test_bench_style_world_matches():
    """bench.py's world at 64 bodies (`bench.build_world(64)` against the
    port's `scenes.bench_world`: three lattice columns, half spheres): 20
    steps against JAX, the bottom layers landing on the plane and on each
    other (positions within 1e-4, warm-start impulses within 1e-3 of up to
    ~1e3)."""
    import bench
    jwld, jcfg, _ = bench.build_world(64)
    ts, tcfg, types = scenes.bench_world("cpu", 64)
    assert types == jwld.shapes.present_types() == frozenset((tsh.SPHERE, tsh.BOX,
                                                               tsh.PLANE))
    jstep = jax.jit(lambda s: jw.step(s, jcfg, 1.0 / 60.0, types))
    js = jwld.device_state()
    for _ in range(20):
        js, ts = jstep(js), tw.step(ts, tcfg, 1.0 / 60.0, types)
    for k, atol in (("pos", 1e-4), ("quat", 1e-4), ("linvel", 1e-3), ("angvel", 1e-3)):
        np.testing.assert_allclose(np.asarray(js["bodies"][k]), ts["bodies"][k].numpy(),
                                   rtol=0, atol=atol, err_msg=k)
    np.testing.assert_allclose(np.asarray(js["warm"]["n"]), ts["warm"]["n"].numpy(),
                               rtol=0, atol=1e-3)
    assert int(np.asarray(js["touching"] >= 0).sum()) > 16


def _query_world(mod, cfg):
    """Every shape type but compounds, for the queries."""
    w = mod.PhysicsWorld(cfg)
    sh = w.shapes
    w.add_body(sh.plane((0.0, 1.0, 0.0), 1.0), motion=mod.STATIC)       # y = -1
    hts = np.random.default_rng(3).uniform(-0.2, 0.2, (8, 8)).astype(np.float32)
    w.add_body(sh.heightfield(hts, 0.5), position=(-4.0, 0.0, 0.0), motion=mod.STATIC)
    g = np.linspace(-1.5, 1.5, 4)
    v = np.array([[x, 0.2 * x, z] for z in g for x in g], np.float32)
    f = [[i * 4 + j, i * 4 + j + 4, i * 4 + j + 1] for i in range(3) for j in range(3)]
    f += [[i * 4 + j + 1, i * 4 + j + 4, i * 4 + j + 5] for i in range(3) for j in range(3)]
    w.add_body(sh.mesh(v, np.array(f, np.int32)), position=(4.0, 0.0, 0.0), motion=mod.STATIC)
    cube = np.array([[x, y, z] for x in (-.4, .4) for y in (-.3, .3) for z in (-.4, .4)],
                    np.float32)
    w.add_body(sh.sphere(0.5), position=(0.0, 1.0, 0.0))
    w.add_body(sh.box((0.4, 0.3, 0.5)), position=(1.5, 1.0, 0.2),
               rotation=(0.0, 0.2, 0.0, 0.98))
    w.add_body(sh.capsule(0.3, 0.4), position=(-1.5, 1.0, -0.3),
               rotation=(0.3, 0.0, 0.0, 0.954))
    w.add_body(sh.hull(cube), position=(0.0, 1.2, 2.0))
    return w


def test_ray_primitives_match():
    """The queries' per-shape ray tests (the marches at 6 steps; cast_ray
    runs them at 32) against JAX's on every body of a world with every
    shape class but compounds, each ray from above: distances within 1e-4."""
    from garden_tpu.physics import queries as jq
    from garden_tpu_torch.physics import queries as tq
    jstate = _query_world(jw, JPhysicsConfig(max_bodies=16, grid_dim=16)).device_state()
    jst = jax.device_get(jstate)
    tstate = from_jax(jst, "cpu")
    rng = np.random.default_rng(9)
    n = jst["bodies"]["pos"].shape[0]
    o = (jst["bodies"]["pos"] + np.array([0.0, 4.0, 0.0], np.float32)
         + rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32))
    d = np.tile(np.array([0.02, -1.0, 0.01], np.float32), (n, 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def prims(mod, st, o, d, xp):
        b = st["bodies"]
        prm = st["shapes"]["params"][b["shape"]]
        rot = (mod.m3.quat_to_mat3(b["quat"]))
        axis = mod.m3.quat_rotate(b["quat"], xp([[0.0, 1.0, 0.0]] * n))
        return [mod._ray_sphere(o, d, b["pos"], prm[..., 0]),
                mod._ray_box(o, d, b["pos"], rot, prm[..., :3]),
                mod._ray_capsule(o, d, b["pos"] - axis * prm[..., 1:2],
                                 b["pos"] + axis * prm[..., 1:2], prm[..., 0]),
                mod._ray_hull(o, d, b["pos"], b["quat"], prm, st["shapes"]),
                mod._ray_heightfield(o, d, b["pos"], b["quat"], prm, st["shapes"], steps=6),
                mod._ray_mesh(o, d, b["pos"], b["quat"], prm, st["shapes"], steps=6),
                mod._ray_mesh(o, d, b["pos"], b["quat"], prm, st["shapes"], steps=6,
                              inflate=0.2)]
    jt = jax.jit(lambda st, o, d: prims(jq, st, o, d, jnp.asarray))(jstate, o, d)
    tt = prims(tq, tstate, torch.as_tensor(o), torch.as_tensor(d),
               lambda v: torch.tensor(v, dtype=torch.float32))
    for i, (a, b) in enumerate(zip(jt, tt)):
        a = np.asarray(a)
        np.testing.assert_array_equal(a < 1e29, b.numpy() < 1e29, err_msg=str(i))
        np.testing.assert_allclose(np.where(a < 1e29, a, 0), np.where(a < 1e29, b.numpy(), 0),
                                   atol=1e-4, err_msg=str(i))
        assert (a < 1e29).any(), i


def test_casts_hit_the_right_bodies():
    """cast_ray, cast_sphere and cast_shape on the port, from above each
    body class: the nearest body, at the analytic distance where there is
    one (sphere top, box top, the plane), normals up, nothing read back."""
    from garden_tpu_torch.physics import queries as tq
    state = _query_world(tw, PhysicsConfig(max_bodies=16, grid_dim=16)).device_state("cpu")
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    down = t((0.0, -1.0, 0.0))
    hit = tq.cast_ray(state, t((0.0, 5.0, 0.0)), down)
    assert int(hit.body) == 3 and abs(float(hit.distance) - 3.5) < 1e-5
    np.testing.assert_allclose(hit.normal.numpy(), (0.0, 1.0, 0.0), atol=1e-5)
    hit = tq.cast_sphere(state, t((0.0, 5.0, 0.0)), down, 0.25)
    assert int(hit.body) == 3 and abs(float(hit.distance) - 3.25) < 1e-5
    hit = tq.cast_ray(state, t((7.0, 5.0, 9.0)), down)
    assert int(hit.body) == 0 and abs(float(hit.distance) - 6.0) < 1e-4
    for body, x in ((1, -4.0), (2, 4.0), (6, 0.0)):
        o = t((x, 5.0, 0.1 if body != 6 else 2.0))
        for h in (tq.cast_ray(state, o, down), tq.cast_sphere(state, o, down, 0.2)):
            assert bool(h.hit) and int(h.body) == body, (body, h)
            # a mesh hit takes the reference's default normal, from the
            # body's origin to the hit point
            assert body == 2 or float(h.normal[1]) > 0.8, (body, h.normal)
    miss = tq.cast_ray(state, t((0.0, 5.0, 0.0)), t((0.0, 1.0, 0.0)))
    assert not bool(miss.hit) and int(miss.body) == -1


QUERY_TYPES = frozenset((tsh.SPHERE, tsh.BOX, tsh.PLANE))


def test_cast_shape_matches():
    """cast_shape (conservative advancement over the narrowphase, 12 fixed
    iterations) against JAX's on the sphere, box and plane pairs: the same
    body, distance, point and normal within 1e-4."""
    from garden_tpu.physics import queries as jq
    from garden_tpu_torch.physics import queries as tq
    jstate = _query_world(jw, JPhysicsConfig(max_bodies=16, grid_dim=16)).device_state()
    tstate = from_jax(jax.device_get(jstate), "cpu")
    jshape = jax.jit(jq.cast_shape, static_argnames=("shape_index", "present_types",
                                                     "max_distance"))
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    rot = (0.0, 0.2, 0.0, 0.98)
    for o in ((0.1, 5.0, 0.0), (1.5, 5.0, 0.3), (7.0, 3.0, 9.0)):
        jh = jshape(jstate, 4, jnp.asarray(o), jnp.asarray(rot), jnp.asarray((0.0, -1.0, 0.0)),
                    max_distance=20.0, present_types=QUERY_TYPES)
        th = tq.cast_shape(tstate, 4, t(o), t(rot), t((0.0, -1.0, 0.0)), max_distance=20.0,
                           present_types=QUERY_TYPES)
        assert bool(jh.hit) and bool(th.hit) and int(jh.body) == int(th.body), o
        for k in ("distance", "point", "normal"):
            np.testing.assert_allclose(np.asarray(getattr(jh, k)), getattr(th, k).numpy(),
                                       atol=1e-4, err_msg=f"{o} {k}")
