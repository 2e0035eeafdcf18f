"""The port's gameplay systems against the JAX package on the CPU: physics
(the transform sync), characters (velocity control, walk-stairs and
stick-to-floor through the batched sphere casts), animation (tracks,
looping, property curves of every interpolation mode and cast), the
spawner, links, input, the controllers, contact events and the small
systems.

Both packages build one world from a numpy seed: a plane, a step and a
ledge, 20 falling bodies, two characters (one walking into the step, one
walking off the ledge), four animated entities and a spawner, and tick it
20 times. The JAX engine is built once for the module (`worlds`). Its
reference step runs the JAX engine's own Update subscribers in their
order: physics and animation jitted, the character system eagerly over a
jitted `queries.cast_sphere` (the JAX character system traces three
sphere casts, whose compile alone takes ~70 s on the CPU when the whole
update is jitted). Transforms and body poses agree within 1e-5, character
velocities within 1e-5; grounded flags, entity ids, stores, animation
times, `tick` and `time` in every bit. Serial time ~36 s with the
persistent compile cache cold, ~24 s warm.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import config as jconfig
from garden_tpu.core import ecs as jecs
from garden_tpu.engine import Engine as JEngine
from garden_tpu.physics import queries as jqueries
from garden_tpu.systems import animation as janimation
from garden_tpu.systems import character as jcharacter
from garden_tpu.systems import controller as jcontroller
from garden_tpu.systems import events as jevents
from garden_tpu.systems import input as jinput
from garden_tpu.systems import link as jlink
from garden_tpu.systems import misc as jmisc
from garden_tpu.systems import physics as jphysics
from garden_tpu.systems import spawner as jspawner
from garden_tpu.systems import transform as jtransform
from garden_tpu_torch.core import config as tconfig
from garden_tpu_torch.core import ecs as tecs
from garden_tpu_torch.engine import Engine as TEngine
from garden_tpu_torch.physics import queries as tqueries
from garden_tpu_torch.physics import scenes as tscenes
from garden_tpu_torch.physics import world as tworld
from garden_tpu_torch.systems import animation as tanimation
from garden_tpu_torch.systems import character as tcharacter
from garden_tpu_torch.systems import controller as tcontroller
from garden_tpu_torch.systems import events as tevents
from garden_tpu_torch.systems import input as tinput
from garden_tpu_torch.systems import link as tlink
from garden_tpu_torch.systems import misc as tmisc
from garden_tpu_torch.systems import physics as tphysics
from garden_tpu_torch.systems import spawner as tspawner
from garden_tpu_torch.systems import transform as ttransform

DT = 1.0 / 60.0
TICKS = 20
TOL_POSE, TOL_VEL = 1e-5, 1e-5

JAX = dict(ecs=jecs, config=jconfig, transform=jtransform, animation=janimation,
           spawner=jspawner, physics=jphysics, character=jcharacter)
TORCH = dict(ecs=tecs, config=tconfig, transform=ttransform, animation=tanimation,
             spawner=tspawner, physics=tphysics, character=tcharacter)


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lamp(pkg):
    """A custom component whose fields the property curves animate."""
    f32 = np.float32 if pkg is TORCH else jnp.float32
    i32 = np.int32 if pkg is TORCH else jnp.int32
    b = np.bool_ if pkg is TORCH else jnp.bool_
    F = pkg["ecs"].Field
    return pkg["ecs"].ComponentDef("lamp", {
        "intensity": F((), f32, 1.0), "color": F((3,), f32, (1.0, 1.0, 1.0)),
        "mode": F((), i32, 0), "on": F((), b, False),
        "orient": F((4,), f32, (0.0, 0.0, 0.0, 1.0))})


def build(pkg, seed=0):
    """The test world in one package -> (engine, spawned ids)."""
    cfg = pkg["config"].EngineConfig(capacity=48, physics=pkg["config"].PhysicsConfig(
        max_bodies=32, grid_dim=8))
    eng = JEngine(cfg) if pkg is JAX else TEngine(cfg, device="cpu")
    w = eng.world
    eng.create_system(pkg["transform"].TransformSystem())
    anim = eng.create_system(pkg["animation"].AnimationSystem(max_tracks=8, max_keyframes=8))
    spawner = eng.create_system(pkg["spawner"].SpawnerSystem())
    phys = eng.create_system(pkg["physics"].PhysicsSystem(cfg.physics))
    char = eng.create_system(pkg["character"].CharacterSystem())
    eng.register_state("animation_tracks", anim.device_state)
    eng.initialize()
    w.register_component(_lamp(pkg))
    rng = np.random.default_rng(seed)
    shapes = phys.physics.shapes

    def static(shape, pos):
        e = w.create_entity()
        w.add_component(e, "transform", position=pos)
        phys.add_rigidbody(e, shape, motion=0)

    static(shapes.plane((0, 1, 0), 0.0), (0.0, 0.0, 0.0))
    static(shapes.box((1.0, 0.15, 2.0)), (2.0, 0.15, 0.0))       # a 0.3 m step
    static(shapes.box((1.0, 0.15, 1.0)), (-5.0, 0.15, 0.0))      # a ledge
    for k in range(20):
        e = w.create_entity()
        w.add_component(e, "transform", position=(
            rng.uniform(-8, 8), rng.uniform(0.6, 3.0), 4.0 + 1.2 * (k % 5)))
        phys.add_rigidbody(e, shapes.sphere(0.3) if k % 2 else shapes.box((0.3, 0.2, 0.25)),
                           linvel=rng.uniform(-1, 1, 3))
    walker, leaper = w.create_entity(), w.create_entity()
    w.add_component(walker, "transform", position=(0.45, 0.905, 0.0))
    char.add_character(walker, step_height=0.45)
    w.add_component(leaper, "transform", position=(-5.3, 1.205, 0.0))
    char.add_character(leaper)
    w.set_component(walker, "character", desired_vel=(2.0, 0.0, 0.0))
    w.set_component(leaper, "character", desired_vel=(-2.0, 0.0, 0.0), grounded=True)

    for a in range(4):
        e = w.create_entity()
        w.add_component(e, "transform")
        w.add_component(e, "lamp")
        keys = []
        for k in range(3 + a):
            q = rng.normal(size=4)
            keys.append({"time": 0.11 * k * (a + 1), "position": rng.uniform(-2, 2, 3).tolist(),
                         "rotation": (q / np.linalg.norm(q)).tolist(),
                         **({"scale": rng.uniform(0.5, 2, 3).tolist()} if a % 2 else {})})
        track = anim.add_track(keys, name=f"track{a}")
        if a < 3:
            anim.add_property_keyframes(track, "lamp", "intensity", [
                {"time": 0.0, "value": 0.0}, {"time": 0.37, "value": 8.0}])
            anim.add_property_keyframes(track, "lamp", "mode", [
                {"time": 0.0, "value": 0}, {"time": 0.2, "value": 3}, {"time": 0.3, "value": 5}],
                mode="step")
            anim.add_property_keyframes(track, "lamp", "on", [
                {"time": 0.0, "value": 0.0}, {"time": 0.4, "value": 1.0}])
            q0, q1 = rng.normal(size=(2, 4))
            anim.add_property_keyframes(track, "lamp", "orient", [
                {"time": 0.0, "value": (q0 / np.linalg.norm(q0)).tolist()},
                {"time": 0.45, "value": (q1 / np.linalg.norm(q1)).tolist()}], mode="slerp")
        w.add_component(e, "animation", track=track, looped=a != 1, speed=0.75 + 0.25 * a,
                        playing=a != 3)

    def prefab(world, owner):
        child = world.create_entity()
        world.add_component(child, "transform",
                            position=world._stores["transform"]["position"][owner])
        return child

    spawner.register_prefab("crate", prefab)
    s = w.create_entity()
    w.add_component(s, "transform", position=(0.0, 3.0, 0.0))
    spawner.add_spawner(s, "crate", mode=pkg["spawner"].MODE_ONE_SHOT, delay=0.25,
                        max_count=2)
    spawned = [spawner.process(0.1), spawner.process(0.16), spawner.process(0.1),
               spawner.process(0.1)]
    return eng, spawned


def jax_reference_step(eng):
    """The JAX engine's tick with its Update subscribers in their own order:
    animation and physics jitted, the character system eager (its casts
    run through the jitted cast_sphere the module fixture installs)."""
    w = eng.world
    anim, char, phys = (w.systems[n] for n in ("AnimationSystem", "CharacterSystem",
                                               "PhysicsSystem"))
    assert w.events.subscribers("Update") == [anim.update, char.update, phys.update]
    assert not w.events.has_event("Input") and not w.events.has_event("Output")
    janim, jphys = jax.jit(anim.update), jax.jit(phys.update)

    def step(state):
        ctx = {"delta_time": jnp.asarray(DT, jnp.float32), "time": state["time"],
               "tick": state["tick"]}
        state = jphys(char.update(janim(state, ctx), ctx), ctx)
        return dict(state, tick=state["tick"] + 1, time=state["time"] + ctx["delta_time"])

    return step


@pytest.fixture(scope="module")
def worlds():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqueries, "cast_sphere", jax.jit(jqueries.cast_sphere))
        jeng, jspawned = build(JAX)
        teng, tspawned = build(TORCH)
        step = jax_reference_step(jeng)
        js = jeng.device_state()
        ts0 = teng.device_state()
        ts = teng.run_ticks(ts0, TICKS, DT)
        jstates = [js]
        for _ in range(TICKS):
            jstates.append(step(jstates[-1]))
        jax.block_until_ready(jstates[-1])
    yield dict(jeng=jeng, teng=teng, jspawned=jspawned, tspawned=tspawned,
               js0=js, ts0=ts0, js=jstates[-1], ts=ts, jstates=jstates)
    torch.set_num_threads(torch_threads)


def test_spawner_and_stores_match(worlds):
    assert worlds["jspawned"] == worlds["tspawned"] == [[], [30], [31], []]
    jw, tw = worlds["jeng"].world, worlds["teng"].world
    for name in jw._stores:
        for k in jw._stores[name]:
            np.testing.assert_array_equal(jw._stores[name][k], tw._stores[name][k],
                                          err_msg=f"{name}.{k}")
    np.testing.assert_array_equal(jw._alive, tw._alive)
    assert tw._stores["spawner"]["elapsed"].dtype == np.float32
    assert worlds["jeng"].world.systems["SpawnerSystem"].spawned_of(29) == \
        worlds["teng"].world.systems["SpawnerSystem"].spawned_of(29)


def test_initial_states_match(worlds):
    js, ts = worlds["js0"], worlds["ts0"]
    jl = jax.tree_util.tree_flatten_with_path(js)[0]
    tl = {jax.tree_util.keystr(k): v for k, v in
          jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(host, ts))[0]}
    assert len(jl) == len(tl)
    for k, v in jl:
        np.testing.assert_array_equal(np.asarray(v), tl[jax.tree_util.keystr(k)],
                                      err_msg=jax.tree_util.keystr(k))


def test_physics_sync_and_characters_match(worlds):
    js, ts = worlds["js"], worlds["ts"]
    np.testing.assert_array_equal(np.asarray(js["tick"]), ts["tick"].numpy())
    np.testing.assert_array_equal(np.asarray(js["time"]), ts["time"].numpy())
    jb, tb = js["physics"]["bodies"], ts["physics"]["bodies"]
    for k in ("pos", "quat"):
        np.testing.assert_allclose(np.asarray(jb[k]), tb[k].numpy(), rtol=0, atol=TOL_POSE,
                                   err_msg=k)
    jt, tt = js["components"]["transform"], ts["components"]["transform"]
    for k in ("position", "rotation", "scale"):
        np.testing.assert_allclose(np.asarray(jt[k]), tt[k].numpy(), rtol=0, atol=TOL_POSE,
                                   err_msg=k)
    jc, tc = js["components"]["character"], ts["components"]["character"]
    np.testing.assert_array_equal(np.asarray(jc["grounded"]), tc["grounded"].numpy())
    np.testing.assert_array_equal(np.asarray(jc["jump_impulse"]), tc["jump_impulse"].numpy())
    bodies = tc["body"].numpy()[tc["has"].numpy()]
    np.testing.assert_allclose(np.asarray(jb["linvel"])[bodies], tb["linvel"].numpy()[bodies],
                               rtol=0, atol=TOL_VEL)
    np.testing.assert_array_equal(np.asarray(jb["ground_cos"]), tb["ground_cos"].numpy())
    # the scenario did what it is for: the walker reached the step's edge
    # (at x = 1 - its radius) and walk-stairs lifted it (it rests at 0.9 on
    # the plane, 1.2 on the step), both ended grounded, and each movable
    # transform row is its body's interpolated pose (the static rows
    # untouched)
    walker = tb["pos"].numpy()[bodies[0]]
    assert walker[0] > 0.7 and walker[1] > 0.3 + 0.85, walker
    assert tc["grounded"].numpy()[tc["has"].numpy()].all()
    cfg = worlds["teng"].world.systems["PhysicsSystem"].config
    pos, quat = tworld.interpolated_pose(ts["physics"], cfg)
    ent = tb["entity"].numpy()
    movable = tb["has"].numpy() & (ent >= 0) & (tb["motion"].numpy() != tworld.STATIC)
    assert torch.equal(tt["position"][ent[movable]], pos[movable])
    assert torch.equal(tt["rotation"][ent[movable]], quat[movable])
    np.testing.assert_array_equal(tt["position"][1].numpy(), np.float32([2.0, 0.15, 0.0]))


def test_animation_matches(worlds):
    js, ts = worlds["js"], worlds["ts"]
    ja, ta = js["components"]["animation"], ts["components"]["animation"]
    np.testing.assert_array_equal(np.asarray(ja["time"]), ta["time"].numpy())
    jl, tl = js["components"]["lamp"], ts["components"]["lamp"]
    for k in ("mode", "on"):
        np.testing.assert_array_equal(np.asarray(jl[k]), tl[k].numpy(), err_msg=k)
    for k in ("intensity", "color", "orient"):
        np.testing.assert_allclose(np.asarray(jl[k]), tl[k].numpy(), rtol=0, atol=TOL_POSE,
                                   err_msg=k)
    # every mode and cast took effect somewhere, the looped tracks wrapped
    has = tl["mode"].numpy()[tl["has"].numpy()]
    assert set(has.tolist()) >= {3, 5} or set(has.tolist()) >= {0, 5}
    assert ta["time"].numpy()[ta["has"].numpy()].min() < TICKS * DT * 0.75
    anim = worlds["teng"].world.systems["AnimationSystem"]
    janim = worlds["jeng"].world.systems["AnimationSystem"]
    assert anim.find_track("track2") == janim.find_track("track2") == 2
    assert anim.track_name(1) == "track1"
    jt, tt = janim.device_state(), anim.device_state()
    for k in ("times", "pos", "rot", "scale", "kf_count", "animate_mask"):
        np.testing.assert_array_equal(np.asarray(jt[k]), tt[k].numpy(), err_msg=k)
    for g in jt["props"]:
        for k in jt["props"][g]:
            np.testing.assert_array_equal(np.asarray(jt["props"][g][k]),
                                          tt["props"][g][k].numpy(), err_msg=f"{g}.{k}")


def test_animation_checks_shapes_and_loads_files(tmp_path):
    path = str(tmp_path / "walk.anim")
    with open(path, "w", encoding="utf-8") as f:
        f.write('{"keyframes": [{"time": 0.0, "position": [0, 0, 0]},'
                ' {"time": 1.0, "position": [1, 2, 3]}]}')
    for mod in (janimation, tanimation):
        a = mod.AnimationSystem(max_tracks=2, max_keyframes=4)
        assert a.load_animation(path) == 0 and a.load_animation(path) == 0
        with pytest.raises(ValueError):
            a.add_property_keyframes(0, "lamp", "x", [{"time": 0.0, "value": 1.0}],
                                     mode="cubic")
        with pytest.raises(ValueError):
            a.add_property_keyframes(0, "lamp", "q", [{"time": 0.0, "value": 1.0}],
                                     mode="slerp")
    eng = TEngine(tconfig.EngineConfig(capacity=4), device="cpu")
    anim = eng.create_system(tanimation.AnimationSystem(max_tracks=2, max_keyframes=4))
    eng.create_system(ttransform.TransformSystem())
    eng.register_state("animation_tracks", anim.device_state)
    eng.initialize()
    e = eng.world.create_entity()
    eng.world.add_component(e, "transform")
    eng.world.add_component(e, "animation", track=anim.load_animation(path))
    state = eng.device_state()
    bad = dict(state["animation_tracks"], pos=state["animation_tracks"]["pos"][..., :2])
    with pytest.raises(ValueError, match="position"):
        anim.update(dict(state, animation_tracks=bad), {"delta_time": DT})


def test_cast_sphere_batched_equals_single_calls():
    state, _, _ = tscenes.mixed_world("cpu")
    rng = np.random.default_rng(5)
    e = 12
    org = torch.tensor(np.c_[rng.uniform(-5, 5, e), rng.uniform(0.3, 4, e),
                             rng.uniform(-3, 3, e)], dtype=torch.float32)
    dirs = torch.tensor(rng.normal(size=(e, 3)), dtype=torch.float32)
    dirs[:6] = torch.tensor([0.0, -1.0, 0.0])
    rad = torch.tensor(rng.uniform(0.1, 0.5, e), dtype=torch.float32)
    dist = torch.tensor(rng.uniform(1, 10, e), dtype=torch.float32)
    excl = torch.tensor(rng.integers(-1, 8, e), dtype=torch.int32)
    batched = tqueries.cast_sphere(state, org, dirs, rad, dist, excl)
    hits = 0
    for i in range(e):
        one = tqueries.cast_sphere(state, org[i], dirs[i], float(rad[i]), float(dist[i]),
                                   int(excl[i]))
        hits += bool(one.hit)
        for f in one._fields:
            assert torch.equal(getattr(batched, f)[i], getattr(one, f)), (i, f)
    assert 0 < hits < e


def test_link_input_controller_events_misc_match(tmp_path):
    out = {}
    for name, (link, inp, ctl, ev, misc) in {
            "jax": (jlink, jinput, jcontroller, jevents, jmisc),
            "torch": (tlink, tinput, tcontroller, tevents, tmisc)}.items():
        rec = []
        reg = link.LinkSystem()
        reg.add_link(3, uuid="a" * 32, tag="enemy")
        reg.add_link(4, uuid="b" * 32, tag="enemy")
        reg.set_tag(3, "boss")
        with pytest.raises(ValueError):
            reg.add_link(5, uuid="a" * 32)
        reg.remove(4)
        rec.append((reg.find_by_uuid("a" * 32), reg.find_by_tag("enemy"),
                    reg.find_by_tag("boss"), reg.uuid_of(4), len(reg.add_link(9))))
        i = inp.InputSystem()
        fpv = ctl.FpvController(sensitivity=0.01)
        c2d = ctl.Controller2D(entity=1)
        for frame in range(4):
            if frame == 0:
                i.push_key_down("w")
                i.push_key_down("space")
                i.push_cursor(10.0, 5.0)
                i.push_text("hi")
            if frame == 2:
                i.push_key_up("w")
                i.push_key_down("d")
                i.push_scroll(0.0, 1.5)
                i.push_file_drop("a.gltf")
            i.swap()
            fpv.process(i, DT)
            rec.append((sorted(i.down), sorted(i.pressed), sorted(i.released), i.cursor,
                        i.cursor_delta, i.scroll, i.text, i.dropped_files,
                        fpv.position.tolist(), fpv.yaw, fpv.pitch, c2d.process(i),
                        [v.tolist() for v in fpv.view_target()]))
        events = ev.ContactEvents()
        seen = []
        events.on_entered.append(lambda a, b: seen.append(("in", a, b)))
        events.on_exited.append(lambda a, b: seen.append(("out", a, b)))
        t0 = np.array([[1, -1], [0, 2], [1, -1]])
        t1 = np.array([[-1, -1], [2, -1], [1, -1]])
        rec.append((events.process(t0), events.process(t1), seen,
                    sorted(ev.touching_pairs(t1))))
        loc = misc.LocaleSystem()
        loc.load_locale("de", {"hello": "hallo"})
        loc.set_locale("de")
        app = misc.AppInfoSystem(misc.AppInfo(cache_path=str(tmp_path / name)))
        watcher = misc.FileWatcherSystem()
        (tmp_path / name).mkdir(exist_ok=True)
        f = tmp_path / name / "watched.txt"
        f.write_text("a")
        watcher.watch(str(f))
        os.utime(f, (1, 1))
        rec.append((loc.get("hello"), loc.get("bye", "tschuss"), loc.get("x"),
                    os.path.basename(app.cache_path("c.bin")), app.resource_path("r"),
                    [os.path.basename(p) for p in watcher.poll()], watcher.poll()))
        out[name] = rec
    assert out["jax"] == out["torch"]
    # the port's events also take the step's (device) touching tensor
    assert tevents.touching_pairs(torch.tensor([[1, -1], [0, 2], [1, -1]])) == \
        jevents.touching_pairs(np.array([[1, -1], [0, 2], [1, -1]]))



def test_characters_step_from_the_state_not_the_host_world(worlds):
    """A character destroyed on the host after device_state() is still a
    character of the state taken before: stepping that state gives the JAX
    result, the walker's walk-stairs lift (tick 2) included, as the casts
    take their rows from the state."""
    jw, tw = worlds["jeng"].world, worlds["teng"].world
    walker = int(np.nonzero(tw._stores["character"]["has"])[0][0])
    for w in (jw, tw):
        w.destroy_entity(walker)
    assert not tw.has_component(walker, "character")
    ticks = 3
    ts = worlds["teng"].run_ticks(worlds["ts0"], ticks, DT)
    js = worlds["jstates"][ticks]
    jb, tb = js["physics"]["bodies"], ts["physics"]["bodies"]
    for k in ("pos", "quat", "linvel"):
        np.testing.assert_allclose(np.asarray(jb[k]), tb[k].numpy(), rtol=0, atol=TOL_POSE,
                                   err_msg=k)
    jc, tc = js["components"]["character"], ts["components"]["character"]
    np.testing.assert_array_equal(np.asarray(jc["grounded"]), tc["grounded"].numpy())
    assert tb["pos"][int(tc["body"][walker]), 1] > 0.3 + 0.85
