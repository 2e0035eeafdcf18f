"""The port's runtime core against the JAX package on the CPU: the config's
JSON in both directions, the copied log, settings and utils, the ECS world (entity ids, stores, the state it
hands out and takes back), the Engine's tick, the transform bake and the
camera.

Both sides build the same world from a numpy seed. Entity ids, stores,
`tick` and `time` must agree in every bit; transforms and body poses
within 1e-5 over 30 ticks of at most 32 bodies. The JAX engine is built and
jitted once for the module (`jax_engine`). Serial time ~15 s with the
persistent compile cache cold, ~11 s warm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import config as jconfig
from garden_tpu.core import ecs as jecs
from garden_tpu.core import log as jlog
from garden_tpu.core import settings as jsettings
from garden_tpu.core import utils as jutils
from garden_tpu.engine import Engine as JEngine
from garden_tpu.systems import camera as jcamera
from garden_tpu.systems import physics as jphysics
from garden_tpu.systems import transform as jtransform
from garden_tpu_torch.core import config as tconfig
from garden_tpu_torch.core import ecs as tecs
from garden_tpu_torch.core import log as tlog
from garden_tpu_torch.core import settings as tsettings
from garden_tpu_torch.core import utils as tutils
from garden_tpu_torch.engine import Engine as TEngine
from garden_tpu_torch.systems import camera as tcamera
from garden_tpu_torch.systems import physics as tphysics
from garden_tpu_torch.systems import transform as ttransform

DT = 1.0 / 60.0
TICKS = 30
TOL_POSE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: the CPU thread pool only adds overhead on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def leaves(tree, path=""):
    """(key path, leaf) in JAX's pytree order, for either package's state."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def assert_same_tree(a, b, exact=(), atol=None):
    la, lb = leaves(a), leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        x, y = host(x), host(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if atol is None or any(e in k for e in exact) or x.dtype.kind != "f":
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=k)


# -- config ---------------------------------------------------------------------


def test_engine_config_json_both_ways():
    def make(cfg):
        return cfg.EngineConfig(
            capacity=123, max_tick_rate=30, world_batch=2,
            physics=cfg.PhysicsConfig(max_bodies=77, gravity=(0.0, -3.0, 0.5),
                                      sleep_enabled=True),
            render=cfg.RenderConfig(width=640, height=360, use_ssr=True,
                                    shadow=cfg.ShadowConfig(cascade_sizes=(1024, 512, 512),
                                                            resolve_step=2)))

    jtext, ttext = jconfig.to_json(make(jconfig)), tconfig.to_json(make(tconfig))
    assert jtext == ttext
    # written by JAX, read by the port, and the reverse
    assert tconfig.to_json(tconfig.from_json(jtext)) == jtext
    assert jconfig.from_json(ttext) == make(jconfig)
    assert tconfig.from_json(jtext) == make(tconfig)
    assert tconfig.from_json(tconfig.to_json(tconfig.EngineConfig())) == tconfig.EngineConfig()
    assert [f.name for f in dataclasses.fields(tconfig.EngineConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.EngineConfig)]


def test_log_settings_utils_copies_match(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    saved = [(log._logger, log._logger.level) for log in (jlog, tlog)]
    try:
        out = _core_copies(tmp_path)
    finally:                          # the loggers' levels are process-wide
        for logger, level in saved:
            logger.setLevel(level)
    assert out["jax"] == out["torch"]
    with pytest.raises(ValueError):
        tsettings.Settings().save()


def _core_copies(tmp_path):
    """What both packages' log, settings and utils return on the same calls."""
    out = {}
    for name, (log, settings, utils) in {"jax": (jlog, jsettings, jutils),
                                         "torch": (tlog, tsettings, tutils)}.items():
        log.set_level("TRACE")
        level = log.get_logger(log._logger.name).level
        log.set_level("WARN")
        path = str(tmp_path / name / "settings.json")
        st = settings.Settings(path)
        st.set("render.vsync", True)
        st.set("csm.size", 2048)
        st.set("ui.color", (0.25, 0.5, 1.0, 1.0))
        st.save()
        again = settings.Settings(path)
        blob = bytes(range(256))
        utils.write_text(str(tmp_path / name / "t" / "a.txt"), "garden é")
        out[name] = (level, log.TRACE, log.FATAL, utils.read_text(path),
                     again.get_bool("render.vsync"), again.get_int("csm.size"),
                     again.get_float("missing", 0.5), again.get_string("csm.size"),
                     again.get_color("ui.color"),
                     utils.base64_encode(blob), utils.base64_encode(blob, url_safe=True),
                     utils.base64_decode(utils.base64_encode(blob, True).rstrip("="), True),
                     utils.utf16_to_utf8(utils.utf8_to_utf16("garden é")),
                     utils.utf8_to_utf32("é"), utils.codepoint_count("gärden"),
                     utils.read_text(str(tmp_path / name / "t" / "a.txt")),
                     utils.app_data_dir("app"), utils.app_cache_dir("app"))
    return out


# -- ecs --------------------------------------------------------------------------

def _tag_def(mod, np_dtypes):
    f32, i32 = (np.float32, np.int32) if np_dtypes else (jnp.float32, jnp.int32)
    return mod.ComponentDef("tag", {"v": mod.Field((3,), f32, (1.0, 2.0, 3.0)),
                                    "n": mod.Field((), i32, 7)})


def _churn(world, seed):
    """A seeded sequence of creates, destroys and component edits; -> the
    ids create_entity returned."""
    rng = np.random.default_rng(seed)
    ids, alive = [], []
    for step in range(60):
        r = rng.uniform()
        if r < 0.55 or not alive:
            e = world.create_entity()
            ids.append(int(e))
            alive.append(e)
            if rng.uniform() < 0.6:
                world.add_component(e, "tag", v=rng.normal(size=3).astype(np.float32))
        elif r < 0.8:
            e = alive.pop(int(rng.integers(len(alive))))
            world.destroy_entity(e)
        elif r < 0.9:
            e = alive[int(rng.integers(len(alive)))]
            world.set_component(e, "tag", n=int(rng.integers(100)))
        else:
            world.remove_component(alive[int(rng.integers(len(alive)))], "tag")
    return ids


def test_entity_ids_and_stores_match():
    jw, tw = jecs.World(capacity=96), tecs.World(capacity=96, device="cpu")
    jw.register_component(_tag_def(jecs, False))
    tw.register_component(_tag_def(tecs, True))
    assert _churn(jw, 3) == _churn(tw, 3)
    assert [int(e) for e in jw._free] == [int(e) for e in tw._free]
    np.testing.assert_array_equal(jw._alive, tw._alive)
    np.testing.assert_array_equal(jw._generation, tw._generation)
    for k in jw._stores["tag"]:
        np.testing.assert_array_equal(jw._stores["tag"][k], tw._stores["tag"][k], err_msg=k)
    js, ts = jw.device_state(), tw.device_state()
    assert_same_tree(js, ts)
    # a stepped state adopted back: the same stores and free list after
    # more creates and destroys
    js = dict(js, entities=dict(js["entities"], alive=js["entities"]["alive"].at[2].set(False)))
    ts["entities"]["alive"] = ts["entities"]["alive"].clone()
    ts["entities"]["alive"][2] = False
    jw.adopt(js)
    tw.adopt(ts)
    assert _churn(jw, 4) == _churn(tw, 4)
    assert_same_tree(jw.device_state(), tw.device_state())
    assert jw.get_component(5, "tag").keys() == tw.get_component(5, "tag").keys()


def test_device_state_and_adopt_do_not_alias():
    w = tecs.World(capacity=8, device="cpu")
    w.register_component(_tag_def(tecs, True))
    e = w.create_entity()
    w.add_component(e, "tag", v=(1.0, 1.0, 1.0))
    state = w.device_state()
    # host edits after device_state() do not reach the state handed out
    w.set_component(e, "tag", v=(5.0, 5.0, 5.0), n=1)
    w.create_entity()
    assert state["components"]["tag"]["v"][e].tolist() == [1.0, 1.0, 1.0]
    assert int(state["components"]["tag"]["n"][e]) == 7
    assert int(state["entities"]["alive"].sum()) == 1
    # and in-place edits of the state do not reach the stores
    state["components"]["tag"]["v"].fill_(9.0)
    assert w._stores["tag"]["v"][e].tolist() == [5.0, 5.0, 5.0]
    # adopt copies: the state and the stores stay apart both ways
    w.adopt(state)
    state["components"]["tag"]["v"].fill_(-1.0)
    state["entities"]["alive"].fill_(True)
    assert w._stores["tag"]["v"][e].tolist() == [9.0, 9.0, 9.0]
    assert int(w._alive.sum()) == 1
    w.set_component(e, "tag", v=(2.0, 2.0, 2.0))
    assert state["components"]["tag"]["v"][e].tolist() == [-1.0, -1.0, -1.0]
    assert w._stores["tag"]["v"].flags.writeable


def test_masked_update_and_events_match():
    rng = np.random.default_rng(0)
    has = rng.uniform(size=10) < 0.5
    new, old = rng.normal(size=(2, 10, 3, 2)).astype(np.float32)
    j = jecs.masked_update(jnp.asarray(has), jnp.asarray(new), jnp.asarray(old))
    t = tecs.masked_update(torch.tensor(has), torch.tensor(new), torch.tensor(old))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    order = {}
    for mod in (jecs, tecs):
        reg, seen = mod.EventRegistry(), []
        for name, prio in (("a", 1.0), ("b", -1.0), ("c", 1.0), ("d", 0.0)):
            reg.subscribe("E", lambda s, c, name=name: s + [name], priority=prio)
        order[mod] = reg.run("E", seen)
    assert order[jecs] == order[tecs] == ["b", "d", "a", "c"]


# -- engine -------------------------------------------------------------------------


def _engine_world(eng, phys, seed):
    """A plane and 24 bodies (spheres and boxes, apart so none stack) from
    a seed, each an entity with a transform; one entity with a camera."""
    rng = np.random.default_rng(seed)
    shapes = phys.physics.shapes
    ground = eng.world.create_entity()
    eng.world.add_component(ground, "transform")
    phys.add_rigidbody(ground, shapes.plane((0, 1, 0), 0.0), motion=0)
    ball, box = shapes.sphere(0.4), shapes.box((0.3, 0.25, 0.35))
    for k in range(24):
        e = eng.world.create_entity()
        pos = (-9.0 + 1.5 * (k % 12) + rng.uniform(-0.2, 0.2), rng.uniform(0.6, 2.5),
               -1.5 + 3.0 * (k // 12) + rng.uniform(-0.2, 0.2))
        eng.world.add_component(e, "transform", position=pos)
        q = rng.normal(size=4)
        phys.add_rigidbody(e, ball if k % 2 else box, rotation=q / np.linalg.norm(q),
                           linvel=rng.uniform(-1.0, 1.0, 3), angvel=rng.uniform(-2, 2, 3))
    cam = eng.world.create_entity()
    eng.world.add_component(cam, "camera", fov_y=1.1)


def _make_engine(pkg, seed=1):
    cfg_mod, eng_cls, tr, cam, ph = pkg
    cfg = cfg_mod.EngineConfig(capacity=32, physics=cfg_mod.PhysicsConfig(
        max_bodies=32, grid_dim=8, cell_size=2.0))
    eng = eng_cls(cfg) if eng_cls is JEngine else eng_cls(cfg, device="cpu")
    eng.create_system(tr.TransformSystem())
    eng.create_system(cam.CameraSystem())
    phys = eng.create_system(ph.PhysicsSystem(cfg.physics))
    eng.initialize()
    _engine_world(eng, phys, seed)
    return eng


JAX_PKG = (jconfig, JEngine, jtransform, jcamera, jphysics)
TORCH_PKG = (tconfig, TEngine, ttransform, tcamera, tphysics)


@pytest.fixture(scope="module")
def jax_engine():
    eng = _make_engine(JAX_PKG)
    eng.build_step(donate=False)
    state0 = eng.device_state()
    return eng, state0, eng.run_ticks(state0, TICKS, DT)


def test_engine_ticks_match_jax(jax_engine):
    jeng, jstate0, jstate = jax_engine
    teng = _make_engine(TORCH_PKG)
    tstate0 = teng.device_state()
    assert_same_tree(jstate0, tstate0)
    tstate = teng.run_ticks(tstate0, TICKS, DT)
    assert int(tstate["tick"]) == TICKS
    np.testing.assert_array_equal(np.asarray(jstate["tick"]), tstate["tick"].numpy())
    np.testing.assert_array_equal(np.asarray(jstate["time"]), tstate["time"].numpy())
    jt, tt = jstate["components"]["transform"], tstate["components"]["transform"]
    for k in ("position", "rotation"):
        np.testing.assert_allclose(np.asarray(jt[k]), tt[k].numpy(), rtol=0, atol=TOL_POSE,
                                   err_msg=k)
    for k in ("pos", "quat"):
        np.testing.assert_allclose(np.asarray(jstate["physics"]["bodies"][k]),
                                   tstate["physics"]["bodies"][k].numpy(), rtol=0,
                                   atol=TOL_POSE, err_msg=k)
    # the static ground's transform is untouched, the stores as built
    assert tt["position"][0].tolist() == [0.0, 0.0, 0.0]
    assert_same_tree(jstate["components"]["camera"], tstate["components"]["camera"])
    assert_same_tree(jstate["entities"], tstate["entities"])


def test_step_is_functional_and_deterministic():
    eng = _make_engine(TORCH_PKG)
    state = eng.run_ticks(eng.device_state(), 3, DT)
    before = {k: v.clone() for k, v in leaves(state)}
    step = eng.build_step()
    a = step(state, DT)
    b = step(state, DT)
    for k, v in leaves(state):            # the input state is never written
        assert torch.equal(v, before[k]), k
    assert_same_tree(a, b)                # one state stepped twice: the same
    assert int(a["tick"]) == 4
    looped = eng.enter_loop(state, max_ticks=2, tick_rate=0)
    assert int(looped["tick"]) == 5


def test_engine_requires_the_card_unless_told_cpu():
    cfg = tconfig.EngineConfig(capacity=4)
    if torch.cuda.is_available():
        assert TEngine(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TEngine(cfg)
    assert TEngine(cfg, device="cpu").device.type == "cpu"


# -- transform and camera -------------------------------------------------------------


def _hierarchy(seed, n=24):
    """A random forest (parents before children, a few rows without the
    component, a dangling parent link) of TRS transforms."""
    rng = np.random.default_rng(seed)
    parent = np.array([-1 if i < 3 or rng.uniform() < 0.2 else int(rng.integers(i))
                       for i in range(n)], np.int32)
    q = rng.normal(size=(n, 4))
    store = {
        "has": rng.uniform(size=n) < 0.9,
        "position": rng.uniform(-3, 3, (n, 3)).astype(np.float32),
        "rotation": (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32),
        "scale": rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32),
        "parent": parent,
        "active": rng.uniform(size=n) < 0.8,
    }
    return store


def test_transform_bake_matches():
    for seed in (0, 1):
        store = _hierarchy(seed)
        jm = jtransform.bake_world_matrices({k: jnp.asarray(v) for k, v in store.items()})
        tm = ttransform.bake_world_matrices({k: torch.tensor(v) for k, v in store.items()})
        np.testing.assert_allclose(np.asarray(jm), tm.numpy(), rtol=0, atol=TOL_POSE)
        ja = jtransform.bake_world_active({k: jnp.asarray(v) for k, v in store.items()})
        ta = ttransform.bake_world_active({k: torch.tensor(v) for k, v in store.items()})
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(
            np.asarray(jtransform.world_positions(jm)),
            ttransform.world_positions(torch.tensor(np.asarray(jm))).numpy())
    w = tecs.World(capacity=4, device="cpu")
    ts = w.create_system(ttransform.TransformSystem())
    a, b = w.create_entity(), w.create_entity()
    w.add_component(a, "transform")
    w.add_component(b, "transform")
    ts.set_parent(b, a)
    assert int(w._stores["transform"]["parent"][b]) == a


def test_camera_matches():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.uniform(-10, 10, (5, 3)).astype(np.float32)
    jv = jcamera.view_matrix(jnp.asarray(p), jnp.asarray(q))
    tv = tcamera.view_matrix(torch.tensor(p), torch.tensor(q))
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=0, atol=1e-5)
    jstore, tstore = jcamera.CAMERA.create_store(3), tcamera.CAMERA.create_store(3)
    for k in jstore:
        np.testing.assert_array_equal(jstore[k], tstore[k], err_msg=k)
    assert (tcamera.PROJ_PERSPECTIVE, tcamera.PROJ_ORTHOGRAPHIC) == \
        (jcamera.PROJ_PERSPECTIVE, jcamera.PROJ_ORTHOGRAPHIC)
