"""The port's checkpoints, debug guards, profiler, protocol and replication
on the CPU, against the JAX package where it has a counterpart.

A checkpoint written by either package loads in the other (the same `.npz`
leaves in JAX's pytree order and the same `.npz.tree` key paths); one
written by the JAX engine after 5 ticks loads through the port and steps
to the JAX engine's result (body poses and transforms within 1e-5, `tick`
and `time` in every bit). Snapshot and character payloads are byte for
byte those of the JAX package, and applying them gives the same poses in
every bit. The JAX engine (transform and physics, 16 bodies) is jitted
once for the module. Serial time ~13 s with the persistent compile cache
cold, ~10 s warm.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import json
import os

import jax
import numpy as np
import pytest
import torch

from garden_tpu.core import config as jconfig
from garden_tpu.engine import Engine as JEngine
from garden_tpu.net import protocol as jprotocol
from garden_tpu.net import replication as jreplication
from garden_tpu.physics import world as jworld
from garden_tpu.systems import physics as jphysics
from garden_tpu.systems import transform as jtransform
from garden_tpu.utils import checkpoint as jcheckpoint
from garden_tpu_torch import cuda_build
from garden_tpu_torch.core import config as tconfig
from garden_tpu_torch.core.ecs import System, World
from garden_tpu_torch.engine import Engine as TEngine
from garden_tpu_torch.net import protocol as tprotocol
from garden_tpu_torch.net import replication as treplication
from garden_tpu_torch.physics import world as tworld
from garden_tpu_torch.systems import physics as tphysics
from garden_tpu_torch.systems import transform as ttransform
from garden_tpu_torch.utils import checkpoint as tcheckpoint
from garden_tpu_torch.utils import profiler

DT = 1.0 / 60.0
TOL_POSE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(cfg_mod, eng_cls, tr, ph):
    """Transform + physics: a plane and 15 spheres and boxes from a seed."""
    cfg = cfg_mod.EngineConfig(capacity=20, physics=cfg_mod.PhysicsConfig(
        max_bodies=16, grid_dim=8))
    eng = eng_cls(cfg) if eng_cls is JEngine else eng_cls(cfg, device="cpu")
    eng.create_system(tr.TransformSystem())
    phys = eng.create_system(ph.PhysicsSystem(cfg.physics))
    eng.initialize()
    rng = np.random.default_rng(7)
    g = eng.world.create_entity()
    eng.world.add_component(g, "transform")
    phys.add_rigidbody(g, phys.physics.shapes.plane((0, 1, 0), 0.0), motion=0)
    for k in range(15):
        e = eng.world.create_entity()
        eng.world.add_component(e, "transform", position=(
            -7.0 + k, rng.uniform(0.5, 2.0), rng.uniform(-0.3, 0.3)))
        shape = phys.physics.shapes.sphere(0.4) if k % 2 else \
            phys.physics.shapes.box((0.3, 0.3, 0.3))
        phys.add_rigidbody(e, shape, linvel=rng.uniform(-1, 1, 3))
    return eng


@pytest.fixture(scope="module")
def engines():
    jeng = _engine(jconfig, JEngine, jtransform, jphysics)
    jeng.build_step(donate=False)
    teng = _engine(tconfig, TEngine, ttransform, tphysics)
    j5 = jeng.run_ticks(jeng.device_state(), 5, DT)
    return jeng, teng, j5, jeng.run_ticks(j5, 5, DT)


def test_checkpoint_from_jax_steps_to_the_jax_result(engines, tmp_path):
    jeng, teng, j5, j10 = engines
    path = str(tmp_path / "jax" / "snap.npz")
    jcheckpoint.save(path, j5)
    like = teng.device_state()
    state = tcheckpoint.load(path, like)
    assert all(a.device == b.device for a, b in zip(
        jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(like)))
    for a, b in zip(jax.tree_util.tree_leaves(j5), jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    t10 = teng.run_ticks(state, 5, DT)
    np.testing.assert_array_equal(np.asarray(j10["tick"]), t10["tick"].numpy())
    np.testing.assert_array_equal(np.asarray(j10["time"]), t10["time"].numpy())
    for k in ("pos", "quat"):
        np.testing.assert_allclose(np.asarray(j10["physics"]["bodies"][k]),
                                   t10["physics"]["bodies"][k].numpy(), rtol=0, atol=TOL_POSE)
    for k in ("position", "rotation"):
        np.testing.assert_allclose(np.asarray(j10["components"]["transform"][k]),
                                   t10["components"]["transform"][k].numpy(), rtol=0,
                                   atol=TOL_POSE)


def test_checkpoint_from_the_port_loads_in_jax(engines, tmp_path):
    jeng, teng, j5, _ = engines
    tstate = teng.run_ticks(teng.device_state(), 3, DT)
    path = str(tmp_path / "torch" / "snap")
    tcheckpoint.save(path, tstate)
    assert os.path.exists(path + ".npz") and os.path.exists(path + ".npz.tree")
    with open(path + ".npz.tree", encoding="utf-8") as f:
        keys = f.read().splitlines()
    kp = jax.tree_util.tree_flatten_with_path(j5)[0]
    assert keys == [str(len(kp))] + [jax.tree_util.keystr(k) for k, _ in kp]
    assert "['components']['transform']['position']" in keys
    restored = jcheckpoint.load(path, j5)
    for a, b in zip(jax.tree_util.tree_leaves(tstate), jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's own round trip is bitwise, and a structure mismatch raises
    again = tcheckpoint.load(path, tstate)
    for a, b in zip(jax.tree_util.tree_leaves(tstate), jax.tree_util.tree_leaves(again)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    wrong = dict(tstate, components=dict(tstate["components"], extra={"x": torch.zeros(2)}))
    with pytest.raises(ValueError, match="leaves"):
        tcheckpoint.load(path, wrong)
    renamed = dict(tstate)
    renamed["timf"] = renamed.pop("time")
    with pytest.raises(ValueError, match="structure mismatch"):
        tcheckpoint.load(path, renamed)
    jrenamed = dict(j5)
    jrenamed["timf"] = jrenamed.pop("time")
    with pytest.raises(ValueError, match="structure mismatch"):
        jcheckpoint.load(path, jrenamed)
    # a leaf of another dtype in `like` raises, as the structure check does
    retyped = dict(tstate, time=tstate["time"].double())
    with pytest.raises(ValueError, match=r"\['time'\] is torch.float32"):
        tcheckpoint.load(path, retyped)


class _Poison(System):
    """Writes a NaN into the first transform row at Update."""

    def attach(self, world):
        super().attach(world)
        world.events.subscribe("Update", self.update, priority=20.0)

    def update(self, state, ctx):
        tc = state["components"]["transform"]
        pos = tc["position"].clone()
        pos[0, 1] = float("nan")
        return dict(state, components=dict(state["components"],
                                           transform=dict(tc, position=pos)))


def test_debug_guards_raise_on_an_injected_nan():
    eng = TEngine(tconfig.EngineConfig(capacity=4), device="cpu")
    eng.create_system(ttransform.TransformSystem())
    eng.create_system(_Poison())
    eng.initialize()
    eng.world.add_component(eng.world.create_entity(), "transform")
    state = eng.device_state()
    step = eng.build_step()
    out = step(state, DT)                      # guards off: no check, no raise
    assert torch.isnan(out["components"]["transform"]["position"][0, 1])
    tcheckpoint.debug_guards(True)
    try:
        with pytest.raises(FloatingPointError, match=r"\['position'\] after Update"):
            step(state, DT)
    finally:
        tcheckpoint.debug_guards(False)
    assert not tcheckpoint.guards_enabled()


def test_compilation_cache_sets_the_build_dir(tmp_path):
    old = cuda_build.BUILD_DIR
    try:
        tcheckpoint.enable_compilation_cache(str(tmp_path / "kernels"))
        assert cuda_build.BUILD_DIR == (tmp_path / "kernels").resolve()
        assert cuda_build.library_path("raster_shade").parent == cuda_build.BUILD_DIR
    finally:
        cuda_build.BUILD_DIR = old


def test_profiler_trace_zone_and_pass_timer(tmp_path):
    x = torch.arange(64.0)
    with profiler.trace(str(tmp_path / "trace")) as prof:
        with profiler.zone("garden_zone"):
            y = (x * 2).sum()
    names = {e.name for e in prof.events()}
    assert "garden_zone" in names
    with open(tmp_path / "trace" / profiler.TRACE_FILE, encoding="utf-8") as f:
        assert "garden_zone" in json.dumps(json.load(f))
    fp = profiler.FrameProfiler(smoothing=0.5)
    for _ in range(3):
        with fp.pass_timer("sum", result={"y": [y]}):
            y = (x * 3).sum()
        fp.frame_mark()
    assert fp.averages["sum"] > 0 and fp.frame_ms > 0 and fp.fps > 0
    assert "sum:" in fp.report() and fp.report().startswith("frame:")


def test_protocol_bytes_match():
    outs = []
    for mod in (jprotocol, tprotocol):
        out = mod.StreamOutput()
        out.write_u8(7)
        out.write_u16(65000)
        out.write_u32(4_000_000_000)
        out.write_u64(2 ** 60 + 3)
        out.write_i32(-5)
        out.write_f32(0.1)
        out.write_vec3((1.5, -2.25, 3.0))
        out.write_quat((0.0, 0.6, 0.0, 0.8))
        out.write_string("garden é")
        body = mod.NetRigidbody(9, (1, 2, 3), (0, 0, 0, 1), (0.5, 0, 0), (0, 0, 0.25))
        snap = mod.encode_body_snapshot([body, body])
        framed = mod.frame_message("r", snap) + mod.frame_message("c", out.data())
        dec = mod.FrameDecoder()
        msgs = list(dec.feed(framed[:5])) + list(dec.feed(framed[5:]))
        inp = mod.StreamInput(msgs[1][1])
        back = (inp.read_u8(), inp.read_u16(), inp.read_u32(), inp.read_u64(), inp.read_i32(),
                inp.read_f32(), inp.read_vec3(), inp.read_quat(), inp.read_string(),
                inp.remaining())
        outs.append((out.data(), framed, msgs, back,
                     [vars(b) for b in mod.decode_body_snapshot(snap)]))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError):
        tprotocol.frame_message("x", b"\0" * tprotocol.MAX_MESSAGE)


def _bodies(pw, cfg_mod, device=None):
    cfg = cfg_mod.PhysicsConfig(max_bodies=16, grid_dim=8)
    w = pw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=pw.STATIC)
    rng = np.random.default_rng(11)
    for k in range(9):
        q = rng.normal(size=4)
        w.add_body(w.shapes.sphere(0.5) if k % 3 else w.shapes.capsule(0.3, 0.6),
                   position=rng.uniform(-12, 12, 3), rotation=q / np.linalg.norm(q),
                   linvel=rng.normal(size=3), angvel=rng.normal(size=3),
                   motion=pw.KINEMATIC if k == 4 else pw.DYNAMIC)
    return w.device_state() if device is None else w.device_state(device)


def test_replication_matches_jax():
    js, ts = _bodies(jworld, jconfig), _bodies(tworld, tconfig, "cpu")
    uid = np.full(16, -1, np.int64)
    uid[1:9] = 100 + np.arange(8)
    for kw in ({}, {"view_center": (1.0, 0.0, -2.0), "view_radius": 11.0}):
        jp = jreplication.gather_snapshots(js, uid, **kw)
        tp = treplication.gather_snapshots(ts, uid, **kw)
        assert jp == tp and len(jprotocol.decode_body_snapshot(jp)) >= 3
    # applied into a second world: the same poses in every bit
    payload = treplication.gather_snapshots(ts, uid)
    to_body = {100 + k: 9 - k for k in range(8)}
    ja = jreplication.apply_snapshots(_bodies(jworld, jconfig), payload, to_body)
    ta = treplication.apply_snapshots(_bodies(tworld, tconfig, "cpu"), payload, to_body)
    for k in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_array_equal(np.asarray(ja["bodies"][k]), ta["bodies"][k].numpy(),
                                      err_msg=k)
    # characters: the 'c' message both ways
    chars = {"has": np.array([False, True, True] + [False] * 5),
             "body": np.array([-1, 2, 5] + [-1] * 5, np.int32),
             "grounded": np.array([False, True, False] + [False] * 5)}
    assert jreplication.gather_character(js, chars, {1: 77, 2: 78}) == \
        treplication.gather_character(ts, {k: torch.tensor(v) for k, v in chars.items()},
                                      {1: 77, 2: 78})
    cp = treplication.gather_character(ts, chars, {1: 77, 2: 78})
    jc = jreplication.apply_character(_bodies(jworld, jconfig), chars, cp, {77: 2, 78: 1})
    tc = treplication.apply_character(_bodies(tworld, tconfig, "cpu"), chars, cp,
                                      {77: 2, 78: 1})
    for k in ("pos", "linvel"):
        np.testing.assert_array_equal(np.asarray(jc["bodies"][k]), tc["bodies"][k].numpy())
    # the gather and apply leave the input state alone
    before = ts["bodies"]["pos"].clone()
    treplication.apply_snapshots(ts, payload, to_body)
    assert torch.equal(ts["bodies"]["pos"], before)


def test_a_body_named_twice_keeps_the_last_entry():
    ts = _bodies(tworld, tconfig, "cpu")
    first = tprotocol.NetRigidbody(5, (1, 1, 1), (0, 0, 0, 1), (0, 0, 0), (0, 0, 0))
    last = tprotocol.NetRigidbody(6, (2, 3, 4), (0, 1, 0, 0), (1, 0, 0), (0, 0, 1))
    payload = tprotocol.encode_body_snapshot([first, last])
    out = treplication.apply_snapshots(ts, payload, {5: 3, 6: 3})
    assert out["bodies"]["pos"][3].tolist() == [2.0, 3.0, 4.0]
    assert out["bodies"]["quat"][3].tolist() == [0.0, 1.0, 0.0, 0.0]
    assert treplication.apply_snapshots(ts, payload, {}) is ts
    net = treplication.NetworkSystem()
    w = World(capacity=4, device="cpu")
    w.create_system(net)
    e = w.create_entity()
    net.bind(e, entity_uid=2 ** 40, client_uid=3, is_client_owned=True)
    assert net.entity_of(2 ** 40) == e and w._stores["network"]["entity_uid"][e] == 2 ** 40
