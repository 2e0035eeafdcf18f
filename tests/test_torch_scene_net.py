"""Parity of the port's scene serializer (`scene/scene.py`) and stream
transport (`net/transport.py`) with the JAX package's.

Scenes: the same content built in both packages stores to the same
`.scene` JSON and BSON bytes, and a scene stored by either package loads
in the other, entity for entity, with the same component values; the
mirrors of tests/test_scene.py's roundtrips run on the port. Transport: the
mirrors of tests/test_net.py's TCP echo and UDP cases, each under its own
time limit, so that a stuck event loop fails instead of hanging.

Tolerance: none; every byte and stored value is equal.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import asyncio
import json

import numpy as np
import pytest

from garden_tpu.assets import bson as jbson
from garden_tpu.core import config as jconfig
from garden_tpu.engine import Engine as JEngine
from garden_tpu.net import transport as jtransport
from garden_tpu.scene import scene as jscene
from garden_tpu.systems import animation as janim
from garden_tpu.systems import camera as jcamera
from garden_tpu.systems import link as jlink
from garden_tpu.systems import physics as jphysics
from garden_tpu.systems import spawner as jspawner
from garden_tpu.systems import transform as jtransform
from garden_tpu.systems import ui as jui
from garden_tpu_torch.assets import bson as tbson
from garden_tpu_torch.core import config as tconfig
from garden_tpu_torch.engine import Engine as TEngine
from garden_tpu_torch.net import transport as ttransport
from garden_tpu_torch.physics import shapes as tsh
from garden_tpu_torch.scene import scene as tscene
from garden_tpu_torch.systems import animation as tanim
from garden_tpu_torch.systems import camera as tcamera
from garden_tpu_torch.systems import link as tlink
from garden_tpu_torch.systems import physics as tphysics
from garden_tpu_torch.systems import spawner as tspawner
from garden_tpu_torch.systems import transform as ttransform
from garden_tpu_torch.systems import ui as tui

NET_LIMIT_S = 10.0     # each network case's own limit

JAX = dict(cfg=jconfig, eng=lambda c: JEngine(c), tr=jtransform, cam=jcamera, link=jlink,
           phys=jphysics, anim=janim, spawn=jspawner, ui=jui, scene=jscene)
PORT = dict(cfg=tconfig, eng=lambda c: TEngine(c, device="cpu"), tr=ttransform,
            cam=tcamera, link=tlink, phys=tphysics, anim=tanim, spawn=tspawner, ui=tui,
            scene=tscene)


def _engine(p):
    cfg = p["cfg"].EngineConfig(capacity=32, physics=p["cfg"].PhysicsConfig(
        max_bodies=32, grid_dim=8))
    eng = p["eng"](cfg)
    for s in (p["tr"].TransformSystem(), p["cam"].CameraSystem(), p["link"].LinkSystem(),
              p["phys"].PhysicsSystem(cfg.physics),
              p["anim"].AnimationSystem(max_tracks=4, max_keyframes=4),
              p["spawn"].SpawnerSystem(), p["ui"].UiTransformSystem(),
              p["ui"].UiButtonSystem(), p["ui"].UiCheckboxSystem(),
              p["ui"].UiLabelSystem(), p["ui"].UiInputSystem()):
        eng.create_system(s)
    eng.initialize()
    return eng


def _populate(p):
    """The content of tests/test_scene.py's three roundtrips in one world,
    with fixed uids (the link system draws random ones otherwise)."""
    eng = _engine(p)
    w = eng.world
    link, phys = w.systems["LinkSystem"], w.systems["PhysicsSystem"]
    shapes = phys.physics.shapes

    def ent(**transform):
        e = w.create_entity()
        w.add_component(e, "transform", **transform)
        link.add_link(e, f"uid-{e:02d}")
        return e

    parent = ent(position=[1, 2, 3])
    ent(position=[0, 1, 0], parent=parent, scale=[2, 2, 2])
    cam = ent(position=[0, 5, 10])
    w.add_component(cam, "camera", fov_y=1.2)
    ball = ent(position=[0, 3, 0])
    phys.add_rigidbody(ball, shapes.sphere(0.5), restitution=0.4)
    pts = np.array([[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.4, 0.4)
                    for sz in (-0.3, 0.3)], np.float32)
    e = ent(position=[0, 2, 0])
    phys.add_rigidbody(e, shapes.hull(pts), position=(0, 2, 0))
    grid = np.fromfunction(lambda z, x: 0.1 * x, (8, 8), dtype=np.float32)
    e = ent()
    phys.add_rigidbody(e, shapes.heightfield(grid, cell=2.0), motion=0)
    s0 = shapes.sphere(0.25)
    e = ent(position=[3, 1, 0])
    phys.add_rigidbody(e, shapes.compound([(s0, (-0.4, 0, 0), (0, 0, 0, 1)),
                                           (shapes.box((0.2, 0.1, 0.3)), (0.4, 0, 0),
                                            (0, 0, 0.3826834, 0.9238795))]),
                       position=(3, 1, 0), linvel=(1, 0, 0))
    e = ent(position=[-2, 1, 0], rotation=[0, 0.7071068, 0, 0.7071068])
    phys.add_rigidbody(e, shapes.capsule(0.3, 0.5), motion=1)
    track = w.systems["AnimationSystem"].add_track(
        [{"time": 0.0, "position": [0, 0, 0]}, {"time": 1.0, "position": [1, 0, 0]}],
        name="bounce")
    e = ent()
    w.add_component(e, "animation", track=track, speed=1.5, looped=False)
    w.add_component(e, "spawner", delay=0.7, max_count=5)
    u = ent()
    w.add_component(u, "ui_transform", position=[10, 20], size=[80, 30], anchor=1)
    w.add_component(u, "ui_checkbox", checked=True)
    lab = ent()
    w.add_component(lab, "ui_label", scale=1.5)
    w.systems["UiLabelSystem"].set_text(lab, "Score: 42")
    inp = ent()
    w.add_component(inp, "ui_input", max_length=32)
    w.systems["UiInputSystem"].set_text(inp, "player1")
    hidden = w.create_entity()
    w.add_component(hidden, "transform", do_not_serialize=True)
    return eng


def _snapshot(eng, created):
    """Every stored value of the created entities, in creation order, plus
    the body rows and shapes their rigidbodies name, as plain Python."""
    w = eng.world
    phys = w.systems["PhysicsSystem"].physics
    out = []
    for e in created:
        comps = {}
        for name, store in w._stores.items():
            if store["has"][e]:
                comps[name] = {k: np.asarray(v[e]).tolist() for k, v in store.items()
                               if k not in ("body", "track")}
        if "rigidbody" in comps:
            b = int(w._stores["rigidbody"]["body"][e])
            comps["body"] = {k: np.asarray(v[b]).tolist() for k, v in phys._b.items()
                             if k not in ("shape", "entity")}
            sh = int(phys._b["shape"][b])
            comps["shape"] = (int(phys.shapes.types[sh]), phys.shapes.params[sh].tolist())
        for sys_name in ("UiLabelSystem", "UiInputSystem"):
            if sys_name in w.systems and w._stores[
                    "ui_label" if "Label" in sys_name else "ui_input"]["has"][e]:
                comps[sys_name] = w.systems[sys_name].text(e)
        out.append(comps)
    return out


def _load(p, path):
    eng = _engine(p)
    eng.world.systems["AnimationSystem"].add_track(
        [{"time": 0.0, "position": [0, 0, 0]}, {"time": 1.0, "position": [1, 0, 0]}],
        name="bounce")
    created = p["scene"].SceneSerializer(eng.world).load_scene(path)
    return eng, created


def test_scene_bytes_match(tmp_path):
    """The same world stores to the same .scene JSON and BSON bytes."""
    paths = {}
    for tag, p in (("jax", JAX), ("port", PORT)):
        eng = _populate(p)
        paths[tag] = tmp_path / f"{tag}.scene"
        scene = p["scene"].SceneSerializer(eng.world).store_scene(str(paths[tag]))
        assert len(scene["entities"]) == 12
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    jbson.json2bson(str(paths["jax"]), str(tmp_path / "jax.bson"))
    tbson.json2bson(str(paths["port"]), str(tmp_path / "port.bson"))
    assert (tmp_path / "port.bson").read_bytes() == (tmp_path / "jax.bson").read_bytes()


@pytest.mark.parametrize("fmt", ["json", "bson"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scene_loads_across_packages(tmp_path, writer, fmt):
    """A scene stored by either package loads in both to the same entities,
    components, body rows, shapes and widget text; stored again, it gives
    the writer's bytes."""
    src = JAX if writer == "jax" else PORT
    path = tmp_path / "w.scene"
    src["scene"].SceneSerializer(_populate(src).world).store_scene(str(path))
    if fmt == "bson":
        jbson.json2bson(str(path), str(tmp_path / "w.bson"))
        path = tmp_path / "w.bson"
    loaded = {tag: _load(p, str(path)) for tag, p in (("jax", JAX), ("port", PORT))}
    assert len(loaded["jax"][1]) == len(loaded["port"][1]) == 12
    assert _snapshot(*loaded["port"]) == _snapshot(*loaded["jax"])
    again = {}
    for tag, p in (("jax", JAX), ("port", PORT)):
        again[tag] = p["scene"].SceneSerializer(loaded[tag][0].world).store_scene()
    assert json.dumps(again["port"]) == json.dumps(again["jax"])


def test_scene_roundtrip_on_the_port(tmp_path):
    """tests/test_scene.py's checks on the port: hierarchy by uid, camera,
    restitution, shapes, heightfield data, a track found by name in
    another index order, widgets; clear_scene and DoNotDestroy."""
    eng = _populate(PORT)
    path = str(tmp_path / "t.scene")
    tscene.SceneSerializer(eng.world).store_scene(path)
    eng2 = _engine(PORT)
    anim2 = eng2.world.systems["AnimationSystem"]
    anim2.add_track([{"time": 0.0}], name="other")
    track2 = anim2.add_track([{"time": 0.0, "position": [0, 0, 0]},
                              {"time": 1.0, "position": [1, 0, 0]}], name="bounce")
    ser2 = tscene.SceneSerializer(eng2.world)
    created = ser2.load_scene(path)
    s = eng2.world._stores
    t = s["transform"]
    child = [e for e in created if t["has"][e] and tuple(t["scale"][e]) == (2.0, 2.0, 2.0)][0]
    p2 = int(t["parent"][child])
    assert p2 >= 0 and tuple(t["position"][p2]) == (1.0, 2.0, 3.0)
    cam = [e for e in created if s["camera"]["has"][e]][0]
    assert abs(float(s["camera"]["fov_y"][cam]) - 1.2) < 1e-6
    phys2 = eng2.world.systems["PhysicsSystem"].physics
    types = sorted(int(x) for x in phys2.shapes.types[:phys2.shapes.count()])
    assert {tsh.HULL, tsh.HEIGHTFIELD, tsh.COMPOUND, tsh.CAPSULE} <= set(types)
    hfi = [i for i in range(phys2.shapes.count()) if phys2.shapes.types[i] == tsh.HEIGHTFIELD][0]
    grid = np.fromfunction(lambda z, x: 0.1 * x, (8, 8), dtype=np.float32)
    np.testing.assert_allclose(phys2.shapes.hf_heights[int(phys2.shapes.params[hfi, 0]), :8, :8],
                               grid, atol=1e-6)
    rb = s["rigidbody"]
    rest = [float(phys2._b["restitution"][int(rb["body"][e])]) for e in created if rb["has"][e]]
    assert 0.4 in [round(r, 6) for r in rest]
    anim_e = [x for x in created if s["animation"]["has"][x]][0]
    assert int(s["animation"]["track"][anim_e]) == track2
    ui_e = [x for x in created if s["ui_transform"]["has"][x]][0]
    np.testing.assert_allclose(s["ui_transform"]["size"][ui_e], [80, 30])
    assert s["ui_checkbox"]["checked"][ui_e]
    keep = eng2.world.create_entity()
    eng2.world.add_component(keep, "transform", do_not_destroy=True)
    ser2.clear_scene()
    assert eng2.world.entity_count() == 1 and eng2.world.is_alive(keep)


# -- transport ---------------------------------------------------------------------------


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, NET_LIMIT_S))


def test_client_server_echo():
    async def run():
        server = ttransport.StreamServer()
        received, connects = [], []
        server.on_connect = lambda s: connects.append(s.id)

        def on_ping(session, t, payload):
            received.append(payload)
            session.send("o", payload[::-1])

        server.register("p", on_ping)
        await server.start()
        client = ttransport.StreamClient()
        replies = []
        client.register("o", lambda s, t, p: replies.append(p))
        await client.connect("127.0.0.1", server.port)
        client.send("p", b"abc")
        client.send("p", b"")
        await client.writer.drain()
        for _ in range(40):
            await client.poll()
            if len(replies) == 2:
                break
        await client.close()
        await server.stop()
        return received, replies, connects

    received, replies, connects = _run(run())
    assert received == [b"abc", b""] and replies == [b"cba", b""] and len(connects) == 1


def test_port_client_talks_to_the_jax_server():
    """The framing is the same bytes: a port client against the reference
    server, and a reference client against the port server."""
    async def pair(server_mod, client_mod):
        server = server_mod.StreamServer()
        server.register("p", lambda s, t, p: s.send("o", p + b"!"))
        await server.start()
        client = client_mod.StreamClient()
        got = []
        client.register("o", lambda s, t, p: got.append(p))
        await client.connect("127.0.0.1", server.port)
        client.send("p", b"hello")
        await client.writer.drain()
        for _ in range(40):
            await client.poll()
            if got:
                break
        await client.close()
        await server.stop()
        return got

    assert _run(pair(jtransport, ttransport)) == [b"hello!"]
    assert _run(pair(ttransport, jtransport)) == [b"hello!"]


def test_udp_datagram_endpoint():
    async def run():
        server = ttransport.DatagramEndpoint()
        got = []
        server.register("s", lambda addr, t, p: got.append((t, p)))
        addr = await server.bind()
        client = ttransport.DatagramEndpoint()
        await client.bind()
        client.send_to(addr, "s", b"\x01\x02\x03")
        client.send_to(addr, "s", b"hello")
        for _ in range(200):
            if len(got) == 2:
                break
            await asyncio.sleep(0.01)
        client.close()
        server.close()
        return got, server.received

    got, n = _run(run())
    assert got == [("s", b"\x01\x02\x03"), ("s", b"hello")] and n == 2
