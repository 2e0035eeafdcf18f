"""Physics worlds that exercise the port's step.

`bench_world` is the JAX package's `bench.py` world (`build_world`): a
plane and 10,239 alternating boxes and spheres of 0.45 m on a 1.05 m
lattice, with its PhysicsConfig (7 grid candidates and 1 global a body, 8
solver iterations). `mixed_world` holds every shape type (sphere, box,
capsule, hull, compound, plane, heightfield and mesh), one point joint, and
sleep on: the smoke test runs it on the card against the CPU, and the
card's unit tests use it. Bodies are placed from a numpy seed.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from garden_tpu_torch.core.config import PhysicsConfig
from garden_tpu_torch.physics import constraints as con
from garden_tpu_torch.physics import world as pw

def contact_scene(table_cls) -> Dict[str, Any]:
    """Numpy inputs of the narrowphase for every pair family: a table of
    `table_cls` (this package's ShapeTable, or any class with its methods)
    holding every shape type, a tetrahedral hull among them, and six bodies
    of each convex type (sphere, box, capsule, hull, tetrahedron, compound)
    at random poses over a tilted plane, a heightfield and a triangle mesh,
    which are the last three bodies."""
    rng = np.random.default_rng(0)
    t = table_cls(capacity=64, max_hulls=4, max_heightfields=2, hf_dim=16,
                  max_compounds=4, max_meshes=2, mesh_max_tris=64, mesh_grid=4,
                  mesh_bucket=48)
    ids = {"sphere": t.sphere(0.4), "box": t.box((0.4, 0.3, 0.5)),
           "capsule": t.capsule(0.25, 0.4)}
    cube = np.array([[x, y, z] for x in (-.4, .4) for y in (-.35, .35)
                     for z in (-.45, .45)], np.float32)
    ids["hull"] = t.hull(cube + rng.normal(0, 0.05, cube.shape).astype(np.float32))
    ids["tetra"] = t.hull(np.array([[0, 0.5, 0], [0.5, -0.3, 0.2], [-0.4, -0.3, 0.3],
                                    [0, -0.3, -0.5]], np.float32))
    s2, b2, c2 = t.sphere(0.2), t.box((0.2, 0.15, 0.3)), t.capsule(0.15, 0.2)
    ids["compound"] = t.compound([
        (s2, (0.3, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)),
        (b2, (-0.3, 0.1, 0.0), (0.0, 0.38268343, 0.0, 0.92387953)),
        (c2, (0.0, 0.0, 0.3), (0.38268343, 0.0, 0.0, 0.92387953))])
    ids["plane"] = t.plane((0.1, 1.0, -0.05), 0.2)
    ids["heightfield"] = t.heightfield(
        rng.uniform(-0.3, 0.3, (12, 14)).astype(np.float32), 0.5)
    g = np.linspace(-2.0, 2.0, 6)
    verts = np.array([[x, rng.uniform(-0.3, 0.3), z] for z in g for x in g], np.float32)
    faces = [[i * 6 + j, i * 6 + j + 6, i * 6 + j + 1] for i in range(5) for j in range(5)]
    faces += [[i * 6 + j + 1, i * 6 + j + 6, i * 6 + j + 7] for i in range(5) for j in range(5)]
    ids["mesh"] = t.mesh(verts, np.array(faces, np.int32))

    rng = np.random.default_rng(1)
    shape_of = [ids[name] for name in ("sphere", "box", "capsule", "hull", "tetra",
                                       "compound") for _ in range(6)]
    n_conv = len(shape_of)
    shape_of += [ids["plane"], ids["heightfield"], ids["mesh"]]
    n = len(shape_of)
    pos = np.zeros((n, 3), np.float32)
    pos[:n_conv, 0] = rng.uniform(-1.6, 1.6, n_conv)
    pos[:n_conv, 2] = rng.uniform(-1.6, 1.6, n_conv)
    pos[:n_conv, 1] = rng.uniform(-0.3, 0.9, n_conv)
    pos[n_conv + 1] = (0.1, -0.05, 0.0)
    pos[n_conv + 2] = (-0.1, 0.02, 0.1)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[n_conv:] = [[0, 0, 0, 1], [0.05, 0, 0.03, 1], [0, 0.1, 0.04, 1]]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(table=t, ids=ids, pos=pos, q=q, stype=t.types[shape_of].copy(),
                params=t.params[shape_of].copy(),
                margin=rng.uniform(0.05, 0.15, n).astype(np.float32), n_conv=n_conv)


def bench_world(device, n: int = 10240) -> Tuple[Dict[str, Any], PhysicsConfig, frozenset]:
    """(state, config, present_types) of bench.py's world at n bodies. Its
    active budget covers all 8 candidate pairs, so collide takes the
    compaction-free branch."""
    cfg = PhysicsConfig(max_bodies=n, grid_dim=64, cell_size=2.0,
                        max_contacts_per_body=7, solver_iterations=8,
                        max_globals=1, max_active_contacts=16)
    w = pw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0.0, 1.0, 0.0), 0.0), motion=pw.STATIC)
    box = w.shapes.box((0.45, 0.45, 0.45))
    sph = w.shapes.sphere(0.45)
    count, side = 0, 22
    for ix in range(side):
        for iz in range(side):
            for iy in range(side):
                if count >= n - 1:
                    break
                w.add_body(box if count % 2 == 0 else sph,
                           position=(ix * 1.05 - side / 2, 0.5 + iy * 1.05,
                                     iz * 1.05 - side / 2), friction=0.5)
                count += 1
    return w.device_state(device), cfg, w.shapes.present_types()


MIXED_CONFIG = PhysicsConfig(max_bodies=48, grid_dim=16, cell_size=2.0,
                             max_contacts_per_body=8, max_globals=3,
                             max_active_contacts=12, sleep_enabled=True)


def _ramp_mesh(n: int = 6, size: float = 4.0, rise: float = 0.8):
    """A square grid of CCW triangles (normals up) rising along +x."""
    g = np.linspace(-size / 2, size / 2, n)
    verts = np.array([[x, rise * (x + size / 2) / size, z] for z in g for x in g],
                     np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + n, a + 1], [a + 1, a + n, a + n + 1]]
    return verts, np.array(faces, np.int32)


def mixed_world(device) -> Tuple[Dict[str, Any], PhysicsConfig, frozenset]:
    """(state, config, present_types): a plane, a heightfield and a mesh
    ramp (static), and spheres, boxes, capsules, two hulls and two compounds
    dropped over them, a sphere hung from a static anchor by a point joint."""
    rng = np.random.default_rng(0)
    w = pw.PhysicsWorld(MIXED_CONFIG)
    sh = w.shapes
    w.add_body(sh.plane((0.0, 1.0, 0.0), 0.5), motion=pw.STATIC)          # y = -0.5
    hf = rng.uniform(-0.15, 0.15, (10, 10)).astype(np.float32)
    w.add_body(sh.heightfield(hf, 0.5), position=(-3.5, -0.3, 0.0), motion=pw.STATIC)
    w.add_body(sh.mesh(*_ramp_mesh()), position=(3.5, -0.45, 0.0), motion=pw.STATIC)
    cube = np.array([[x, y, z] for x in (-.3, .3) for y in (-.25, .25) for z in (-.3, .3)],
                    np.float32)
    small = sh.sphere(0.15)
    kinds = [sh.sphere(0.3), sh.box((0.3, 0.25, 0.35)), sh.capsule(0.2, 0.3),
             sh.hull(cube + rng.normal(0, 0.03, cube.shape).astype(np.float32)),
             sh.compound([(small, (0.25, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)),
                          (sh.box((0.15, 0.15, 0.15)), (-0.25, 0.0, 0.0),
                           (0.0, 0.0, 0.0, 1.0))])]
    count = 0
    for x in (-4.5, -3.0, -1.5, 0.0, 1.5, 3.0, 4.5):
        for z in (-1.2, 0.0, 1.2):
            kind = kinds[count % len(kinds)]
            ang = rng.uniform(-0.4, 0.4)
            w.add_body(kind, position=(x + rng.uniform(-0.1, 0.1), 0.6 + 0.8 * (count % 3),
                                       z),
                       rotation=(0.0, float(np.sin(ang / 2)), 0.0, float(np.cos(ang / 2))),
                       friction=0.5, restitution=0.1)
            count += 1
    # a box at rest on the plane, apart from the rest: it falls asleep
    w.add_body(kinds[1], position=(0.0, -0.25, -3.5), friction=0.5)
    anchor = w.add_body(small, position=(0.0, 4.0, 3.0), motion=pw.STATIC)
    bob = w.add_body(sh.sphere(0.2), position=(1.0, 4.0, 3.0))
    table = con.ConstraintTable(4)
    table.point(anchor, bob, (0.0, 4.0, 3.0), w._b["pos"][anchor], w._b["quat"][anchor],
                w._b["pos"][bob], w._b["quat"][bob])
    state = w.device_state(device)
    state["constraints"] = table.device_arrays(device)
    return state, MIXED_CONFIG, sh.present_types()
