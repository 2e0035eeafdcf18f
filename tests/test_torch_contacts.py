"""Parity of the port's shape tables and contact manifolds with
`garden_tpu.physics` for every shape type and pair family.

`physics.scenes.contact_scene` builds one table with every shape type (a
tetrahedral hull among them, with fewer vertices than the others) and
places six bodies of each convex type over a tilted plane, a heightfield
and a triangle mesh, once with each package's ShapeTable. Each
family's manifolds come from the JAX package's jitted `generate_contacts`
(pruned to the family's types) and from the port on the same rows, in both
row orders, and must agree: valid masks exactly, points and depths within
1e-5 (float32 sums in another order, and XLA's fused multiply-adds), and
normals within 1e-5 or, where the normal is the difference of two nearly
coincident points over its length, within ULP_POS / sep: an ulp of
position (ULP_POS at these coordinates) turns such a normal by that much
(sep = the sphere radii of the pair less the depth, the distance of the two
points). Compound families call the
compound kernels themselves (their dispatch through `generate_contacts`
compiles for minutes under XLA), and the port's dispatch of compound rows
is held to those kernels bit for bit. The sphere and capsule heightfield
pairs rank fewer than 4 candidates, so they cover the top-4 padding.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.physics import narrowphase as jnp_
from garden_tpu.physics import shapes as jsh
from garden_tpu_torch.physics import narrowphase as tnp
from garden_tpu_torch.physics import scenes
from garden_tpu_torch.physics import shapes as tsh

S, B, C, H, CO, PL, HF, M = (tsh.SPHERE, tsh.BOX, tsh.CAPSULE, tsh.HULL, tsh.COMPOUND,
                             tsh.PLANE, tsh.HEIGHTFIELD, tsh.MESH)
CHILDREN = frozenset((S, B, C))


@pytest.fixture(scope="module")
def scene():
    """`scenes.contact_scene` built twice, with each package's ShapeTable."""
    ref = scenes.contact_scene(jsh.ShapeTable)
    port = scenes.contact_scene(tsh.ShapeTable)
    assert ref["ids"] == port["ids"]
    for k in ("pos", "q", "stype", "params", "margin"):
        np.testing.assert_array_equal(ref[k], port[k])
    return dict(ref, jt=ref["table"], tt=port["table"], jtab=ref["table"].device_arrays(),
                ttab=port["table"].device_arrays("cpu"))


ULP_POS = 2.4e-7


def _assert_manifolds(jm, tm, radii=None, atol=1e-5):
    """radii (P,): the sphere radii summed over each pair (0: no sphere)."""
    jm = {k: np.asarray(v) for k, v in jm.items()}
    jv = jm["valid"]
    np.testing.assert_array_equal(jv, tm["valid"].numpy())
    for k in ("point", "pen"):
        np.testing.assert_allclose(jm[k][jv], tm[k].numpy()[jv], rtol=0, atol=atol,
                                   err_msg=k)
    sep = (np.zeros(jv.shape[0], np.float32) if radii is None else radii)[:, None] - jm["pen"]
    tol = np.maximum(atol, ULP_POS / np.maximum(sep, 1e-9))[..., None]
    err = np.abs(jm["normal"] - tm["normal"].numpy())
    assert np.all((err <= tol)[jv]), ("normal", float(err[jv].max()))
    return int(jv.sum())


def test_shape_tables_match(scene):
    """device_arrays equal the reference's key for key, every type in."""
    jd = jax.device_get(scene["jtab"])
    td = scene["ttab"]
    assert set(jd) == set(td) and len(td) == 19
    for k in jd:
        assert td[k].dtype == torch.as_tensor(np.asarray(jd[k])).dtype, k
        np.testing.assert_array_equal(jd[k], td[k].numpy(), err_msg=k)
    assert scene["tt"].present_types() == scene["jt"].present_types()


def test_mass_properties_and_aabbs_every_type(scene):
    jt, tt = scene["jt"], scene["tt"]
    for i in range(tt.count()):
        jm, ji = jt.body_mass_properties(i)
        tm, ti = tt.body_mass_properties(i)
        np.testing.assert_allclose(tm, jm, rtol=1e-6)
        np.testing.assert_allclose(ti, ji, rtol=1e-6)
    n = tt.count()
    st, prm, den = tt.types[:n], tt.params[:n], tt.density[:n]
    jmass, jin = jsh.mass_properties(jnp.asarray(st), jnp.asarray(prm), jnp.asarray(den))
    tmass, tin = tsh.mass_properties(torch.as_tensor(st), torch.as_tensor(prm),
                                     torch.as_tensor(den))
    np.testing.assert_allclose(jmass, tmass.numpy(), rtol=1e-6)
    np.testing.assert_allclose(jin, tin.numpy(), rtol=1e-6)
    side = prm[:, 0].astype(np.int32)
    hull_ext = jt.hull_local_extent()[side % 4]
    comp_ext = jt.compound_local_extent()[side % 4]
    jl = jsh.local_aabb(jnp.asarray(st), jnp.asarray(prm), hull_ext=jnp.asarray(hull_ext),
                        comp_ext=jnp.asarray(comp_ext))
    tl = tsh.local_aabb(torch.as_tensor(st), torch.as_tensor(prm),
                        hull_ext=torch.as_tensor(hull_ext), comp_ext=torch.as_tensor(comp_ext))
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert set(np.unique(st)) == {S, B, C, H, CO, PL, HF, M}


FAMILIES = [(S, S), (S, B), (S, C), (S, PL), (B, B), (B, C), (B, PL), (C, C), (C, PL),
            (S, H), (B, H), (C, H), (H, H), (H, PL),
            (S, HF), (B, HF), (C, HF), (H, HF),
            (S, M), (B, M), (C, M), (H, M)]


@pytest.mark.parametrize("family", FAMILIES,
                         ids=[f"{tsh.SHAPE_NAMES[a]}-{tsh.SHAPE_NAMES[b]}" for a, b in FAMILIES])
def test_manifolds_match(scene, family):
    x, y = family
    st = scene["stype"]
    n = len(st)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    rows = (ii != jj) & (((st[ii] == x) & (st[jj] == y)) | ((st[ii] == y) & (st[jj] == x)))
    pi, pj = ii[rows].astype(np.int32), jj[rows].astype(np.int32)   # both orders
    valid = np.ones(pi.shape, bool)
    valid[::7] = False
    types = frozenset(family)
    gen = jax.jit(jnp_.generate_contacts, static_argnames=("present_types",))
    jm = gen(scene["pos"], scene["q"], st, scene["params"], pi, pj, valid,
             margin=jnp.asarray(scene["margin"]), present_types=types, tables=scene["jtab"])
    t = torch.as_tensor
    tm = tnp.generate_contacts(t(scene["pos"]), t(scene["q"]), t(st), t(scene["params"]),
                               t(pi), t(pj), t(valid), margin=t(scene["margin"]),
                               present_types=types, tables=scene["ttab"])
    np.testing.assert_array_equal(np.asarray(jm["a"]), tm["a"].numpy())
    prm, ta, tb = scene["params"], st[np.asarray(jm["a"])], st[np.asarray(jm["b"])]
    radii = (np.where(np.isin(ta, (S, C)), prm[np.asarray(jm["a"]), 0], 0.0)
             + np.where(np.isin(tb, (S, C)), prm[np.asarray(jm["b"]), 0], 0.0))
    assert _assert_manifolds({k: jm[k] for k in ("point", "normal", "pen", "valid")},
                             tm, radii.astype(np.float32)) > 0, "the family never touched"


def _compound_args(scene, kernel):
    """The kernel's positional args (numpy) on 30 pairs of the scene."""
    rng = np.random.default_rng(5)
    p, q, prm, st = scene["pos"], scene["q"], scene["params"], scene["stype"]
    comp = np.flatnonzero(st == CO)
    conv = np.flatnonzero(np.isin(st, (S, B, C)))
    hull = np.flatnonzero(st == H)
    n_conv = scene["n_conv"]
    k = 30
    ia, ib = rng.choice(comp, k), rng.choice(comp, k)
    at = lambda idx: (p[idx], q[idx], prm[idx])
    field = lambda off: at(np.full(k, n_conv + off))
    if kernel == "convex_compound":
        ic = rng.choice(conv, k)
        return (st[ic],) + at(ic) + at(ib)
    if kernel == "compound_compound":
        return at(ia) + at(ib)
    if kernel == "compound_plane":
        pp, qq, pr = field(0)
        return at(ia) + tuple(np.asarray(v) for v in jax.jit(jnp_._plane_world)(pp, qq, pr))
    if kernel == "compound_heightfield":
        return at(ia) + field(1)
    if kernel == "compound_mesh":
        return at(ia) + field(2)
    return at(rng.choice(hull, k)) + at(ib)          # hull_compound


# compound_compound runs on sphere children alone: its XLA build with
# every child kernel takes half a minute; convex_compound covers them all
COMPOUND_KERNELS = {"convex_compound": CHILDREN, "compound_compound": frozenset((S,)),
                    "compound_plane": CHILDREN, "compound_heightfield": None,
                    "compound_mesh": None, "hull_compound": CHILDREN}


@pytest.mark.parametrize("kernel", list(COMPOUND_KERNELS))
def test_compound_manifolds_match(scene, kernel):
    args = _compound_args(scene, kernel)
    present = COMPOUND_KERNELS[kernel]
    margin = scene["margin"][:30]
    tail = (scene["jtab"], jnp.asarray(margin)) + ((present,) if present else ())
    jm = jax.jit(lambda *a: getattr(jnp_, kernel)(*a, *tail))(*args)
    ttail = (scene["ttab"], torch.as_tensor(margin)) + ((present,) if present else ())
    tm = getattr(tnp, kernel)(*(torch.as_tensor(np.asarray(a)) for a in args), *ttail)
    assert _assert_manifolds(jm, tm) > 0, "no compound contact"


def test_compound_dispatch_selects_the_kernels(scene):
    """generate_contacts on compound rows equals the compound kernels."""
    st = torch.as_tensor(scene["stype"])
    t = torch.as_tensor
    pos, q, prm = t(scene["pos"]), t(scene["q"]), t(scene["params"])
    comp = np.flatnonzero(scene["stype"] == CO)
    conv = np.flatnonzero(np.isin(scene["stype"], (S, B, C, H)))
    n_conv = scene["n_conv"]
    pi = np.concatenate([comp[:, None].repeat(len(conv), 1).ravel(), comp.repeat(3),
                         comp[:-1]]).astype(np.int32)
    pj = np.concatenate([np.tile(conv, len(comp)),
                         np.tile(np.arange(n_conv, n_conv + 3), len(comp)),
                         comp[1:]]).astype(np.int32)
    margin = t(scene["margin"])
    out = tnp.generate_contacts(pos, q, st, prm, t(pi), t(pj), torch.ones(len(pi), dtype=torch.bool),
                                margin=margin, present_types=scene["tt"].present_types(),
                                tables=scene["ttab"])
    a, b = out["a"].long(), out["b"].long()
    ta, tb = st[a], st[b]
    pm = torch.maximum(margin[a], margin[b])
    tabs, present = scene["ttab"], scene["tt"].present_types()
    n_w, d_w = tnp._plane_world(pos[b], q[b], prm[b])
    expect = {
        "convex": tnp.convex_compound(ta, pos[a], q[a], prm[a], pos[b], q[b], prm[b], tabs,
                                      pm, present),
        "hull": tnp.hull_compound(pos[a], q[a], prm[a], pos[b], q[b], prm[b], tabs, pm,
                                  present),
        "plane": tnp.compound_plane(pos[a], q[a], prm[a], n_w, d_w, tabs, pm, present),
        "hf": tnp.compound_heightfield(pos[a], q[a], prm[a], pos[b], q[b], prm[b], tabs, pm),
        "mesh": tnp.compound_mesh(pos[a], q[a], prm[a], pos[b], q[b], prm[b], tabs, pm),
        "comp": tnp.compound_compound(pos[a], q[a], prm[a], pos[b], q[b], prm[b], tabs, pm,
                                      present),
    }
    rows = {"convex": (ta <= C) & (tb == CO), "hull": (ta == H) & (tb == CO),
            "plane": (ta == CO) & (tb == PL), "hf": (ta == CO) & (tb == HF),
            "mesh": (ta == CO) & (tb == M), "comp": (ta == CO) & (tb == CO)}
    for name, r in rows.items():
        assert bool(r.any()), name
        for k in ("point", "normal", "pen", "valid"):
            assert torch.equal(out[k][r], expect[name][k][r]), (name, k)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_top4_pads_fewer_than_four(n):
    rng = np.random.default_rng(n)
    pen = rng.uniform(-0.1, 0.1, (5, n)).astype(np.float32)
    pen[0, 0] = -1e30
    cols = [rng.normal(size=(5, n)).astype(np.float32) for _ in range(2)]
    jp, jc = jnp_._top4_sorted(jnp.asarray(pen), [jnp.asarray(c) for c in cols])
    tp, tc = tnp._top4_sorted(torch.as_tensor(pen), [torch.as_tensor(c) for c in cols])
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_device_state_carries_across(scene):
    """convert.from_jax of the JAX package's device_state, for a world
    holding every shape type and a joint table, equals the port's own
    device_state key for key: the state carries across one to one."""
    from garden_tpu.core.config import PhysicsConfig as JConfig
    from garden_tpu.physics import constraints as jcon
    from garden_tpu.physics import world as jw
    from garden_tpu_torch.convert import from_jax
    from garden_tpu_torch.core.config import PhysicsConfig
    from garden_tpu_torch.physics import constraints as tcon
    from garden_tpu_torch.physics import world as tw
    states = []
    for wmod, cmod, cfg, table in ((jw, jcon, JConfig, scene["jt"]),
                                   (tw, tcon, PhysicsConfig, scene["tt"])):
        w = wmod.PhysicsWorld(cfg(max_bodies=16, grid_dim=8, max_active_contacts=6),
                              shape_table=table)
        for i, (name, idx) in enumerate(scene["ids"].items()):
            static = name in ("plane", "heightfield", "mesh")
            w.add_body(idx, position=(i * 1.1, 1.0, 0.0),
                       motion=wmod.STATIC if static else wmod.DYNAMIC,
                       mass_override=None if static else 3.0)
        cons = cmod.ConstraintTable(4)
        cons.add(cmod.FIXED, 1, 2, anchor_a=(0.1, 0.0, 0.0))
        states.append((w, cons))
    (jwld, jc), (twld, tc) = states
    jstate = jax.device_get(dict(jwld.device_state(), constraints=jc.device_arrays()))
    tstate = dict(twld.device_state("cpu"), constraints=tc.device_arrays("cpu"))
    carried = from_jax(jstate, "cpu")

    def compare(a, b, path):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                compare(a[k], b[k], f"{path}/{k}")
            else:
                assert a[k].dtype == b[k].dtype, f"{path}/{k}"
                assert torch.equal(a[k], b[k]), f"{path}/{k}"
    compare(carried, tstate, "")
