"""The port's multi-device path on the CPU: `WorldBatch` sharded over
device lists and over the ranks of a gloo process group, `CombinedStep.to`
and `entry.dryrun_multichip`.

Tolerances: shards over ["cpu"] * k against JAX's WorldBatch over the
conftest's 8 CPU devices at the bars of test_torch_worlds.py's
test_world_batch_matches_jax (integers exact, floats 1e-5 absolute), and
in every bit against the port's one-device batch; `reduce` within 1e-6
relative of the one-device result for mean and sum (the shards' sums are
added in another order), exactly for max and min; the dryrun's images in
every bit against the single tiny step, and against one jitted step of the
reference's dryrun configuration at test_torch_flagship.py's bars (bodies
1e-5, the image within 2 levels on >= 99.5% of pixels, the luminance
rtol 5e-2); the two-process run's mean within 1e-6 of the one-process
reduce (checked by each worker) and of JAX's WorldBatch reduce of the
same 4 worlds.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import os
import re
import socket
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from garden_tpu.core.config import PhysicsConfig as JPhysicsConfig
from garden_tpu.core.config import ShadowConfig as JShadowConfig
from garden_tpu.parallel.worlds import WorldBatch as JWorldBatch
from garden_tpu.physics import world as jpw
from garden_tpu_torch import entry
from garden_tpu_torch.parallel.worlds import WorldBatch
from torch_world_cases import jax_batch, leaves, lift, port_world

N_WORLDS, STEPS = 8, 30


def run(wb, state, steps=STEPS, vary_fn=lift):
    """wb's replicated worlds stepped `steps` times; vmap's per-world
    fallback is an error."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        batched = wb.replicate(state, vary_fn=vary_fn)
        for _ in range(steps):
            batched = wb.step(batched)
    return batched


def joined(shards):
    """The shards' leaves joined along the world axis -> {key path: tensor}."""
    per = [dict(leaves(s)) for s in shards]
    return {k: torch.cat([p[k] for p in per]) for k in per[0]}


def same_bits(a, b) -> bool:
    if a.is_floating_point():
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_worlds():
    """JAX's WorldBatch over the 8 CPU devices, 30 steps (built once)."""
    return dict(leaves(jax_batch(N_WORLDS, STEPS)))


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device batch, 30 steps."""
    state, step = port_world()
    wb = WorldBatch(step, N_WORLDS, devices=["cpu"])
    return joined(run(wb, state))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_world_batch_over_cpu_shards(jax_worlds, one_device, k):
    state, step = port_world()
    wb = WorldBatch(step, N_WORLDS, devices=["cpu"] * k)
    shards = run(wb, state)
    assert len(shards) == k and wb.per == N_WORLDS // k
    got = joined(shards)
    assert set(got) == set(jax_worlds) == set(one_device)
    for key, leaf in got.items():
        ref = np.asarray(jax_worlds[key])
        assert tuple(leaf.shape) == ref.shape, key
        if ref.dtype == np.bool_ or np.issubdtype(ref.dtype, np.integer):
            np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=key)
        else:
            np.testing.assert_allclose(leaf.numpy(), ref, rtol=0, atol=1e-5, err_msg=key)
        assert leaf.dtype == one_device[key].dtype and same_bits(leaf, one_device[key]), key


@pytest.mark.parametrize("n_worlds,n_devices,kept", [(6, 4, 3), (8, 3, 2), (5, 4, 1)])
def test_devices_shrink_to_a_divisor(n_worlds, n_devices, kept):
    """The device list loses devices from its end until it divides the
    worlds, as the reference's does; a list of steps loses the same."""
    ref = JWorldBatch(lambda s: s, n_worlds, devices=jax.devices()[:n_devices])
    assert ref.mesh.devices.size == kept
    state, step = port_world()
    wb = WorldBatch(step, n_worlds, devices=["cpu"] * n_devices)
    assert len(wb.devices) == kept and wb.per == n_worlds // kept
    seen = []
    steps = [lambda s, k=k: (seen.append(k), s)[1] for k in range(n_devices)]
    wb = WorldBatch(steps, n_worlds, devices=["cpu"] * n_devices)
    wb.step(wb.replicate(state))
    assert seen == list(range(kept))


def test_no_card_and_mismatched_steps_raise():
    state, step = port_world()
    if torch.cuda.is_available():
        pytest.skip("a card is visible: devices=None takes it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        WorldBatch(step, 4)
    with pytest.raises(ValueError, match="3 step functions for 2 devices"):
        WorldBatch([step] * 3, 4, devices=["cpu"] * 2)


@pytest.mark.parametrize("reducer", ["mean", "sum", "max", "min"])
def test_reduce_over_shards(reducer):
    state, step = port_world()
    fn = lambda s: s["bodies"]["pos"][1]                    # a (3,) leaf
    out = {}
    for k in (1, 4):
        wb = WorldBatch(step, N_WORLDS, devices=["cpu"] * k)
        out[k] = wb.reduce(run(wb, state, steps=5), fn, reducer)
    assert out[4].shape == (3,)
    if reducer in ("max", "min"):
        assert torch.equal(out[4], out[1])
    else:
        torch.testing.assert_close(out[4], out[1], rtol=1e-6, atol=0)
    nest = WorldBatch(step, N_WORLDS, devices=["cpu"] * 4)
    both = nest.reduce(nest.replicate(state, vary_fn=lift),
                       lambda s: {"y": s["bodies"]["pos"][1, 1], "n": s["bodies"]["pos"][1]},
                       reducer)
    assert set(both) == {"y", "n"} and both["n"].shape == (3,)


def test_stack_and_world_across_shards():
    """stack puts world i on shard i // per, world(i) reads it back; stacking
    the lifted worlds equals replicating with the lift."""
    state, step = port_world()
    states = [lift(state, torch.tensor(i, dtype=torch.int32)) for i in range(N_WORLDS)]
    wb = WorldBatch(step, N_WORLDS, devices=["cpu"] * 4)
    shards = wb.stack(states)
    assert len(shards) == 4
    rep = joined(wb.replicate(state, vary_fn=lift))
    for key, leaf in joined(shards).items():
        assert same_bits(leaf, rep[key]), key
    for i in range(N_WORLDS):
        w = wb.world(shards, i)
        assert isinstance(w["bodies"]["pos"], np.ndarray)
        for key, leaf in leaves(states[i]):
            np.testing.assert_array_equal(dict(leaves(w))[key], leaf.numpy(), err_msg=key)
    with pytest.raises(ValueError, match="7 states for 8 worlds"):
        wb.stack(states[:7])
    with pytest.raises(IndexError):
        wb.world(shards, N_WORLDS)


def test_step_as_a_list_per_device(one_device):
    """One step callable per device: each runs on its own shard, and the
    batch equals the one-device batch in every bit."""
    state, step = port_world()
    seen = []

    def on(k):
        def fn(s):
            seen.append((k, tuple(s["bodies"]["pos"].shape)))
            return step(s)
        return fn

    wb = WorldBatch([on(k) for k in range(4)], N_WORLDS, devices=["cpu"] * 4)
    got = joined(run(wb, state))
    # vmap traces each shard's callable once a step, on one world's shapes
    assert seen == [(k, (16, 3)) for _ in range(STEPS) for k in range(4)]
    for key, leaf in got.items():
        assert same_bits(leaf, one_device[key]), key


@pytest.fixture(scope="module")
def dryrun():
    """dryrun_multichip over two CPU 'devices' -> (states, images)."""
    return entry.dryrun_multichip(2, devices=["cpu"] * 2)


def test_dryrun_multichip_on_cpu(dryrun):
    """dryrun_multichip over two CPU 'devices': images (2, 32, 64, 3), each
    the single tiny combined step's in every bit, as are the states."""
    states, images = dryrun
    assert tuple(images.shape) == (2, 32, 64, 3) and images.dtype == torch.uint8
    step, state = entry.build(**entry.DRYRUN_SIZE, cfg_overrides=entry.DRYRUN_OVERRIDES,
                              device="cpu")
    one, image = step(state)
    assert len(states) == 2
    for i in range(2):
        assert torch.equal(images[i], image)
        ref = dict(leaves(one))
        for key, leaf in leaves(states[i]):
            assert leaf.shape[0] == 1 and same_bits(leaf[0], ref[key]), key
    with pytest.raises(ValueError):
        entry.dryrun_multichip(3, devices=["cpu"] * 2)


def test_dryrun_multichip_matches_jax(dryrun):
    """Each dryrun instance against one jitted step of the reference's
    dryrun configuration (`__graft_entry__._build` at DRYRUN_SIZE with its
    ShadowConfig(map_size=128, resolve_step=1) and clouds off), at
    test_torch_flagship.py's bars: bodies to 1e-5, the image within 2
    levels on >= 99.5% of pixels, the adapted luminance to rtol 5e-2.

    The reference is compiled with xla_allow_excess_precision off, so its
    bf16 post chain rounds each value as its program says (as eager JAX
    and the port do): with XLA's default, the jitted reference differs
    from the eager one by more than 2 levels on 7 of the 2048 pixels (up
    to 18, FXAA edge decisions), and from the port on 12 (99.41%); with
    it off, on 3 (99.85%). Eager takes ~80 s here, jit ~18 s."""
    jstep, jstate = graft._build(**entry.DRYRUN_SIZE, cfg_overrides={
        "shadow": JShadowConfig(map_size=128, resolve_step=1), "use_clouds": False})
    compiled = jax.jit(jstep).lower(jstate).compile({"xla_allow_excess_precision": False})
    jnext, jimg = jax.device_get(compiled(jstate))
    states, images = dryrun
    for i in range(2):
        assert images[i].shape == jimg.shape
        for k in ("pos", "quat"):
            np.testing.assert_allclose(states[i]["physics"]["bodies"][k][0].numpy(),
                                       jnext["physics"]["bodies"][k], rtol=0, atol=1e-5,
                                       err_msg=k)
        d = np.abs(jimg.astype(int) - images[i].numpy().astype(int)).max(-1)
        assert (d <= 2).mean() >= 0.995
        np.testing.assert_allclose(states[i]["frame"]["avg_luminance"][0].numpy(),
                                   jnext["frame"]["avg_luminance"], rtol=5e-2)


def test_combined_step_to_gets_its_own_renderer():
    step, state = entry.build(**entry.DRYRUN_SIZE, cfg_overrides=entry.DRYRUN_OVERRIDES,
                              device="cpu")
    step.environment = torch.rand(8, 16, 3)
    step.ui_sprites = {"count": 2, "rect": torch.rand(2, 4)}
    moved = step.to("cpu")
    assert moved.renderer is not step.renderer and moved.renderer.device == torch.device("cpu")
    assert moved.pcfg is step.pcfg and moved.n_instances == step.n_instances
    assert torch.equal(moved.environment, step.environment) and moved.ui_atlas is None
    assert moved.ui_sprites["count"] == 2
    assert torch.equal(moved.ui_sprites["rect"], step.ui_sprites["rect"])
    moved.environment = moved.ui_sprites = step.environment = step.ui_sprites = None
    _, a = step(state)
    _, b = moved(state)
    assert torch.equal(a, b)


def test_two_processes_over_gloo():
    """tests/torch_multihost_worker.py in two processes: 4 worlds, 2 a rank,
    3 steps, one all-reduce; each rank checks its mean against the
    one-process reduce and prints it."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(i), f"tcp://localhost:{port}"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0].decode())
    finally:
        for p in procs:
            p.kill()
    vals = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        m = re.search(rf"proc {i}: OK mean_y=(\S+)", out)
        assert m, out
        vals.append(float(m.group(1)))
    assert vals[0] == vals[1] and 2.5 < vals[0] < 3.0
    assert abs(vals[0] - jax_mean_y()) <= 1e-6


def jax_mean_y() -> float:
    """The worker's reduce on JAX: the same 4 worlds (world i's sphere moved
    0.01 i in x) through JAX's WorldBatch, 3 steps, the mean sphere height."""
    cfg = JPhysicsConfig(max_bodies=16, grid_dim=8, cell_size=2.0)
    w = jpw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=jpw.STATIC)
    w.add_body(w.shapes.sphere(0.5), position=(0.0, 3.0, 0.0))
    types = w.shapes.present_types()
    state = jax.device_get(w.device_state())
    states = []
    for i in range(4):
        pos = np.array(state["bodies"]["pos"])
        pos[1, 0] += np.float32(0.01 * i)
        states.append(dict(state, bodies=dict(state["bodies"], pos=pos)))
    wb = JWorldBatch(lambda s: jpw.step(s, cfg, 1.0 / 60.0, types), 4)
    batched = wb.stack(states)
    for _ in range(3):
        batched = wb.step(batched)
    return float(wb.reduce(batched, lambda s: s["bodies"]["pos"][1, 1]))
