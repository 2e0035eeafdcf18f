"""The whole slice: one combined physics + frame step of the port against
`__graft_entry__._build` under the same pass set, at 32 bodies and
256x128; plus the package's import boundary and the state converter.

Tolerances: tri_id must agree on >= 99.9% of pixels and the uint8 image
within 2 levels on >= 99.5%. The frame runs through bf16 tone mapping and
auto exposure, and XLA contracts some of the reference's products into
FMAs, so single pixels on triangle edges may differ.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from garden_tpu.core import math3d as jm3
from garden_tpu_torch import entry
from garden_tpu_torch.convert import from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(n_bodies=32, width=256, height=128, grid_dim=8)


@pytest.fixture(scope="module")
def both():
    jstep, jstate = graft._build(**SIZE, cfg_overrides=dict(entry.SLICE_OVERRIDES))
    tstep, tstate = entry.build(**SIZE, cfg_overrides=entry.SLICE_OVERRIDES,
                                device="cpu")
    return jstep, jstate, tstep, tstate


def test_build_matches_reference_state(both):
    jstep, jstate, tstep, tstate = both
    conv = from_jax(jax.device_get(jstate), "cpu")
    for k, v in tstate["physics"]["bodies"].items():
        assert torch.equal(v, conv["physics"]["bodies"][k]), k
    assert torch.equal(tstate["frame"]["avg_luminance"],
                       conv["frame"]["avg_luminance"])
    env = inspect.getclosurevars(jstep).nonlocals
    jscene = jax.device_get(env["dev_scene"])
    for k, v in tstep.scene.items():
        np.testing.assert_array_equal(jscene[k], v.numpy(), err_msg=k)
    for k, v in tstep.constants.items():
        np.testing.assert_allclose(np.asarray(env["constants"][k]), v.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_one_combined_step_matches_reference(both):
    jstep, jstate, tstep, tstate = both
    jnext, jimg = jax.jit(jstep)(jstate)
    tnext, timg = tstep(tstate)
    assert timg.shape == (128, 256, 3) and timg.dtype == torch.uint8
    for k in ("pos", "quat"):
        np.testing.assert_allclose(np.asarray(jnext["physics"]["bodies"][k]),
                                   tnext["physics"]["bodies"][k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    d = np.abs(np.asarray(jimg).astype(int) - timg.numpy().astype(int)).max(-1)
    assert (d <= 2).mean() >= 0.995
    np.testing.assert_allclose(np.asarray(jnext["frame"]["avg_luminance"]),
                               tnext["frame"]["avg_luminance"].numpy(), rtol=1e-3)

    # tri_id of the same frame, from the reference renderer in the step
    env = inspect.getclosurevars(jstep).nonlocals
    n = env["n_dyn"] + 1

    def render(phys, frame):
        b = phys["bodies"]
        mats = jm3.compose_trs(b["pos"][:n], b["quat"][:n], jnp.ones((n, 3)))
        mats = mats.at[0].set(jnp.eye(4))
        return env["renderer"].render(env["dev_scene"], mats, env["constants"],
                                      frame)["tri_id"]
    jtri = np.asarray(jax.jit(render)(jnext["physics"], jstate["frame"]))
    ttri = tstep.render(tstep.instance_matrices(tnext["physics"]),
                        tstate["frame"])["tri_id"].numpy()
    assert (jtri == ttri).mean() >= 0.999
    assert (ttri >= 0).mean() > 0.2


def test_import_needs_no_jax():
    """The port imports without JAX (the machine with the card has none)."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['garden_tpu'] = None; "
            "import garden_tpu_torch.entry, garden_tpu_torch.convert, "
            "garden_tpu_torch.cuda_build; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_from_jax_converts_dtypes():
    tree = {"a": np.arange(3, dtype=np.int32), "b": {"c": np.float32(0.5)},
            "d": np.ones((2, 2), bool),
            "e": np.asarray(jnp.ones(3, jnp.bfloat16))}
    out = from_jax(tree, "cpu")
    assert out["a"].dtype == torch.int32 and out["a"].tolist() == [0, 1, 2]
    assert out["b"]["c"].shape == () and float(out["b"]["c"]) == 0.5
    assert out["d"].dtype == torch.bool
    assert out["e"].dtype == torch.bfloat16


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero, printing no result, without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
