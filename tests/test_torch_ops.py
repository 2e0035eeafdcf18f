"""Parity of the port's screen-space helpers (`garden_tpu_torch.ops`) and
`math3d.orthographic` with the JAX package.

Tolerances: shifted reads and the orthographic matrix are exact (pure
indexing; the same float32 operations); the decimation and the two
upsamples agree to 1e-5 (the reference's window reductions may add their
taps in another order).
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import math3d as jm3
from garden_tpu.ops import blur as jblur
from garden_tpu.ops.shifts import Shifter as JShifter
from garden_tpu_torch.core import math3d as tm3
from garden_tpu_torch.ops import blur as tblur
from garden_tpu_torch.ops.shifts import Shifter, edge_pad

RNG = np.random.default_rng(7)


def _close(j, t, tol=1e-5):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(13, 17, 3), (13, 17), (9, 6)])
def test_shifter_matches_reference(shape):
    """Mirror of test_shifter_matches_naive_edge_pad, against the JAX
    Shifter, for images with and without a channel axis."""
    img = RNG.random(shape).astype(np.float32)
    jat, tat = JShifter(jnp.asarray(img), 4, 6), Shifter(torch.from_numpy(img), 4, 6)
    for dy, dx in [(0, 0), (3, -6), (-4, 2), (4, 6), (-4, -6), (1, 0)]:
        np.testing.assert_array_equal(np.asarray(jat(dy, dx)), tat(dy, dx).numpy())
    with pytest.raises(AssertionError):
        tat(5, 0)


def test_edge_pad_takes_bool_images():
    vis = torch.from_numpy(RNG.random((5, 7)) > 0.5)
    p = edge_pad(vis, (2, 1), (0, 3))
    assert p.dtype == torch.bool and p.shape == (8, 10)
    assert torch.equal(p[0], vis[0].index_select(0, torch.tensor(
        [0, 1, 2, 3, 4, 5, 6, 6, 6, 6])))


@pytest.mark.parametrize("shape", [(12, 16, 3), (13, 17, 3), (9, 11)],
                         ids=["even", "odd", "plane"])
def test_decimate2x_matches(shape):
    """Odd last rows and columns are dropped, as the reference's VALID
    window over shape & ~1 does."""
    img = RNG.random(shape).astype(np.float32)
    j = jblur.decimate2x(jnp.asarray(img))
    t = tblur.decimate2x(torch.from_numpy(img))
    assert tuple(t.shape) == j.shape
    _close(j, t)


@pytest.mark.parametrize("lo,target", [((7, 9, 3), (13, 17)), ((6, 8, 3), (12, 16)),
                                       ((6, 8), (14, 18))])
def test_upsample2x_to_matches(lo, target):
    x = RNG.random(lo).astype(np.float32)
    _close(jblur.upsample2x_to(jnp.asarray(x), *target),
           tblur.upsample2x_to(torch.from_numpy(x), *target))


@pytest.mark.parametrize("chan", [None, 1, 3])
def test_bilateral_upsample_to_matches(chan):
    """The six taps in the listed order, eps 1e-3 and the max(|guide|, 1)
    scale; guides with depth edges and values below 1."""
    shape = (9, 13) + ((chan,) if chan else ())
    x = RNG.random(shape).astype(np.float32)
    g_lo = RNG.uniform(0.2, 40.0, (9, 13)).astype(np.float32)
    g_full = RNG.uniform(0.2, 40.0, (17, 25)).astype(np.float32)
    _close(jblur.bilateral_upsample_to(jnp.asarray(x), jnp.asarray(g_lo),
                                       jnp.asarray(g_full), 17, 25),
           tblur.bilateral_upsample_to(torch.from_numpy(x), torch.from_numpy(g_lo),
                                       torch.from_numpy(g_full), 17, 25))


def test_orthographic_matches():
    for rz in (True, False):
        j = jm3.orthographic(jnp.float32(-3.5), jnp.float32(7.25), jnp.float32(-2.0),
                             jnp.float32(4.5), jnp.float32(-120.0), jnp.float32(30.0),
                             reverse_z=rz)
        t = tm3.orthographic(*[torch.tensor(v) for v in
                               (-3.5, 7.25, -2.0, 4.5, -120.0, 30.0)], reverse_z=rz)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
