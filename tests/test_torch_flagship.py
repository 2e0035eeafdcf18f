"""The flagship combined step: `entry.build` with every flagship pass on
(cascaded shadows, half-res HBAO, the atmosphere, bloom, auto exposure,
FXAA) against `__graft_entry__._build` under the same config, at 32 bodies
and 256x128, on the split shadow path (the flagship ShadowConfig with
cascades cut to 256/128/128 and 24 active tiles) and on the dense one
(ShadowConfig() defaults with cascades cut to 256/128/128). The JAX step
runs jitted, its Pallas kernels in interpret mode.

Tolerances: tri_id on >= 99.9% of pixels (measured 100%); the uint8 image
within 2 levels on >= 99.5% (bf16 post chain, FMA contraction in the
jitted reference and FXAA's discrete edge decisions move single pixels;
measured 99.96% split, 99.93% dense); the shadow factor within 1e-4 and
the AO within 1e-5 on >= 99.5% of pixels, since one atlas ulp can flip a
texel at a silhouette (measured: every pixel, max |d| 8.6e-6 and 1.1e-6);
bodies to 1e-5; the adapted luminance
to rtol 5e-2 (measured 1.8% split, 0.8% dense): the exposure histogram
reads the bloomed bf16 HDR, a one-ulp bf16 difference moves a sample to
the next bin, and the trimmed mean counts or drops whole bins at its band
edges.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import inspect

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from garden_tpu.core.config import ShadowConfig as JShadowConfig
from garden_tpu_torch import entry
from garden_tpu_torch.convert import from_jax
from garden_tpu_torch.core.config import ShadowConfig
from garden_tpu_torch.render import raster

SIZE = dict(n_bodies=32, width=256, height=128, grid_dim=8)
SHADOWS = {
    "split": dict(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
                  atlas_foot_y=2, max_active_tiles=24),
    "dense": dict(cascade_sizes=(256, 128, 128)),
}


def _reference(shadow_kw):
    """One jitted reference step that also returns the frame's shadow, AO
    and tri_id: the renderer's output dict is captured while the step is
    traced (one compile)."""
    jstep, jstate = graft._build(**SIZE, cfg_overrides={"shadow": JShadowConfig(**shadow_kw)})
    renderer = inspect.getclosurevars(jstep).nonlocals["renderer"]
    seen = {}
    render = renderer.render

    def spy(*args, **kw):
        out = render(*args, **kw)
        seen.update(out)
        return out
    renderer.render = spy

    def step(state):
        nxt, img = jstep(state)
        return nxt, img, {k: seen[k] for k in ("shadow", "ao", "tri_id")}
    return jax.device_get(jax.jit(step)(jstate))


@pytest.fixture(scope="module", params=sorted(SHADOWS))
def both(request):
    kw = SHADOWS[request.param]
    jnext, jimg, jout = _reference(kw)
    tstep, tstate = entry.build(**SIZE, cfg_overrides={"shadow": ShadowConfig(**kw)},
                                device="cpu")
    seen = {}
    render = tstep.renderer.render

    def spy(*args, **k):
        out = render(*args, **k)
        seen.update(out)
        return out
    tstep.renderer.render = spy
    counts = (raster.depth_super.launches, raster.depth_grid.launches,
              raster.depth_dense.launches)
    tnext, timg = tstep(tstate)
    assert counts == (raster.depth_super.launches, raster.depth_grid.launches,
                      raster.depth_dense.launches)   # CPU: plain versions
    return request.param, (jnext, jimg, jout), (tnext, timg, seen)


def test_flagship_step_matches_reference(both):
    name, (jnext, jimg, jout), (tnext, timg, tout) = both
    assert timg.shape == (128, 256, 3) and timg.dtype == torch.uint8
    for k in ("pos", "quat"):
        np.testing.assert_allclose(jnext["physics"]["bodies"][k],
                                   tnext["physics"]["bodies"][k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert (jout["tri_id"] == tout["tri_id"].numpy()).mean() >= 0.999
    d = np.abs(jimg.astype(int) - timg.numpy().astype(int)).max(-1)
    assert (d <= 2).mean() >= 0.995
    np.testing.assert_allclose(jnext["frame"]["avg_luminance"],
                               tnext["frame"]["avg_luminance"].numpy(), rtol=5e-2)
    # the flagship's frame state is the exposure alone: from_jax carries it
    assert set(jnext["frame"]) == set(tnext["frame"]) == {"avg_luminance"}
    conv = from_jax(jnext["frame"], "cpu")
    assert conv["avg_luminance"].dtype == tnext["frame"]["avg_luminance"].dtype


def test_flagship_shadow_and_ao_match_reference(both):
    name, (_, _, jout), (_, _, tout) = both
    ts, ta = tout["shadow"].numpy(), tout["ao"].numpy()
    assert ts.shape == jout["shadow"].shape == (128, 256, 1)
    assert (np.abs(jout["shadow"] - ts) <= 1e-4).mean() >= 0.995
    assert (np.abs(jout["ao"] - ta) <= 1e-5).mean() >= 0.995
    vis = tout["gbuffer"]["visible"].numpy()
    # a real frame: some visible pixels in shadow, some lit, some occluded
    assert 0.0 < ts[vis].mean() < 1.0 and ts[vis].min() < 0.9
    assert ts[vis].max() == 1.0
    assert ta.min() < 0.99
