"""Parity of the port's UI, image-based lighting, cubemap and atmosphere-LUT
modules with `garden_tpu`: the sprite atlas, batch and nine-slice panels,
`composite_sprites`; `FontAtlas` (PIL glyphs, advances, bearings,
kerning), `measure`, `line_height`, `draw`; `ibl.prefilter_latlong` (with
`jax.image.resize`'s linear downsample), `sample_prefiltered`,
`latlong_sh`, `sky_prefiltered`; `ops.cubemap.equi_to_cube`,
`sample_cubemap`; `atmosphere.transmittance_lut`, `multi_scatter_lut`.

Tolerances: host-built atlases, sprite arrays, glyph tables and advances
are equal; `composite_sprites` within 1e-6, and its loop over the pushed
count equal in every bit to the loop over the capacity; the IBL and
cubemap functions to rtol 1e-5; the LUTs to rtol 2e-4 (the sky's bar:
float32 exponentials of optical depths ~10 summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.ops import cubemap as jcube
from garden_tpu.render import atmosphere as jatm
from garden_tpu.render import ibl as jibl
from garden_tpu.render import sprites as jsp
from garden_tpu.render import text as jtext
from garden_tpu_torch.ops import cubemap as tcube
from garden_tpu_torch.render import atmosphere as tatm
from garden_tpu_torch.render import ibl as tibl
from garden_tpu_torch.render import sprites as tsp
from garden_tpu_torch.render import text as ttext

RNG = np.random.default_rng(9)
ICON = RNG.uniform(0, 1, (20, 24, 4)).astype(np.float32)
PANEL = RNG.uniform(0, 1, (30, 30, 3)).astype(np.float32)
ENV = (RNG.uniform(0.0, 3.0, (16, 32, 3)) * np.linspace(1, 2, 32)[None, :, None]
       ).astype(np.float32)


def _close(j, t, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=rtol, atol=atol)


def _batch(mod, capacity=32):
    """An atlas with an icon and a panel; a batch of two nine-slice panels
    and four sprites (one off the frame, one fractional)."""
    atlas = mod.TextureAtlas(64)
    icon, panel = atlas.add(ICON), atlas.add(PANEL)
    b = mod.SpriteBatch(atlas, capacity)
    b.push_nine_slice(3, 2, 40, 30, panel, 6.0, color=(1, 1, 1, 0.8))
    b.push_nine_slice(50, 20, 30, 22, panel, 4.5)
    b.push(mod.Sprite(10, 8, 24, 20, icon, (0.9, 0.5, 0.3, 0.7)))
    b.push(mod.Sprite(60.5, 3.25, 17.5, 9.75, icon))
    b.push(mod.Sprite(-5, -3, 12, 12, atlas.white, (0.2, 0.9, 0.4, 0.5)))
    b.push(mod.Sprite(90, 50, 10, 10, icon))
    return atlas, b


def test_atlas_and_batch_match():
    (ja, jb), (ta, tb) = _batch(jsp), _batch(tsp)
    np.testing.assert_array_equal(ja.data, ta.data)
    jd, td = jb.device_arrays(), tb.device_arrays("cpu")
    for k in jd:
        np.testing.assert_array_equal(np.asarray(jd[k]), np.asarray(td[k]), err_msg=k)
    assert tb.count == 22
    small = tsp.SpriteBatch(ta, 3)
    for _ in range(5):
        small.push(tsp.Sprite(0, 0, 1, 1, ta.white))
    assert small.count == 3                              # over capacity: dropped


def test_composite_sprites_matches():
    (ja, jb), (ta, tb) = _batch(jsp), _batch(tsp)
    img = RNG.uniform(0, 1, (48, 96, 3)).astype(np.float32)
    j = jax.jit(jsp.composite_sprites)(jnp.asarray(img), ja.device(), jb.device_arrays())
    t = tsp.composite_sprites(torch.from_numpy(img), ta.device("cpu"),
                              tb.device_arrays("cpu"))
    _close(j, t, rtol=0, atol=1e-6)
    assert (t.numpy() != img).any(-1).mean() > 0.2


def test_composite_over_count_equals_over_capacity():
    """The port loops over the pushed count; the reference's loop over the
    whole capacity blends alpha 0 past it: the same bits."""
    ta, tb = _batch(tsp)
    img = torch.from_numpy(RNG.uniform(0, 1, (48, 96, 3)).astype(np.float32))
    arrays = tb.device_arrays("cpu")
    assert arrays["count"] < tb.capacity
    by_count = tsp.composite_sprites(img, ta.device("cpu"), arrays)
    by_capacity = tsp.composite_sprites(img, ta.device("cpu"),
                                        dict(arrays, count=tb.capacity))
    assert torch.equal(by_count.view(torch.int32), by_capacity.view(torch.int32))


def test_font_atlas_matches():
    """PIL's default font: the packed glyph atlas, each glyph's region,
    advance and bearings, the kerning pairs, measure and draw."""
    ja, ta = jsp.TextureAtlas(512), tsp.TextureAtlas(512)
    jf, tf = jtext.FontAtlas(ja), ttext.FontAtlas(ta)
    np.testing.assert_array_equal(ja.data, ta.data)
    assert jf.glyphs == tf.glyphs and jf.kerning == tf.kerning
    assert (jf.ascent, jf.descent, jf.line_height()) == (tf.ascent, tf.descent,
                                                         tf.line_height())
    text = "Garden TPU: 42 fps! {AV} ~"
    assert jf.measure(text) == tf.measure(text) > 0
    jb, tb = jsp.SpriteBatch(ja, 64), tsp.SpriteBatch(ta, 64)
    jf.draw(jb, text, 4.0, 3.0, scale=1.5)
    tf.draw(tb, text, 4.0, 3.0, scale=1.5)
    for k, v in jb.device_arrays().items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(tb.device_arrays("cpu")[k]))


def test_font_atlas_without_pil_raises(monkeypatch):
    monkeypatch.setattr(ttext, "_HAS_PIL", False)
    with pytest.raises(RuntimeError, match="PIL"):
        ttext.FontAtlas(tsp.TextureAtlas(64))


@pytest.mark.parametrize("shape", [(16, 32, 8, 16), (8, 16, 4, 8), (12, 20, 12, 10),
                                   (10, 8, 4, 8)])
def test_resize_linear_matches_jax(shape):
    h, w, th, tw = shape
    img = RNG.uniform(0, 2, (h, w, 3)).astype(np.float32)
    _close(jax.jit(jax.image.resize, static_argnums=(1, 2))(jnp.asarray(img), (th, tw, 3),
                                                           "linear"),
           tibl.resize_linear(torch.from_numpy(img), th, tw))


# The JAX references of the IBL and cubemap functions run jitted (one
# compile each, cheaper here than an eager compile per op)
@pytest.fixture(scope="module")
def chains():
    return (jax.jit(jibl.prefilter_latlong)(jnp.asarray(ENV)),
            tibl.prefilter_latlong(torch.from_numpy(ENV)))


def test_prefilter_latlong_matches(chains):
    jc, tc = chains
    assert [tuple(m.shape) for m in tc] == [m.shape for m in jc] == \
        [(16, 32, 3), (8, 16, 3), (4, 8, 3), (4, 8, 3), (4, 8, 3)]
    for j, t in zip(jc, tc):
        _close(j, t)


def test_sample_prefiltered_and_sh_match(chains):
    jc, tc = chains
    d = RNG.normal(size=(40, 30, 3)).astype(np.float32)
    r = RNG.uniform(-0.1, 1.1, (40, 30)).astype(np.float32)
    jsample, juv, jsh = jax.jit(lambda c, d, r, e: (
        jibl.sample_prefiltered(c, d, r), jibl._latlong_uv(d), jibl.latlong_sh(e)))(
        jc, jnp.asarray(d), jnp.asarray(r), jnp.asarray(ENV))
    _close(jsample, tibl.sample_prefiltered(tc, torch.from_numpy(d), torch.from_numpy(r)))
    for j, t in zip(juv, tibl._latlong_uv(torch.from_numpy(d))):
        _close(j, t)
    _close(jsh, tibl.latlong_sh(torch.from_numpy(ENV)), atol=1e-5)


def test_sky_prefiltered_matches():
    sun = np.array([0.3, 0.6, -0.4], np.float32)
    jc = jax.jit(lambda s: jibl.sky_prefiltered(s, height=8, mip_count=3))(jnp.asarray(sun))
    tc = tibl.sky_prefiltered(torch.from_numpy(sun), height=8, mip_count=3)
    assert len(jc) == len(tc) == 3
    for j, t in zip(jc, tc):
        _close(j, t)


def test_cubemap_matches():
    jcm = jax.jit(jcube.equi_to_cube, static_argnums=1)(jnp.asarray(ENV), 6)
    tcm = tcube.equi_to_cube(torch.from_numpy(ENV), 6)
    assert tcm.shape == (6, 6, 6, 3)
    _close(jcm, tcm)
    d = RNG.normal(size=(25, 17, 3)).astype(np.float32)
    d[0, :6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    _close(jax.jit(jcube.sample_cubemap)(jcm, jnp.asarray(d)),
           tcube.sample_cubemap(tcm, torch.from_numpy(d)))


def test_atmosphere_luts_match():
    # eager (jitted, XLA's fused multiply-adds move one texel by 3.4e-4)
    _close(jatm.transmittance_lut((16, 32)), tatm.transmittance_lut((16, 32)),
           rtol=2e-4, atol=1e-7)
    # eager too: jitted, the 8-step march over every direction unrolls into
    # a long compile
    j = jatm.multi_scatter_lut(8, dirs=4)
    t = tatm.multi_scatter_lut(8, dirs=4)
    assert t.shape == (8, 8, 3) and torch.isfinite(t).all() and t.max() > 0
    _close(j, t, rtol=2e-4, atol=1e-9)
