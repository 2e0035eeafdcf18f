"""The port's config mirror must equal the JAX package's dataclasses."""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import dataclasses

import pytest

from garden_tpu.core import config as jcfg
from garden_tpu_torch.core import config as tcfg

CLASSES = ["PhysicsConfig", "ShadowConfig", "SSRConfig", "RenderConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tc)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    j_default = dataclasses.asdict(jc())
    t_default = dataclasses.asdict(tc())
    assert j_default == t_default


@pytest.mark.parametrize("preset", sorted(jcfg.QUALITY_PRESETS))
def test_quality_presets_match(preset):
    j = dataclasses.asdict(jcfg.render_quality(preset))
    t = dataclasses.asdict(tcfg.render_quality(preset))
    assert j == t


def test_validation_matches():
    for kw in (dict(resolve_step=3), dict(cascade_sizes=(1024, 2048, 512))):
        with pytest.raises(ValueError):
            jcfg.ShadowConfig(**kw)
        with pytest.raises(ValueError):
            tcfg.ShadowConfig(**kw)


def test_slice_overrides_are_the_potato_switches():
    potato = jcfg.QUALITY_PRESETS["potato"]
    assert set(tcfg.SLICE_OVERRIDES) == {
        "use_shadows", "use_hbao", "use_bloom", "use_atmosphere", "use_fxaa"}
    for k, v in tcfg.SLICE_OVERRIDES.items():
        assert v is False and potato[k] is False
