"""The golden-trajectory layer (tests/golden) on the port's physics.

The seven canonical scenes, rebuilt from the port (`garden_tpu_torch.
physics.golden`), run on the CPU and must:

1. pass the analytic budgets of `tests/golden/test_golden.py` unchanged:
   five of its tests run as they are on the port's curves, committed-curve
   comparison at GOLDEN_ATOL included; the friction bracket runs through
   `golden.check`, the port's copy of the same budgets, and ramp_hold's
   curve against its committed one, because the committed-curve half does
   not hold for ramp_slide (below);
2. match JAX's `tests.golden.scenes.simulate` over the whole curve. Measured
   on this package's CPU runs: at most 4e-6 in every scene but ramp_slide
   (TOL_CURVE = 1e-5). ramp_slide's box starts 1 mm above the ramp, exactly
   on a 1 mm bucket boundary of the top-4 depth ranking: XLA's fused
   multiply-adds put the bottom corners' depth at -0.99999644e-3 and the
   port's separate ops at -1.0000002e-3, so the two keep the same four
   corners in another order from the second step on, and the sliding box
   drifts to 0.0375 m apart in slip by the end (TOL_RAMP_SLIDE = 0.05,
   the first step within TOL_CURVE). The same scene with the box lifted
   or lowered by 3 um, off the bucket edge, agrees with JAX within
   TOL_CURVE (measured 1.0e-6), which is the check of that cause.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import numpy as np
import pytest
import torch

from garden_tpu_torch.physics import golden

TOL_CURVE = 1e-5
TOL_RAMP_SLIDE = 0.05


@pytest.fixture(scope="module")
def port_curves():
    return {name: golden.simulate(name, "cpu") for name in golden.SCENES}


@pytest.mark.parametrize("test", ["test_sphere_drop", "test_bounce_apex_sequence",
                                  "test_stack5_settle", "test_cradle_velocity_exchange",
                                  "test_pendulum"])
def test_golden_layer_holds_on_port(port_curves, test):
    from tests.golden import test_golden
    getattr(test_golden, test)(port_curves)


@pytest.mark.parametrize("name", list(golden.SCENES))
def test_analytic_budgets_hold_on_port(port_curves, name):
    golden.check(name, port_curves[name])


@pytest.mark.parametrize("name", list(golden.SCENES))
def test_curves_match_jax(port_curves, name):
    from tests.golden import scenes
    ref = scenes.simulate(name)
    got = port_curves[name]
    assert set(ref) == set(got)
    tol = TOL_RAMP_SLIDE if name == "ramp_slide" else TOL_CURVE
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol, err_msg=k)
        np.testing.assert_allclose(got[k][0], ref[k][0], rtol=0, atol=TOL_CURVE, err_msg=k)


def test_ramp_hold_matches_committed_curve(port_curves):
    """ramp_hold's half of `test_friction_cone_bracket`'s committed-curve
    comparison, at GOLDEN_ATOL."""
    from tests.golden import test_golden
    test_golden._compare("ramp_hold", port_curves["ramp_hold"])


@pytest.mark.parametrize("lift", [3e-6, -3e-6], ids=["up", "down"])
def test_ramp_slide_off_the_bucket_edge_matches_jax(lift):
    """ramp_slide with its box moved `lift` m along the ramp's normal, off
    the 1 mm bucket edge of its start: the port's curves equal JAX's within
    TOL_CURVE over the whole run."""
    import jax
    from garden_tpu.physics import world as jw
    from garden_tpu_torch.physics import world as tw
    from tests.golden import scenes
    th = np.deg2rad(27.57)
    d = np.array([-np.sin(th), np.cos(th), 0.0], np.float32) * np.float32(lift)
    js, jcfg, types, jtrack = scenes.SCENES["ramp_slide"][0]()
    js = dict(js, bodies=dict(js["bodies"], pos=js["bodies"]["pos"].at[1].add(d)))
    ts, tcfg, ttypes, ttrack = golden.SCENES["ramp_slide"][0]("cpu")
    ts["bodies"]["pos"][1] += torch.from_numpy(d)
    h = 1.0 / 60.0
    jstep = jax.jit(lambda s: jw.step(s, jcfg, h, types))
    ref = {k: [] for k in jtrack}
    got = {k: [] for k in ttrack}
    for _ in range(golden.SCENES["ramp_slide"][1]):
        js, ts = jstep(js), tw.step(ts, tcfg, h, ttypes)
        for k in ref:
            ref[k].append(jtrack[k](js))
            got[k].append(float(ttrack[k](ts)))
    for k in ref:
        np.testing.assert_allclose(np.float32(got[k]), np.float32(ref[k]), rtol=0,
                                   atol=TOL_CURVE, err_msg=k)
