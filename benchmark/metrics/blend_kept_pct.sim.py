"""blend_kept_pct.sim: 100 x the list slots that the exact cull of K5, K6
and K7 keeps over the slots those kernels test on their cull grids, the
`blend_slots_kept` and `blend_slots` counters of every span of the `step`
root steps (the `refraction`, `sorted` and `oit` passes, and the
translucent shadow map's tint in `csm_render`), with both by span."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", None, "blend_slots_kept", "blend_slots")
