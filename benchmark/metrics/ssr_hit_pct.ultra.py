"""ssr_hit_pct.ultra: 100 x the reflection rays whose confidence is above 0
over the rays marched at the trace resolution, the `ssr_rays_hit` and
`ssr_rays` counters of the program's `ssr` spans in the `step` root
steps."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", "ssr", "ssr_rays_hit", "ssr_rays")
