"""cloud_ray_use_pct.sim: 100 x the half-res sky rays above the horizon
(mu > 0.02, the only ones that can meet the cloud layer) over the rays the
march evaluates, the `cloud_rays_up` and `cloud_rays` counters of the
program's `clouds` spans in the `step` root steps."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", "clouds", "cloud_rays_up", "cloud_rays")
