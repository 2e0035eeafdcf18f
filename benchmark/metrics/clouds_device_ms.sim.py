"""clouds_device_ms.sim: device ms a traced step of the kernels and copies
launched inside the program's `clouds` span (the cloud march over the
half-res sky rays, `render.clouds.render_clouds`) and its `cloud_shadow`
span (the clouds' sun transmittance at half-res ground points)."""

from benchmark import trace


def read(run):
    return trace.stage_device_ms(run, ["clouds", "cloud_shadow"])
